"""The training loop and its CLI, counterpart of `tinyrecurrentunet_tpu/train/loop.py`.

config -> dataset -> model and optimizer (`create_train_state`) -> resume
from a checkpoint (`log.ckpt_iter`) -> train steps -> log every
`iters_per_valid`, checkpoint every `iters_per_ckpt` and at the end.

- A `device_cacheable` dataset (the synthetic one) is uploaded to the device
  once and each batch is gathered there, in the order of the per-epoch
  permutation default_rng((seed, epoch)), as the JAX loop does: both see the
  same batches in the same order. Other datasets go through `DataLoader`.
- TBPTT (`tbptt_segment_sec` > 0): each batch is cut into segments, one
  update each, with the TGRU carry passed across them.

Runs on `cuda` unless asked for `cpu`. On the card every GRU recurrence of
a step goes through the CUDA kernels (3 forward and 3 backward launches).

Usage:
    python -m tinyrecurrentunet_torch.train.loop -c config/synthetic16k.json \
        --synthetic [--max_iters N] [--device cpu]

bf16 training, the procedural and corpus datasets, data parallelism and the
profiler hook are later slices: `--procedural`, `--data_parallel` and
`--profile` raise NotImplementedError, as does a config asking for bf16.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset
from tinyrecurrentunet_torch.data.loader import DataLoader
from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
from tinyrecurrentunet_torch.train.state import check_train_dtype, create_train_state
from tinyrecurrentunet_torch.train.step import current_learning_rate, make_eval_step, make_train_step
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter

_LATER = "a later slice of the port (ROADMAP)"


def epoch_permutation(seed: int, epoch: int, num_items: int) -> np.ndarray:
    """The order of the on-device corpus in one epoch."""
    return np.random.default_rng((seed, epoch)).permutation(num_items)


def train(
    cfg: Config,
    dataset=None,
    max_iters: int | None = None,
    log_dir: str | None = None,
    valid_dataset=None,
    device: str | torch.device = "cuda",
):
    """Run training; returns (state, metrics of the last logged step as floats).

    dataset: an object with __len__ and get(i, rng) -> (clean, noisy, id).
    max_iters: stop early (default cfg.train.optimization.n_iters).
    """
    check_train_dtype(cfg)
    if dataset is None:
        raise NotImplementedError(f"the corpus dataset (CleanNoisyPairDataset) is {_LATER}")
    device = resolve_device(device)
    opt = cfg.train.optimization
    log = cfg.train.log
    n_iters = min(opt.n_iters, max_iters or opt.n_iters)
    batch_size = opt.batch_size_per_device

    state = create_train_state(cfg, device=device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"TRUNet Parameters: {n_params / 1e6:.6f}M", flush=True)

    ckpt = CheckpointManager(log.directory, cfg.train.exp_path)
    state, resume_iter, prev_seconds = ckpt.restore(state, log.ckpt_iter)
    if resume_iter >= 0:
        print(f"resumed from checkpoint at iteration {resume_iter}")
    n_iter = resume_iter + 1

    seg_len = 0
    if opt.tbptt_segment_sec > 0:
        hop = cfg.featurizer.hop_length
        seg_len = max(int(opt.tbptt_segment_sec * cfg.trainset.sample_rate) // hop, 1) * hop
    step_fn = make_train_step(cfg, with_carry=seg_len > 0)

    eval_fn = valid_batch = None
    if valid_dataset is not None:
        eval_fn = make_eval_step(cfg)
        vrng = np.random.default_rng(1234)
        items = [valid_dataset.get(i, vrng) for i in range(min(len(valid_dataset), batch_size))]
        vlen = min(len(c) for c, _, _ in items)
        valid_batch = [
            torch.from_numpy(np.stack([x[k][:vlen] for x in items]).astype(np.float32)).to(device)
            for k in (0, 1)
        ]

    if getattr(dataset, "device_cacheable", False):
        rng = np.random.default_rng(opt.seed)
        items = [dataset.get(i, rng) for i in range(len(dataset))]
        corpus = [torch.from_numpy(np.stack([x[k] for x in items])).to(device) for k in (0, 1)]
        del items
        loader = None
    else:
        loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=opt.seed)

    def epoch_batches(epoch: int):
        if loader is None:
            perm = epoch_permutation(opt.seed, epoch, len(dataset))
            for i in range(0, len(perm) - batch_size + 1, batch_size):
                idx = torch.from_numpy(perm[i : i + batch_size]).to(device)
                yield corpus[0][idx], corpus[1][idx]
        else:
            for clean, noisy, _ in loader:
                yield (torch.from_numpy(clean.astype(np.float32)).to(device),
                       torch.from_numpy(noisy.astype(np.float32)).to(device))

    writer = MetricsWriter(log_dir or f"{log.directory}/{cfg.train.exp_path}/logs")
    time0 = time.time() - prev_seconds
    metrics = {}
    epoch = 0
    while n_iter < n_iters:
        for clean, noisy in epoch_batches(epoch):
            if n_iter >= n_iters:
                break
            if seg_len > 0:
                tgru_h = state.model.init_tgru_state(clean.shape[0], cfg.featurizer.num_freqs, device)
                for s in range(clean.shape[-1] // seg_len):
                    sl = slice(s * seg_len, (s + 1) * seg_len)
                    state, metrics, tgru_h = step_fn(state, clean[:, sl], noisy[:, sl], tgru_h)
            else:
                state, metrics = step_fn(state, clean, noisy)

            if n_iter % log.iters_per_valid == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                lr = current_learning_rate(cfg, n_iter)
                valid_msg = ""
                if eval_fn is not None:
                    metrics["valid_loss"] = float(eval_fn(state, *valid_batch)["loss"])
                    valid_msg = f" \tvalid: {metrics['valid_loss']:.7f}"
                print(
                    f"iteration: {n_iter} \tloss: {metrics['loss']:.7f} "
                    f"\tgrad_norm: {metrics['grad_norm']:.4f} \tlr: {lr:.3e}" + valid_msg,
                    flush=True,
                )
                scalars = {
                    "Train/Train-Loss": metrics["loss"],
                    "Train/Train-Reduced-Loss": metrics["loss"],
                    "Train/Gradient-Norm": metrics["grad_norm"],
                    "Train/learning-rate": lr,
                    **{f"Train/loss-{k}": v for k, v in metrics.items()
                       if k not in ("loss", "grad_norm", "valid_loss")},
                }
                if "valid_loss" in metrics:
                    scalars["Valid/Valid-Loss"] = metrics["valid_loss"]
                writer.scalars(n_iter, scalars)

            if n_iter > 0 and n_iter % log.iters_per_ckpt == 0:
                ckpt.save(n_iter, state, int(time.time() - time0))
                print(f"model at iteration {n_iter} is saved")
            n_iter += 1
        epoch += 1

    if metrics:
        ckpt.save(min(n_iter - 1, n_iters), state, int(time.time() - time0))
    writer.close()
    metrics = {k: float(v) for k, v in metrics.items()}
    return state, metrics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True, help="JSON config path")
    parser.add_argument("--max_iters", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true", help="train on the synthetic dataset")
    parser.add_argument("--synthetic_items", type=int, default=256,
                        help="size of the synthetic training set")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--procedural", action="store_true", help=f"{_LATER}")
    parser.add_argument("--data_parallel", action="store_true", help=f"{_LATER}")
    parser.add_argument("--profile", default=None, metavar="DIR", help=f"{_LATER}")
    args = parser.parse_args(argv)
    for flag in ("procedural", "data_parallel", "profile"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is {_LATER}")

    cfg = load_config(args.config)
    dataset = valid_dataset = None
    if args.synthetic:
        dataset = SyntheticPairDataset(
            num_items=args.synthetic_items,
            length_sec=cfg.trainset.crop_length_sec,
            sample_rate=cfg.trainset.sample_rate,
        )
        valid_dataset = SyntheticPairDataset(
            num_items=16,
            length_sec=cfg.trainset.crop_length_sec,
            sample_rate=cfg.trainset.sample_rate,
            seed=999,
        )
    return train(cfg, dataset=dataset, max_iters=args.max_iters, valid_dataset=valid_dataset,
                 device=args.device)


if __name__ == "__main__":
    main()
