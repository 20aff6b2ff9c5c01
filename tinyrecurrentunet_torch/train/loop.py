"""The training loop and its CLI, counterpart of `tinyrecurrentunet_tpu/train/loop.py`.

config -> process group (`parallel.initialize_distributed`) -> dataset ->
model and optimizer (`create_train_state`) -> resume from a checkpoint
(`log.ckpt_iter`) -> train steps -> log every `iters_per_valid`, checkpoint
every `iters_per_ckpt` and at the end.

- The dataset defaults to the corpus on disk, `CleanNoisyPairDataset(
  cfg.trainset, subset="training")`; the CLI also trains on the synthetic
  set (`--synthetic`) and on the procedural speech corpus (`--procedural`,
  how the shipped flagship was trained), each with a held-out validation set.
- A `device_cacheable` dataset (synthetic, procedural) outside a process
  group is uploaded to the device once (`upload_corpus`; the procedural corpus is
  synthesized first, ~20 ms an item on the host, and the loop logs that
  time) and each batch is gathered there, in the order of the per-epoch
  permutation default_rng((seed, epoch)), as the JAX loop does: both see the
  same batches in the same order. Other datasets, and every dataset under
  data parallelism (a group of one rank included), go through `DataLoader`.
- Data parallelism (`data_parallel`): one process per card, in a process
  group (`parallel/mesh.py`). `--data_parallel` trains over every local card,
  as the JAX package's flag trains over a mesh of every local device: with
  no launcher around it, the CLI starts one rank per card itself
  (`parallel.launch`; the CPU, or one card, is a group of one rank in the
  CLI's own process); under torchrun (`python -m torch.distributed.run`)
  each process is the rank torchrun made; under `cfg.dist` with several
  processes, one a host, each host starts a rank per card. Rank r reads the
  shard `num_shards=W, shard_index=r` at `batch_size_per_device` items, so
  the global batch is W x `batch_size_per_device`, and the step is the
  global batch's (`train/step.py`). Rank 0 alone prints, logs, evaluates the
  whole validation batch and writes checkpoints.
- Every rank ends: after the final checkpoint, or on an exception, train()
  waits for the card, closes the train and eval steps (their CUDA graphs
  hold the collectives; destroying NCCL's group with one alive hung at 4
  ranks), collects them, then destroys the process group if it made it
  (after a barrier, which a failed run skips: a peer may sit in a
  collective it never leaves). A group the caller made is left alone.
- TBPTT (`tbptt_segment_sec` > 0): each batch is cut into segments, one
  update each, with the TGRU carry passed across them.
- `profile_dir`: a torch.profiler trace of steps 10-12 (`utils.profiling.trace`;
  on a card the replays of the step's graph, each kernel named), with the
  program's spans as `trunet.*` ranges on the same clock: each step, its
  copy in, replay and metrics (`train/step.py`).
- The CLI's every rank prints `rank r ended` when train() has returned, on a
  card with the GRU kernels' launch counts of its process
  (`ops.cuda_gru.launch_counts`): what the run launched.

Runs on `cuda` unless asked for `cpu`. On the card every GRU recurrence of
a step goes through the CUDA kernels (3 forward and 3 backward launches),
and each step after the first of a batch shape is one replay of the step's
CUDA graph (`train/step.py`): the device corpus's batches are gathered
straight into the step's static inputs, the loader's are copied in, and the
TBPTT carry is zeroed in the step's own carry buffer at each batch. The
validation batch is made once, in the eval step's static inputs
(`validation_batch`), and a validation pass is one replay of the eval
step's graph and the read of its loss.
The model computes in `optimization.train_compute_dtype` where the config
sets it (bf16 in the shipped configs; `train.state.train_network_config`),
the validation loss too, as in the JAX loop; parameters, optimizer state and
checkpoints stay float32.

Usage:
    python -m tinyrecurrentunet_torch.train.loop -c config/proc16k.json \
        [--procedural [--procedural_items N] | --synthetic] [--max_iters N] \
        [--profile DIR] [--device cpu] [--data_parallel]
    python -m torch.distributed.run --nproc_per_node 4 -m tinyrecurrentunet_torch.train.loop \
        -c config/proc16k.json --procedural --data_parallel
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time

import numpy as np
import torch

from tinyrecurrentunet_torch import parallel
from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.data import CleanNoisyPairDataset, DataLoader, ProceduralSpeechDataset, SyntheticPairDataset
from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
from tinyrecurrentunet_torch.train.state import create_train_state
from tinyrecurrentunet_torch.train.step import current_learning_rate, make_eval_step, make_train_step
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter
from tinyrecurrentunet_torch.utils.params import print_size
from tinyrecurrentunet_torch.utils.profiling import trace

PROFILE_STEPS = (10, 12)  # first and last step of the --profile trace


def epoch_permutation(seed: int, epoch: int, num_items: int) -> np.ndarray:
    """The order of the on-device corpus in one epoch."""
    return np.random.default_rng((seed, epoch)).permutation(num_items)


def upload_corpus(dataset, seed: int, device) -> list[torch.Tensor]:
    """Every item of `dataset` on `device`: [clean (N, L), noisy (N, L)],
    item i from dataset.get(i, rng) with one rng default_rng(seed) drawn in
    index order, as the JAX loop builds its device corpus."""
    rng = np.random.default_rng(seed)
    items = [dataset.get(i, rng) for i in range(len(dataset))]
    return [torch.from_numpy(np.stack([x[k] for x in items])).to(device) for k in (0, 1)]


def validation_batch(eval_fn, state, valid_dataset, n_items: int, world: int = 1) -> tuple:
    """The validation batch, made once in `eval_fn`'s static inputs for
    `state` (`EvalStep.buffers`): the first `n_items` items of
    `valid_dataset` (at most all of them), cut to a multiple of the `world`
    ranks as the JAX loop cuts it for its mesh, drawn with default_rng(1234)
    and cut to the shortest item. Returns (clean, noisy)."""
    vrng = np.random.default_rng(1234)
    n_items = min(len(valid_dataset), n_items)
    n_items = max(n_items - n_items % world, world)
    items = [valid_dataset.get(i, vrng) for i in range(n_items)]
    vlen = min(len(c) for c, _, _ in items)
    slot = eval_fn.buffers(state, (n_items, vlen))
    for buf, k in ((slot.clean, 0), (slot.noisy, 1)):
        buf.copy_(torch.from_numpy(np.stack([x[k][:vlen] for x in items]).astype(np.float32)))
    return slot.clean, slot.noisy


def train(
    cfg: Config,
    dataset=None,
    max_iters: int | None = None,
    log_dir: str | None = None,
    valid_dataset=None,
    device: str | torch.device = "cuda",
    data_parallel: bool = False,
    backend: str | None = None,
    profile_dir: str | None = None,
):
    """Run training; returns (state, metrics of the last logged step as floats).

    dataset: an object with __len__ and get(i, rng) -> (clean, noisy, id);
      default CleanNoisyPairDataset(cfg.trainset, subset="training").
    max_iters: stop early (default cfg.train.optimization.n_iters).
    data_parallel: train over the ranks of the process group a launcher's
      environment (torchrun's, `parallel.launch`'s) or cfg.dist asks for, or
      the caller made, else over a group of one rank in this process;
      several ranks without it raise, and a launcher's group of one without
      it is not joined. A group train() makes, it destroys at its end.
    backend: the process group's, default nccl on a card, gloo on the CPU.
    device: `cuda` is cuda:LOCAL_RANK under a launcher; an explicit index is
      honoured (two ranks on one card need backend gloo).
    """
    device = resolve_device(parallel.local_device(device))
    if device.index is not None:
        torch.cuda.set_device(device)
    backend = backend or parallel.default_backend(device)
    made_group = not parallel.is_distributed()
    world = parallel.initialize_distributed(cfg.dist, backend, data_parallel)
    made_group = made_group and parallel.is_distributed()
    steps = []  # the train and eval steps made, closed at the end
    failed = True
    try:
        if world > 1 and not data_parallel:
            raise ValueError(f"{world} processes train one model only with data_parallel (--data_parallel)")
        result = _train(cfg, dataset, max_iters, log_dir, valid_dataset, device, backend, world, profile_dir, steps)
        failed = False
        return result
    finally:
        _end_run(device, steps, made_group, failed)


def _end_run(device: torch.device, steps: list, made_group: bool, failed: bool):
    """train()'s end on every rank (module docstring): the card's work
    finished, the steps' graphs freed and collected, then a group train()
    made destroyed, after a barrier unless the run failed. After a failure
    only a gloo group is destroyed (NCCL's would wait on a peer's unfinished
    collective); an NCCL group goes with the process."""
    if device.type == "cuda":
        try:
            torch.cuda.synchronize(device)
        except RuntimeError:
            if not failed:
                raise
    for step in steps:
        step.close()
    steps.clear()
    gc.collect()
    if made_group and parallel.is_distributed():
        if not failed:
            parallel.barrier()
        if not failed or torch.distributed.get_backend() == "gloo":
            torch.distributed.destroy_process_group()


def _train(cfg: Config, dataset, max_iters, log_dir, valid_dataset, device, backend, world, profile_dir, steps):
    """train()'s run on this rank; the steps it makes go into `steps`."""
    lead = parallel.rank() == 0
    opt = cfg.train.optimization
    log = cfg.train.log
    n_iters = min(opt.n_iters, max_iters or opt.n_iters)
    batch_size = opt.batch_size_per_device  # per rank; the global batch is W times it

    if dataset is None:
        dataset = CleanNoisyPairDataset(cfg.trainset, subset="training")

    state = create_train_state(cfg, device=device)
    if lead:
        print_size(state.model, "TRUNet")

    ckpt = CheckpointManager(log.directory, cfg.train.exp_path)
    state, resume_iter, prev_seconds = ckpt.restore(state, log.ckpt_iter)
    if resume_iter >= 0 and lead:
        print(f"resumed from checkpoint at iteration {resume_iter}")
    parallel.broadcast_state_(state.model)
    n_iter = resume_iter + 1

    seg_len = 0
    if opt.tbptt_segment_sec > 0:
        hop = cfg.featurizer.hop_length
        seg_len = max(int(opt.tbptt_segment_sec * cfg.trainset.sample_rate) // hop, 1) * hop
    step_fn = make_train_step(cfg, with_carry=seg_len > 0)
    steps.append(step_fn)
    if parallel.is_distributed() and lead:
        print(f"data parallel: {world} ranks over {backend}, {batch_size} clips a rank, "
              f"global batch {batch_size * world}", flush=True)

    # rank 0 evaluates the validation batch of the global batch's size
    eval_fn = valid_batch = None
    if valid_dataset is not None and lead:
        eval_fn = make_eval_step(cfg)
        steps.append(eval_fn)
        valid_batch = validation_batch(eval_fn, state, valid_dataset, batch_size * world, world)

    if getattr(dataset, "device_cacheable", False) and not parallel.is_distributed():
        t0 = time.perf_counter()
        corpus = upload_corpus(dataset, opt.seed, device)
        print(f"device corpus: {len(dataset)} items made and uploaded in {time.perf_counter() - t0:.1f} s, "
              f"{2 * corpus[0].numel() * corpus[0].element_size() / 1e9:.2f} GB on {device}", flush=True)
        loader = None
    else:
        loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=opt.seed,
                            **parallel.loader_shard())

    def epoch_batches(epoch: int):
        if loader is None:
            perm = epoch_permutation(opt.seed, epoch, len(dataset))
            for i in range(0, len(perm) - batch_size + 1, batch_size):
                idx = torch.from_numpy(perm[i : i + batch_size]).to(device)
                if seg_len > 0:
                    yield corpus[0][idx], corpus[1][idx]
                    continue
                # gathered straight into the train step's static inputs
                slot = step_fn.buffers(state, (batch_size, corpus[0].shape[1]), corpus[0].dtype)
                torch.index_select(corpus[0], 0, idx, out=slot.clean)
                torch.index_select(corpus[1], 0, idx, out=slot.noisy)
                yield slot.clean, slot.noisy
        else:
            for clean, noisy, _ in loader:
                yield (torch.from_numpy(clean.astype(np.float32)).to(device),
                       torch.from_numpy(noisy.astype(np.float32)).to(device))

    writer = MetricsWriter(log_dir or f"{log.directory}/{cfg.train.exp_path}/logs") if lead else None
    profiling = contextlib.ExitStack()
    time0 = time.time() - prev_seconds
    metrics = {}
    epoch = 0
    while n_iter < n_iters:
        for clean, noisy in epoch_batches(epoch):
            if n_iter >= n_iters:
                break
            if profile_dir is not None and n_iter == PROFILE_STEPS[0]:
                profiling.enter_context(trace(profile_dir))
            if seg_len > 0:
                tgru_h = step_fn.buffers(state, (clean.shape[0], seg_len), clean.dtype).carry
                tgru_h.zero_()  # the carry of each batch starts from zeros, in the step's own buffer
                for s in range(clean.shape[-1] // seg_len):
                    sl = slice(s * seg_len, (s + 1) * seg_len)
                    state, metrics, tgru_h = step_fn(state, clean[:, sl], noisy[:, sl], tgru_h)
            else:
                state, metrics = step_fn(state, clean, noisy)
            if profile_dir is not None and n_iter == PROFILE_STEPS[1]:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiling.close()
                if lead:
                    print(f"profiler trace written to {profile_dir}", flush=True)

            if n_iter % log.iters_per_valid == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                if lead:
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
                if lead:
                    print(f"model at iteration {n_iter} is saved", flush=True)
            n_iter += 1
        epoch += 1
    profiling.close()

    if metrics:
        ckpt.save(min(n_iter - 1, n_iters), state, int(time.time() - time0))
        if lead:
            print(f"model at iteration {min(n_iter - 1, n_iters)} is saved", flush=True)
    if writer is not None:
        writer.close()
    metrics = {k: float(v) for k, v in metrics.items()}
    return state, metrics


def main(argv=None, local_ranks: int | None = None):
    """The CLI. `local_ranks`: the ranks `--data_parallel` starts on this
    host with no launcher (default `parallel.local_rank_count`'s: one per
    visible card, one on the CPU); N gloo ranks on the CPU are the tests'."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True, help="JSON config path")
    parser.add_argument("--max_iters", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true", help="train on the synthetic dataset")
    parser.add_argument("--synthetic_items", type=int, default=256,
                        help="size of the synthetic training set")
    parser.add_argument("--procedural", action="store_true",
                        help="train on the procedural speech+noise corpus (~20 ms of host synthesis an item)")
    parser.add_argument("--procedural_items", type=int, default=4000,
                        help="size of the procedural training corpus")
    parser.add_argument("--babble_style", default="diverse", choices=("diverse", "eval"),
                        help="training babble crowd: the diversified generator or the testset's recipe")
    parser.add_argument("--kinds", default=None,
                        help="comma-separated degradation kinds overriding the training schedule "
                        "(e.g. 'reverb' for the dereverb-only diagnostic)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="train over every local card, one rank each, at a global batch of ranks x "
                        "batch_size_per_device: ranks started here, or by torchrun, or on each host of cfg.dist")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process group backend (default nccl on a card, gloo on the CPU; "
                        "two ranks on one card need gloo)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of train steps 10-12 into DIR")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; cuda:LOCAL_RANK under a launcher), cuda:<index> or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.data_parallel:
        return parallel.launch(_train_from_args, (cfg, args), cfg.dist, args.device, local_ranks)
    return _train_from_args(cfg, args)


def _train_from_args(cfg: Config, args):
    """train() with the CLI's datasets and options: one rank's run."""
    dataset = valid_dataset = None
    if args.procedural:
        kinds = tuple(args.kinds.split(",")) if args.kinds else None
        dataset = ProceduralSpeechDataset(
            num_items=args.procedural_items,
            length_sec=cfg.trainset.crop_length_sec,
            sample_rate=cfg.trainset.sample_rate,
            babble_style=args.babble_style,
            kind_schedule=kinds,
        )
        valid_dataset = ProceduralSpeechDataset(
            num_items=32,
            length_sec=cfg.trainset.crop_length_sec,
            sample_rate=cfg.trainset.sample_rate,
            seed=6_000_000,
        )
    elif args.synthetic:
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
    result = train(cfg, dataset=dataset, max_iters=args.max_iters, valid_dataset=valid_dataset,
                   device=args.device, data_parallel=args.data_parallel, backend=args.backend,
                   profile_dir=args.profile)
    launches = f": GRU kernel launches {json.dumps(cuda_gru.launch_counts())}" \
        if torch.device(args.device).type == "cuda" else ""
    print(f"rank {os.environ.get('RANK', '0')} ended{launches}", flush=True)
    return result


if __name__ == "__main__":
    main()
