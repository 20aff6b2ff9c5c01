"""One data-parallel train step of the port, from one rank's side.

Run it as every rank of a process group (torchrun sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    python -m torch.distributed.run --nproc_per_node 2 scripts/torch_dp_step.py \
        -c CONFIG.json --out DIR [--items 16] [--device cpu|cuda:0] [--backend gloo] [--controls]

Each rank drives `train.loop.train(..., data_parallel=True)` for one step on
`--items` synthetic clips (the CLI's `--synthetic` set), its loader shard at
the config's `batch_size_per_device`, and writes `DIR/rank<r>.npz` (its
batch as the loader gave it, the parameters and buffers after the step, the
summed and clipped gradients) and `DIR/rank<r>.json` (the step's metrics,
the kernels' launch counts). Whoever compares holds them against a
single-process step on the ranks' batches stacked rank-major
(tests/test_torch_parallel.py against the JAX mesh step on the CPU,
chip_smoke.py on the card).

`--time_steps N` then times N more steps from there on the same batch
(host clock, synchronised; the all-reduces pass through the host under
gloo) and reports their mean as `step_ms`.

`--controls` also writes, under `local_bn/` and `grads_x_w/`, the same step
from the same weights with BatchNorm on rank-local statistics and with the
summed gradients left W times too large: two ways of getting data
parallelism wrong that the comparison must catch. And under `reduce/`, the
global-batch reductions on seeded shards: a train-mode BatchNorm (output,
input gradient, running statistics), the spectral convergence and the
per-item weights.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import types
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tinyrecurrentunet_torch import parallel  # noqa: E402
from tinyrecurrentunet_torch.config import load_config  # noqa: E402
from tinyrecurrentunet_torch.data import DataLoader, SyntheticPairDataset  # noqa: E402
from tinyrecurrentunet_torch.losses.composite import per_item_weights  # noqa: E402
from tinyrecurrentunet_torch.losses.mrstft import spectral_convergence_loss  # noqa: E402
from tinyrecurrentunet_torch.models import blocks  # noqa: E402
from tinyrecurrentunet_torch.ops import cuda_gru  # noqa: E402
from tinyrecurrentunet_torch.train import loop  # noqa: E402
from tinyrecurrentunet_torch.train.state import create_train_state  # noqa: E402
from tinyrecurrentunet_torch.train.step import make_train_step  # noqa: E402
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter  # noqa: E402


def state_arrays(state, prefix: str = "") -> dict:
    """Copies of the model's parameters, gradients and buffers."""
    model = state.model
    out = {f"{prefix}param/{n}": p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}
    out.update({f"{prefix}grad/{n}": p.grad.cpu().numpy().copy() for n, p in model.named_parameters()})
    out.update({f"{prefix}buffer/{n}": b.cpu().numpy().copy() for n, b in model.named_buffers()})
    return out


def controls(cfg, clean, noisy, device) -> tuple[dict, dict]:
    """The step with BatchNorm on local statistics, and with the gradients'
    sum not divided by W, each from fresh initial weights."""

    def summed_only(tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        torch.distributed.all_reduce(flat)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()

    local = types.SimpleNamespace(world_size=lambda: 1, all_reduce_sum=parallel.all_reduce_sum)
    arrays, metrics = {}, {}
    for name, patch in (("local_bn", mock.patch.object(blocks, "parallel", local)),
                        ("grads_x_w", mock.patch.object(parallel, "sum_gradients_", summed_only))):
        state = create_train_state(cfg, device=device)
        with patch:
            state, m = make_train_step(cfg)(state, clean, noisy)
        arrays.update(state_arrays(state, f"{name}/"))
        metrics[name] = {k: float(v) for k, v in m.items()}
    return arrays, metrics


def reductions(device) -> dict:
    """The global-batch reductions on this rank's shard of seeded data."""
    r, world = parallel.rank(), parallel.world_size()
    rng = np.random.default_rng(21)
    n = 3  # items a rank
    x = torch.from_numpy((rng.standard_normal((n * world, 7, 5)) * 2 + 1).astype(np.float32))
    upstream = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    mags = torch.from_numpy(rng.uniform(0.1, 2.0, (2, n * world, 9, 11)).astype(np.float32))
    audio = torch.from_numpy(rng.standard_normal((2, n * world, 400)).astype(np.float32))
    audio[1] *= torch.from_numpy(rng.uniform(0.1, 3.0, (n * world, 1)).astype(np.float32))
    shard = slice(r * n, (r + 1) * n)

    bn = blocks.BatchNorm(5, device=device).train()
    xs = x[shard].to(device).requires_grad_()
    y = bn(xs)
    parallel.all_reduce_sum(torch.sum(y * upstream[shard].to(device))).backward()
    return {
        "reduce/bn_out": y.detach().cpu().numpy(),
        "reduce/bn_grad": xs.grad.cpu().numpy(),
        "reduce/bn_running_mean": bn.running_mean.cpu().numpy(),
        "reduce/bn_running_var": bn.running_var.cpu().numpy(),
        "reduce/spectral_convergence": spectral_convergence_loss(
            mags[0, shard].to(device), mags[1, shard].to(device), across_ranks=True).cpu().numpy(),
        "reduce/per_item_weights": per_item_weights(
            audio[0, shard].to(device), audio[0, shard].to(device) + audio[1, shard].to(device),
            across_ranks=True).cpu().numpy(),
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--items", type=int, default=16, help="size of the synthetic training set")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    parser.add_argument("--controls", action="store_true")
    parser.add_argument("--time_steps", type=int, default=0)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = load_config(args.config)
    opt = cfg.train.optimization
    dataset = SyntheticPairDataset(num_items=args.items, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    cuda_gru.reset_launch_counts()
    # metrics as JSONL only: TensorBoard's import pulls in TensorFlow where it is installed
    with mock.patch.object(loop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False)):
        state, metrics = loop.train(cfg, dataset, max_iters=1, device=args.device, data_parallel=True,
                                    backend=args.backend)
    device = next(state.model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = cuda_gru.launch_counts()
    r, world = parallel.rank(), parallel.world_size()
    # the batch the loader gave this rank for step 0
    clean, noisy, _ = next(iter(DataLoader(dataset, batch_size=opt.batch_size_per_device, shuffle=True,
                                           drop_last=True, seed=opt.seed, **parallel.loader_shard())))
    arrays = {"clean": clean, "noisy": noisy, **state_arrays(state)}
    report = {"rank": r, "world": world, "device": str(device), "metrics": metrics, "launches": counts}
    batch = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (clean, noisy)]
    if args.controls:
        more, report["controls"] = controls(cfg, *batch, device)
        arrays.update(more)
        arrays.update(reductions(device))
    if args.time_steps:
        step = make_train_step(cfg)
        step(state, *batch)
        parallel.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.time_steps):
            step(state, *batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report["step_ms"] = (time.perf_counter() - t0) / args.time_steps * 1e3
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"rank{r}.npz"), **arrays)
    with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
        json.dump(report, f)
    parallel.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
