"""One data-parallel train step of the port, from one rank's side.

Run it as every rank of a process group (torchrun sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT), or alone, where it makes a group
of one rank on a free port of localhost:

    python -m torch.distributed.run --nproc_per_node 2 scripts/torch_dp_step.py \
        -c CONFIG.json --out DIR [--items 16] [--device cpu|cuda:0] [--backend gloo] [--controls]
    python scripts/torch_dp_step.py -c CONFIG.json --out DIR --device cuda:0 --backend nccl [--graph_vs_body 3]

Each rank drives `train.loop.train(..., data_parallel=True)` for one step on
`--items` synthetic clips (the CLI's `--synthetic` set), its loader shard at
the config's `batch_size_per_device`, and writes `DIR/rank<r>.npz` (its
batch as the loader gave it, the parameters and buffers after the step, the
summed and clipped gradients) and `DIR/rank<r>.json` (the step's metrics,
the kernels' launch counts, whether the step replayed its CUDA graph:
over NCCL on a card it does, over gloo it runs the body). Whoever compares
holds them against a
single-process step on the ranks' batches stacked rank-major
(tests/test_torch_parallel.py against the JAX mesh step on the CPU,
chip_smoke.py on the card).

`--time_steps N` then times N more steps from there on the same batch, of
a train step made as train() makes its own (train() closes its steps at
its end; the first call, untimed, captures where the step replays) (host
clock, synchronised; the all-reduces pass through the host under gloo) and
reports their mean as `step_ms` (replayed where the step replays), then N
of its body uncaptured (`replay=False`) as `body_ms`.

`--graph_vs_body N` (on a card) trains two fresh states N steps on this
rank's batch under torch.backends.cudnn.deterministic, one through the
step's graph and one through the same body uncaptured, and reports for each
call whether graph and body gave the same bits (metrics, parameters,
gradients, buffers) and the kernels' launches of the replayed call; the
collectives issued while the step was captured (each `all_reduce`, from the
main thread or from autograd's) and the NCCL kernels torch.profiler names
in one more replay.

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
import gc
import json
import os
import socket
import sys
import threading
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

    local = types.SimpleNamespace(all_reduce_sum=lambda t: t)  # BatchNorm's sums stay on the rank
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


def graph_vs_body(cfg, clean, noisy, device, steps: int) -> dict:
    """`steps` replayed steps against as many uncaptured ones, each from the
    initial weights, under cudnn.deterministic (see the module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    collectives = []
    all_reduce = torch.distributed.all_reduce

    def counted(*args, **kwargs):
        collectives.append((torch.cuda.is_current_stream_capturing(),
                            threading.current_thread() is threading.main_thread()))
        return all_reduce(*args, **kwargs)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with mock.patch.object(torch.distributed, "all_reduce", counted):
            states = [create_train_state(cfg, device=device) for _ in range(2)]
            graph, body = make_train_step(cfg), make_train_step(cfg)
            calls = []
            for _ in range(steps):
                cuda_gru.reset_launch_counts()
                _, got = graph(states[0], clean, noisy)
                torch.cuda.synchronize(device)
                launches = cuda_gru.launch_counts()
                _, want = body(states[1], clean, noisy, replay=False)
                a, b = state_arrays(states[0]), state_arrays(states[1])
                calls.append({"replayed": graph.replayed, "launches": launches,
                              "metrics_equal": all(torch.equal(got[k], want[k]) for k in want),
                              "state_equal": all(np.array_equal(a[k], b[k]) for k in b)})
            captured = [main for capturing, main in collectives if capturing]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graph(states[0], clean, noisy)
                torch.cuda.synchronize(device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"calls": calls, "captures": graph.captures, "body_captures": body.captures,
            "captured_all_reduces": {"main_thread": sum(captured), "autograd_thread": len(captured) - sum(captured)},
            "replay_kernels": sum(e.count for e in kernels),
            "replay_nccl_kernels": {e.key: e.count for e in kernels if "nccl" in e.key.lower()}}


def join_group(backend: str):
    """torchrun's group (env://), or alone a group of one rank on a free
    port of localhost."""
    if "MASTER_ADDR" in os.environ:
        torch.distributed.init_process_group(backend, init_method="env://")
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.distributed.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--items", type=int, default=16, help="size of the synthetic training set")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    parser.add_argument("--controls", action="store_true")
    parser.add_argument("--time_steps", type=int, default=0)
    parser.add_argument("--graph_vs_body", type=int, default=0, metavar="N")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = parallel.local_device(args.device)
    if device.index is not None:
        torch.cuda.set_device(device)  # NCCL makes its communicator on the current card
    join_group(args.backend or parallel.default_backend(device))

    cfg = load_config(args.config)
    opt = cfg.train.optimization
    dataset = SyntheticPairDataset(num_items=args.items, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    cuda_gru.reset_launch_counts()
    made = []
    make = loop.make_train_step
    # metrics as JSONL only: TensorBoard's import pulls in TensorFlow where it is installed
    with mock.patch.object(loop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False)), \
            mock.patch.object(loop, "make_train_step", lambda *a, **k: made.append(make(*a, **k)) or made[-1]):
        state, metrics = loop.train(cfg, dataset, max_iters=1, device=args.device, data_parallel=True,
                                    backend=args.backend)
    step = made[0]
    if not step.closed:
        raise AssertionError("train() left its train step open")
    device = next(state.model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = cuda_gru.launch_counts()
    r, world = parallel.rank(), parallel.world_size()
    # the batch the loader gave this rank for step 0
    clean, noisy, _ = next(iter(DataLoader(dataset, batch_size=opt.batch_size_per_device, shuffle=True,
                                           drop_last=True, seed=opt.seed, **parallel.loader_shard())))
    arrays = {"clean": clean, "noisy": noisy, **state_arrays(state)}
    report = {"rank": r, "world": world, "device": str(device), "backend": torch.distributed.get_backend(),
              "metrics": metrics, "launches": counts, "replayed": step.replayed, "captures": step.captures}
    batch = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (clean, noisy)]
    if args.controls:
        more, report["controls"] = controls(cfg, *batch, device)
        arrays.update(more)
        arrays.update(reductions(device))
    step = make_train_step(cfg)
    for key, replay in (("step_ms", True), ("body_ms", False)) if args.time_steps else ():
        step(state, *batch, replay=replay)
        parallel.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.time_steps):
            step(state, *batch, replay=replay)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report[key] = (time.perf_counter() - t0) / args.time_steps * 1e3
    if args.graph_vs_body:
        report["graph_vs_body"] = graph_vs_body(cfg, *batch, device, args.graph_vs_body)
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"rank{r}.npz"), **arrays)
    with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
        json.dump(report, f)
    # NCCL's communicator is destroyed once no CUDA graph holds its
    # collectives: with a graph alive, destroying it hung at 4 ranks
    step.close()
    made.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parallel.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
