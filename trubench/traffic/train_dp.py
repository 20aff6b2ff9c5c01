"""Data-parallel training on every card of a host: one rank a card, started
by the program's `parallel.launch` (the `--data_parallel` CLI's path with
no launcher), over NCCL, each rank calling `TrainStep` on its own shard.

Parameters (the cell's `params`): those of the `train` mix (`corpus` items
a rank, `check_steps`, `max_steps`, `slice_steps`, `named_steps`), and
`ranks`. Each rank makes its own corpus and its own seeded order of rows
from the seed and its rank (`rank_seed`) and gathers its shard of the
global batch on its card, as the single-card mix does; the global batch is
the ranks' shards stacked rank-major, as the port's data parallelism
defines it (`parallel/mesh.py`).

Set-up on every rank: the process group, the train state with weights
drawn from the seed (the same on every rank), the corpus, and the first
`check_steps` steps through the window's own call and feed (the first
captures each rank's graph with its collectives). The window: step after
step; between steps, outside the graph, the ranks all-reduce a flag that
any rank's clock has passed `--seconds`, so all stop after the same step.

End to end: `dp_train_audio_s_per_s`, the global batch's clips times the
crop's seconds (ranks x clips x crop seconds a step) of every step in the
window, over the longest rank's window: the single card's
`train_audio_s_per_s` at four cards, named apart so that each keeps the
bound its own spread allows.

The ranks hand their readings to the reporting process through files in a
temporary directory; rank 0's are the program's first steps (every rank's
parameters are held equal to rank 0's: `replica_gap`, the largest
difference, exactly 0), and each rank saves the rows it trained on. Each
rank also names the modules of JAX or the JAX package it had loaded once
its window closed: the ranks, not the reporting process, import the
training step, the model and the kernels, and a run in which any rank
loaded one raises, so that it prints no result. Once the ranks have ended,
the reporting process follows the first steps with the reference over the
global batch (`train.compare`, its blocks made again in the backward so
that it fits one card).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil
import tempfile
import time

import numpy as np

from trubench import harness
from trubench.traffic import train as single

RECOMPUTE_ROWS = 64  # the reference's rows a block (`reference/train.py`)


def rank_seed(seed: int, rank: int) -> int:
    """Rank `rank`'s seed of its corpus and order, drawn from the run's seed."""
    return int(np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0] >> 1)


def _rank(fields: dict, out: str):
    """One rank: set-up, the first steps, the window, a traced slice; its
    readings saved to `out`/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from tinyrecurrentunet_torch import parallel
    from tinyrecurrentunet_torch.config import DistConfig
    from tinyrecurrentunet_torch.ops import cuda_gru

    ctx = harness.Context(**fields)
    on_card = ctx.device == "cuda"
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = f"cuda:{local}" if on_card else "cpu"
    if on_card:
        torch.cuda.set_device(local)
    parallel.initialize_distributed(DistConfig(), "nccl" if on_card else "gloo", data_parallel=True)
    rank, p = parallel.rank(), ctx.params
    feed = single.Feed(ctx, device, rank_seed(ctx.seed, rank))
    losses, first_grad, changed = feed.first_steps(p["check_steps"])
    flat = torch.cat([q.reshape(-1) for q in changed.values()])
    high, low = flat.clone(), flat.clone()
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    replica_gap = float((high - low).max())
    harness.settle(ctx.device)

    flag = torch.zeros(1, device=device)
    window_losses = []
    setup_s = ctx.setup_s()
    start = time.perf_counter()
    while True:
        window_losses.append(feed.step())
        flag.fill_(float(time.perf_counter() - start >= ctx.seconds))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() > 0:
            break
    if on_card:
        torch.cuda.synchronize()
    window = torch.tensor([time.perf_counter() - start], dtype=torch.float64, device=device)
    dist.all_reduce(window, op=dist.ReduceOp.MAX)
    reading = {"rank": rank, "steps": len(window_losses), "window_s": float(window),
               "failed": int((~torch.isfinite(torch.stack(window_losses))).sum()),
               "peak": harness.memory_peak(ctx.device), "setup_s": setup_s, "replica_gap": replica_gap,
               "slice": None, "check_rows": feed.check_batches(p["check_steps"])}
    if ctx.trace:
        from trubench import trace

        reading["slice"] = trace.traced(lambda: feed.step(True), p["slice_steps"], p["named_steps"],
                                        lambda: sum(cuda_gru.launch_counts().values()))
        reading["slice_gru_bound_s"] = feed.gru_bound_s(ctx, p["slice_steps"])
    reading["forbidden"] = harness.forbidden_modules()  # what the rank loaded, the timed path's modules among it
    if rank == 0:
        reading.update(losses=losses, first_grad={n: g.cpu() for n, g in first_grad.items()},
                       changed={n: q.cpu() for n, q in changed.items()},
                       initial={n: t.cpu() for n, t in feed.initial.items()})
    torch.save(reading, pathlib.Path(out) / f"rank{rank}.pt")
    feed.close()  # no graph holding collectives outlives the group
    dist.barrier()
    dist.destroy_process_group()


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from tinyrecurrentunet_torch import parallel
    from tinyrecurrentunet_torch.config import DistConfig
    from trubench.traffic import train_dp  # by its importable name, for the spawned ranks

    ranks = ctx.params["ranks"]
    # the reference over the global batch is this process's only use of a card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    out = tempfile.mkdtemp(prefix="trubench-")
    try:
        fields = {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx)}
        parallel.launch(train_dp._rank, (fields, out), DistConfig(), ctx.device, local_ranks=ranks)
        readings = sorted((torch.load(path, weights_only=False) for path in pathlib.Path(out).glob("rank*.pt")),
                          key=lambda r: r["rank"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if len(readings) != ranks:
        raise RuntimeError(f"{len(readings)} of {ranks} ranks reported")
    found = {r["rank"]: r["forbidden"] for r in readings if r["forbidden"]}
    if found:
        raise RuntimeError(f"trubench: loaded in the ranks that ran the timed path: {found}")
    lead = readings[0]
    batch = ctx.config["optimization"]["batch_size_per_device"]
    window = max(r["window_s"] for r in readings)
    steps = lead["steps"]
    frames = 1 + int(ctx.config["crop_length_sec"] * ctx.config["featurizer"]["sample_rate"]) \
        // ctx.config["featurizer"]["hop_length"]
    facts = {"window_s": window, "forward_frames": 3 * steps * ranks * batch * frames,
             "dtype": ctx.config["train_dtype"], "replica_gap": max(r["replica_gap"] for r in readings)}
    slice_ = None
    if ctx.trace:
        slices = [r["slice"] for r in readings]
        facts["rank_slices"] = slices
        facts["slice_gru_bound_s"] = lead["slice_gru_bound_s"]
        slice_ = max(slices, key=lambda sl: 1.0 - sl.busy_s() / sl.seconds)  # the idlest rank
        facts["busy_s"] = float(np.mean([sl.busy_s() for sl in slices]))
        facts["traced_window_s"] = float(np.mean([sl.seconds for sl in slices]))
    global_rows = [tuple(np.concatenate([r["check_rows"][k][i] for r in readings]) for i in (0, 1))
                   for k in range(ctx.params["check_steps"])]
    checks = single.compare(ctx, facts, lead["initial"], (lead["losses"], lead["first_grad"], lead["changed"]),
                            global_rows, recompute_rows=RECOMPUTE_ROWS)
    harness.free_program()  # the reference's cache off card 0 before any later ranks start there
    checks.append(harness.Check("replica_gap", facts["replica_gap"], ctx.limit("replica_gap")))
    e2e = {"dp_train_audio_s_per_s": steps * ranks * batch * ctx.config["crop_length_sec"] / window,
           "setup_s": lead["setup_s"]}
    return harness.Outcome(e2e, steps, sum(r["failed"] for r in readings), checks,
                           max(r["peak"] for r in readings), facts, slice_)
