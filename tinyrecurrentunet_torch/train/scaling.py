"""Train-step batch-scaling study, counterpart of `tinyrecurrentunet_tpu/train/scaling.py`:
step time, steps/s, audio-s/s, MFU and peak memory against batch size, in
float32 and bf16.

One row per (batch, dtype) with the JAX row's fields (`batch`, `dtype`,
`step_ms`, `steps_per_sec`, `audio_sec_per_sec`, `mfu`, `gflops_per_step`)
and the port's own: the GRU kernels' share of the FLOPs, the peak the MFU is
taken against, peak device memory and the device. A batch that runs out of
device memory is a row {"batch", "dtype", "oom": True}, the ladder's
ceiling, not a crash.

The step is timed as training runs it, replayed from its CUDA graph on a
card (`train/step.py`), the "never" rows of the kernel A/B too (the plain
recurrence captured as it is); each row carries the bytes of the step's
graph memory pool and the card's peak reserve beside its peak allocation
(a replay allocates nothing: the pool holds the step's working set).

FLOPs of a step: `torch.utils.flop_counter.FlopCounterMode` around one
uncaptured run of the step's body, whose operators it sees dispatched (the
matmuls and convolutions autograd dispatches, forward and backward),
plus, on a card, the GRU kernels' FLOPs worked out from their launch shapes
(`gru_kernel_flops`): the kernels are launched through ctypes, which the
counter does not see. On the CPU the plain recurrence is dispatched as
matmuls and the counter counts it. The MFU is against the card's published
peak for the row's dtype (`utils.profiling.peak_flops`: float32 with TF32
off, as training runs, or bf16); without a card it is None.

The kernel A/B (`run_kernel_ab`, and `run_study`'s `train_kernel_ab`
block): the float32 step with `network.use_pallas_gru` "never" (the plain
PyTorch recurrence and BPTT, no kernel of the port) against "always" (the
five CUDA kernels), each row a ladder row plus `use_pallas_gru`. The JAX
study's `lax.scan` unroll A/B (`train_unroll_ab`) has no counterpart: the
port has no `lax.scan`, so its block is empty and the result says why.

Usage:
    python -m tinyrecurrentunet_torch.train.scaling -c config/proc16k.json \
        [--batches 16,32,64,128] [--out scaling.json] [--device cpu]
    python -m tinyrecurrentunet_torch.train.scaling -c config/proc16k.json \
        --kernel_ab_only --batches 64 [--ab_dtypes float32] [--out scaling.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys

import numpy as np
import torch

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.train.state import create_train_state
from tinyrecurrentunet_torch.train.step import make_train_step
from tinyrecurrentunet_torch.utils import graphs
from tinyrecurrentunet_torch.utils.profiling import peak_flops, throughput_seconds


def gru_kernel_flops(cfg: Config, batch: int, num_sms: int) -> int:
    """FLOPs of the GRU kernels in one train step at `batch` clips: the
    FGRU's two directions (rows B * frames, T the bottleneck bins, H
    fgru_hidden) and the TGRU (rows B * bins, T frames, H tgru_hidden), each
    through `gru_fwd_train` (2 H 3H + 12 H a row-step), `gru_bwd`
    (2 3H H + 20 H), `gru_dw_partial` (2 H 3H + 4 H) and `gru_dw_sum` (one add
    a split for each of dWh's and dbh's 3H (H + 1) entries)."""
    from tinyrecurrentunet_torch.models import TRUNet

    net = cfg.network
    frames = int(cfg.trainset.crop_length_sec * cfg.trainset.sample_rate) // cfg.featurizer.hop_length + 1
    bins = TRUNet(net, device="meta").bottleneck_freqs(cfg.featurizer.num_freqs)
    launches = [(batch * frames, bins, net.fgru_hidden)] * 2 + [(batch * bins, frames, net.tgru_hidden)]
    total = 0
    for rows, steps, h in launches:
        n = rows * steps
        splits, _ = cuda_gru.dw_splits(n, h, num_sms)
        total += n * (2 * h * 3 * h + 12 * h) + n * (2 * 3 * h * h + 20 * h) + n * (2 * h * 3 * h + 4 * h)
        total += splits * 3 * h * (h + 1)
    return total


def measure_train_step(cfg: Config, batch: int, compute_dtype: str, reps_hi: int = 30, reps_lo: int = 6,
                       device: str | torch.device = "cuda", use_pallas_gru: str | None = None) -> dict:
    """One study row: the train step of `cfg` at `batch` clips computing in
    `compute_dtype` ("float32" or "bfloat16"), on seeded noise; with
    `use_pallas_gru`, the GRU implementation that value names."""
    from torch.utils.flop_counter import FlopCounterMode

    device = resolve_device(device)
    opt = dataclasses.replace(cfg.train.optimization, batch_size_per_device=batch, train_compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))
    if use_pallas_gru is not None:
        tcfg = dataclasses.replace(tcfg, network=dataclasses.replace(tcfg.network, use_pallas_gru=use_pallas_gru))
    state = create_train_state(tcfg, device=device)
    train_step = make_train_step(tcfg)
    steps = 0

    def step(*args, replay=True):
        nonlocal steps
        captures = train_step.captures
        out = train_step(*args, replay=replay)
        steps += 1 + graphs.WARMUP * (train_step.captures - captures)  # a capturing call's warm-ups
        return out

    length = int(tcfg.trainset.crop_length_sec * tcfg.trainset.sample_rate)
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((batch, length)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((batch, length)) * 0.03).astype(np.float32)
    clean, noisy = torch.from_numpy(clean).to(device), torch.from_numpy(noisy).to(device)

    on_card = device.type == "cuda"
    kernels = on_card and tcfg.network.use_pallas_gru != "never"
    with FlopCounterMode(display=False) as counter:
        step(state, clean, noisy, replay=False)
    counted = counter.get_total_flops()
    gru_flops = gru_kernel_flops(tcfg, batch, torch.cuda.get_device_properties(device).multi_processor_count) if kernels else 0
    flops = counted + gru_flops
    for _ in range(2):
        step(state, clean, noisy)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)  # after the capture: the replays' peaks
    sec = throughput_seconds(lambda: step(state, clean, noisy)[1], lambda m: float(m["loss"]),
                             reps_hi=reps_hi, reps_lo=reps_lo)
    peak = peak_flops(device, compute_dtype) if on_card else None
    audio_sec = batch * tcfg.trainset.crop_length_sec
    return {
        "batch": batch,
        "dtype": compute_dtype,
        "step_ms": sec * 1e3,
        "steps_per_sec": 1.0 / sec,
        "audio_sec_per_sec": audio_sec / sec,
        "mfu": flops / (sec * peak) if peak else None,
        "gflops_per_step": flops / 1e9,
        "gru_kernel_gflops": gru_flops / 1e9,
        "flops": "FlopCounterMode (matmuls, convolutions) + the GRU kernels from their launch shapes"
        if kernels else "FlopCounterMode (matmuls, convolutions; the plain GRU's among them)",
        "peak_tflops": peak / 1e12 if peak else None,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
        "peak_reserved_gb": torch.cuda.max_memory_reserved(device) / 1e9 if on_card else None,
        "graph_pool_bytes": graphs.pool_bytes(train_step._pool) if on_card else None,
        # the card's reserve after the capture's warm-ups, before their cached blocks were freed
        "reserved_after_warmup_bytes": next(iter(train_step._slots.values())).memory["reserved_after_warmup"]
        if on_card else None,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "steps": steps,  # train steps the row ran, the capture's warm-ups and the FLOP count included
    }


def measure_or_oom(cfg: Config, batch: int, dtype: str, **kw) -> dict:
    """measure_train_step, or the row {"batch", "dtype", "oom": True} when the
    batch does not fit in device memory. The JAX study also records any other
    failure as a row, since over its remote compile an out-of-memory can
    arrive as an opaque error; here it has its own type, and anything else
    raises."""
    try:
        return measure_train_step(cfg, batch, dtype, **kw)
    except torch.OutOfMemoryError as e:
        print(f"row (batch={batch},{dtype}) failed: {str(e)[:200]}", file=sys.stderr)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"batch": batch, "dtype": dtype, "oom": True}


UNROLL_AB_NOTE = "no counterpart: gru_scan_unroll is lax.scan's unroll factor, and the port has no lax.scan"


def kernel_ab_rows(cfg: Config, batches, dtypes=("float32",), **kw) -> list:
    """The kernel A/B: at each batch and dtype, a "never" row then an
    "always" row."""
    rows = []
    for batch in batches:
        for dtype in dtypes:
            for kernel in ("never", "always"):
                row = measure_or_oom(cfg, batch, dtype, use_pallas_gru=kernel, **kw)
                row["use_pallas_gru"] = kernel
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def _write(result: dict, out_path: str | None):
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {out_path}")


def run_study(cfg: Config, batches, out_path: str | None, device: str | torch.device = "cuda", **kw) -> dict:
    """The ladder, one row per batch and dtype, float32 then bf16; then the
    kernel A/B in float32."""
    rows = []
    for batch in batches:
        for dtype in ("float32", "bfloat16"):
            row = measure_or_oom(cfg, batch, dtype, device=device, **kw)
            rows.append(row)
            print(json.dumps(row), flush=True)
    # at the smallest and the largest batch that fit; a pair with a row that
    # runs out of memory is measured again at half the batch
    fits = sorted({r["batch"] for r in rows if not r.get("oom")})
    kernel_ab = []
    for batch in sorted({fits[0], fits[-1]}) if fits else []:
        while batch >= 2:
            pair = kernel_ab_rows(cfg, [batch], device=device, **kw)
            kernel_ab.extend(pair)
            if all("step_ms" in r for r in pair):
                break
            batch //= 2
    result = {
        "scaling": rows,
        "train_kernel_ab": kernel_ab,
        "train_unroll_ab": [],
        "train_unroll_ab_note": UNROLL_AB_NOTE,
    }
    _write(result, out_path)
    return result


def run_kernel_ab(cfg: Config, batches, out_path: str | None, dtypes=("float32",),
                  device: str | torch.device = "cuda", **kw) -> list:
    """The kernel A/B alone at `batches` and `dtypes`; with `out_path`, it
    replaces the `train_kernel_ab` block of the study file there (the ladder
    is not run again)."""
    rows = kernel_ab_rows(cfg, batches, dtypes, device=device, **kw)
    if out_path:
        try:
            with open(out_path) as f:
                result = json.load(f)
        except (OSError, ValueError):
            result = {"scaling": [], "train_unroll_ab": [], "train_unroll_ab_note": UNROLL_AB_NOTE}
        result["train_kernel_ab"] = rows
        _write(result, out_path)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--batches", default="16,32,64,128")
    parser.add_argument("--out", default=None, help="write the study's JSON here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--kernel_ab_only", action="store_true",
                        help="only the kernel A/B at --batches, merged into --out")
    parser.add_argument("--ab_dtypes", default="float32")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    batches = [int(b) for b in args.batches.split(",")]
    if args.kernel_ab_only:
        return run_kernel_ab(cfg, batches, args.out, tuple(args.ab_dtypes.split(",")), device=args.device)
    return run_study(cfg, batches, args.out, device=args.device)


if __name__ == "__main__":
    main()
