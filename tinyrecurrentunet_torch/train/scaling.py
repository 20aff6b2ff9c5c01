"""Train-step batch-scaling study, counterpart of `tinyrecurrentunet_tpu/train/scaling.py`:
step time, steps/s, audio-s/s, MFU and peak memory against batch size, in
float32 and bf16.

One row per (batch, dtype) with the JAX row's fields (`batch`, `dtype`,
`step_ms`, `steps_per_sec`, `audio_sec_per_sec`, `mfu`, `gflops_per_step`)
and the port's own: the GRU kernels' share of the FLOPs, the peak the MFU is
taken against, peak device memory and the device. A batch that runs out of
device memory is a row {"batch", "dtype", "oom": True}, the ladder's
ceiling, not a crash.

FLOPs of a step: `torch.utils.flop_counter.FlopCounterMode` around one step
(the matmuls and convolutions autograd dispatches, forward and backward),
plus, on a card, the GRU kernels' FLOPs worked out from their launch shapes
(`gru_kernel_flops`): the kernels are launched through ctypes, which the
counter does not see. On the CPU the plain recurrence is dispatched as
matmuls and the counter counts it. The MFU is against the card's published
peak for the row's dtype (`utils.profiling.peak_flops`: float32 with TF32
off, as training runs, or bf16); without a card it is None.

The kernel A/B of the JAX study (`run_kernel_ab`, `use_pallas_gru`) and its
`lax.scan` unroll A/B have no counterpart here: the port runs its kernels at
every shape.

Usage:
    python -m tinyrecurrentunet_torch.train.scaling -c config/proc16k.json \
        [--batches 16,32,64,128] [--out scaling.json] [--device cpu]
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
                       device: str | torch.device = "cuda") -> dict:
    """One study row: the train step of `cfg` at `batch` clips computing in
    `compute_dtype` ("float32" or "bfloat16"), on seeded noise."""
    from torch.utils.flop_counter import FlopCounterMode

    device = resolve_device(device)
    opt = dataclasses.replace(cfg.train.optimization, batch_size_per_device=batch, train_compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))
    state = create_train_state(tcfg, device=device)
    step = make_train_step(tcfg)
    length = int(tcfg.trainset.crop_length_sec * tcfg.trainset.sample_rate)
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((batch, length)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((batch, length)) * 0.03).astype(np.float32)
    clean, noisy = torch.from_numpy(clean).to(device), torch.from_numpy(noisy).to(device)

    on_card = device.type == "cuda"
    with FlopCounterMode(display=False) as counter:
        step(state, clean, noisy)
    counted = counter.get_total_flops()
    gru_flops = gru_kernel_flops(tcfg, batch, torch.cuda.get_device_properties(device).multi_processor_count) if on_card else 0
    flops = counted + gru_flops
    for _ in range(2):
        step(state, clean, noisy)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
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
        if on_card else "FlopCounterMode (matmuls, convolutions; the plain GRU's among them)",
        "peak_tflops": peak / 1e12 if peak else None,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
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


def run_study(cfg: Config, batches, out_path: str | None, device: str | torch.device = "cuda") -> dict:
    """The ladder: one row per batch and dtype, float32 then bf16."""
    rows = []
    for batch in batches:
        for dtype in ("float32", "bfloat16"):
            row = measure_or_oom(cfg, batch, dtype, device=device)
            rows.append(row)
            print(json.dumps(row), flush=True)
    result = {"scaling": rows}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {out_path}")
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--batches", default="16,32,64,128")
    parser.add_argument("--out", default=None, help="write the study's JSON here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    return run_study(load_config(args.config), batches, args.out, device=args.device)


if __name__ == "__main__":
    main()
