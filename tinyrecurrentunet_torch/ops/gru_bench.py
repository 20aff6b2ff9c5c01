"""GRU recurrence microbenchmark: the plain PyTorch version against the CUDA
kernel, counterpart of `tinyrecurrentunet_tpu/ops/gru_bench.py`.

Runs both over the JAX bench's five cases (rows, length, input features,
hidden) and prints one JSON row a case: `plain_us` (`ops.gru.gru_scan`, the
plain recurrence, one Python step a frame), `cuda_us` (`gru_layer` over
`ops.cuda_gru.gru_recurrence`: the same input projection, then the kernel
`gru_fwd`) and `speedup` = plain_us / cuda_us. On the CPU the wrapper runs
the plain version, so both columns time it there. The plain version takes
`plain_reps` calls a reading (a few: it is ~751 launches of small kernels a
call at the longest case), the kernel `reps`. Times come from
`utils.profiling.throughput_seconds`. Each row also holds `max_abs_err`, the
largest difference between the kernel's outputs (sequence and last state) and
the plain version's on the case's inputs, from the warm-up call of each.

Usage:
    python -m tinyrecurrentunet_torch.ops.gru_bench [--reps 50] [--plain_reps 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.ops.gru import gru_layer, gru_scan
from tinyrecurrentunet_torch.utils.profiling import throughput_seconds

CASES = (
    # (rows, length, in_features, hidden, label)
    (16, 250, 64, 128, "TGRU offline 2s@16k (B*Fb=16, T=250)"),
    (16, 751, 64, 128, "TGRU offline 2s@48k-frames (T=751)"),
    (16, 8, 64, 128, "TGRU chunked-8 streaming step"),
    (64, 250, 64, 128, "TGRU offline batch-4 clips"),
    (250, 16, 128, 64, "FGRU offline 2s@16k (B*T=250, Fb=16)"),
)


def _bench(fn, args, reps: int):
    """-> (seconds a call, the outputs of the warm-up call)."""
    warm = fn(*args)  # warm: the kernel's build and first launch
    sec = throughput_seconds(lambda: fn(*args), lambda out: float(out[0].ravel()[0]),
                             reps_hi=reps, reps_lo=max(reps // 5, 1))
    return sec, warm


def run(reps: int = 50, plain_reps: int = 3, device="cuda", cases=CASES) -> list[dict]:
    """One row a case: {case, rows, length, plain_us, cuda_us, speedup,
    max_abs_err, device}."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    results = []
    for rows, length, d, h, label in cases:
        arrays = (rng.standard_normal((rows, length, d)), np.zeros((rows, h)),
                  rng.standard_normal((d, 3 * h)) * 0.05, rng.standard_normal((h, 3 * h)) * 0.05,
                  np.zeros(3 * h), np.zeros(3 * h))
        args = [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]
        with torch.inference_mode():
            t_plain, plain_out = _bench(gru_scan, args, plain_reps)
            t_cuda, cuda_out = _bench(lambda *a: gru_layer(*a, cuda_gru.gru_recurrence), args, reps)
        err = max(float((c - p).abs().max()) for c, p in zip(cuda_out, plain_out))
        row = {
            "case": label,
            "rows": rows,
            "length": length,
            "plain_us": t_plain * 1e6,
            "cuda_us": t_cuda * 1e6,
            "speedup": t_plain / t_cuda,
            "max_abs_err": err,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        }
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=50, help="kernel calls a reading")
    parser.add_argument("--plain_reps", type=int, default=3, help="plain-version calls a reading")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run(args.reps, args.plain_reps, args.device)


if __name__ == "__main__":
    main()
