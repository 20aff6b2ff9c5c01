"""Times the port's `gru_dw_sum` beside another build of the same kernel and
torch.sum, by device time (torch.profiler), in turns, on the partials'
shapes of the flagship's training at batch 64 and 8.

    python scripts/torch_dw_sum_compare.py --baseline OTHER/gru_train.cu

OTHER/gru_train.cu is a `gru_train.cu` of an earlier revision whose
`trunet_gru_dw_sum(part, dw, splits, size, stream)` takes no launch plan (the
kernel of one thread per entry, summing the splits in order), for example
one unpacked with `git archive` into a directory that .gitignore lists. It
is built with the port's nvcc flags into build/. One JSON line per shape:
three device-time readings (µs) of each, and each one's error against the
sum in float64, relative to the largest entry. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import device_ms, nvidia_smi_line  # noqa: E402
from tinyrecurrentunet_torch.ops import build, cuda_gru  # noqa: E402

# (splits, H) of the partials: training at batch 64 (FGRU, TGRU), at batch 8
SHAPES = [(260, 64), (132, 128), (126, 64), (126, 128)]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", required=True)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    lib_path = build.BUILD_DIR / "libgru_train_baseline.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), args.baseline], check=True,
                   capture_output=True)
    baseline = ctypes.CDLL(str(lib_path))
    baseline.trunet_gru_dw_sum.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    print(nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for splits, hidden in SHAPES:
        size = 3 * hidden * (hidden + 1)
        part = torch.randn(splits, size, device="cuda", generator=gen)
        want = part.double().sum(0)
        out = torch.empty(size, device="cuda")

        def run_baseline():
            err = baseline.trunet_gru_dw_sum(part.data_ptr(), out.data_ptr(), splits, size,
                                             torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"baseline gru_dw_sum launch failed: {err}")
            return out

        # call, the kernels it times
        calls = {
            "port": (lambda: torch.cat([t.reshape(-1) for t in cuda_gru.dw_sum(part, hidden)]), "gru_dw_sum"),
            "baseline": (run_baseline, "gru_dw_sum"),
            "torch_sum": (lambda: torch.sum(part, dim=0), None),
        }
        line = {"splits": splits, "H": hidden, "size": size, "plan": cuda_gru.sum_plan(splits, size, 132)._asdict()}
        for name, (call, _) in calls.items():
            got = call()
            torch.cuda.synchronize()
            line[f"{name}_rel_err_vs_float64"] = ((got.double() - want).abs().max() / want.abs().max()).item()
        for _ in range(args.rounds):
            for name, (call, kernel) in calls.items():
                line.setdefault(f"{name}_device_us", []).append(device_ms(call, kernel, iters=20) * 1e3)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
