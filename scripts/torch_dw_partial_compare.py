"""Times the port's `gru_dw_partial` on the tensor cores beside another build
of the same kernel, by device time (torch.profiler), in turns (port,
baseline, baseline, port), at the flagship's and proc48k's training launch
shapes (H 64 and 128, batch 64 and 16 of 2 s clips), on the port's split
plan; checks that both give the same bits.

    python scripts/torch_dw_partial_compare.py --baseline OTHER/gru_train.cu

OTHER/gru_train.cu is a `gru_train.cu` of an earlier revision whose
`trunet_gru_dw_partial(out, h0, d_xp, saved, part, rows, T, H, reverse,
splits, n_per_split, stream)` takes no path argument and runs the tensor
cores at H 64 and 128, for example one unpacked with `git archive` into a
directory that .gitignore lists. It is built with the port's nvcc flags into
build/. Prints the ptxas report of both builds' tensor-core kernels, then one
JSON line per shape: the device ms of each side (the lower of two readings),
whether the partials are bit-equal, and the port's error against the plain
version relative to the largest entry. Needs a CUDA card and nvcc.
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

from chip_smoke import device_ms, gru_inputs, max_rel, nvidia_smi_line, randn  # noqa: E402
from tinyrecurrentunet_torch.ops import build, cuda_gru  # noqa: E402
from tinyrecurrentunet_torch.ops import gru as gru_ops  # noqa: E402

SHAPES = [
    # name, rows, T, H, reverse
    ("flagship_fgru_fwd", 16064, 16, 64, False),
    ("flagship_fgru_rev", 16064, 16, 64, True),
    ("flagship_tgru", 1024, 251, 128, False),
    ("proc48k_fgru_fwd", 12016, 16, 64, False),
    ("proc48k_tgru", 256, 751, 128, False),
]


def ptxas_report(log: str) -> list[str]:
    """The register and spill lines of each gru_dw_mma_kernel instantiation."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "gru_dw_mma_kernel" in line:
            name = line.split("gru_dw_mma_kernel")[1].split("EE")[0]
            out.append(f"{name}: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {"port": build.build_all(["gru_train"]).get("gru_train")}
    lib_path = build.BUILD_DIR / "libgru_train_dw_baseline.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), args.baseline], check=True,
                          capture_output=True, text=True)
    logs["baseline"] = proc.stdout + proc.stderr
    for side, log in logs.items():
        for line in ptxas_report(log or ""):  # None: the port's library was already built
            print(f"[ptxas {side}] {line}", flush=True)
    baseline = ctypes.CDLL(str(lib_path))
    baseline.trunet_gru_dw_partial.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    print(nvidia_smi_line(), flush=True)
    device = torch.device("cuda")
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for seed, (name, rows, steps, hidden, reverse) in enumerate(SHAPES):
        x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
        g = randn((rows, steps, hidden), 100 + seed, device)
        g_hT = randn((rows, hidden), 200 + seed, device)
        out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
        d_xp, want_dwh, _, _ = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
        plan = cuda_gru.dw_plan(rows * steps, hidden, num_sms)

        def port():
            return cuda_gru._launch_dw(out, h0, d_xp, saved, reverse, plan=plan)

        def base():
            part = torch.empty(plan.splits, 3 * hidden * (hidden + 1), device=device)
            err = baseline.trunet_gru_dw_partial(out.data_ptr(), h0.data_ptr(), d_xp.data_ptr(), saved.data_ptr(),
                                                 part.data_ptr(), rows, steps, hidden, int(reverse), plan.splits,
                                                 plan.steps_per_split, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"baseline gru_dw_partial launch failed: {err}")
            return part

        got, theirs = port(), base()
        torch.cuda.synchronize()
        dwh = got.sum(0)[: 3 * hidden * hidden].view(hidden, 3 * hidden)
        times = {"port": [], "baseline": []}
        for side in ("port", "baseline", "baseline", "port"):
            times[side].append(device_ms(port if side == "port" else base, "gru_dw_mma_kernel", launches=1))
        print(json.dumps({"shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
                          **plan._asdict(), "port_ms": min(times["port"]), "baseline_ms": min(times["baseline"]),
                          "bit_equal": bool(torch.equal(got, theirs)), "max_rel_err": max_rel(dwh, want_dwh)}),
              flush=True)


if __name__ == "__main__":
    main()
