"""Sweeps the launch plans of the port's `gru_fwd` and `gru_dw_partial`
kernels on the card, at the shapes the flagship and large16k give them in
serving (batch 1, a 4 s clip) and in evaluation and training at batch 64 of
2 s clips.

    python scripts/torch_gru_kernel_profile.py [--only fwd|dw] [--iters 20]

For every shape and every plan (path and rows per tile for `gru_fwd`, so
every instantiation the library builds is launched; splits for
`gru_dw_partial`) it prints one JSON line: the error against the plain
PyTorch version on the same inputs, the errors of both against the plain
version in float64, the kernel's time by CUDA events (for `gru_fwd` also its
device time under torch.profiler, which leaves the host's launch cost out),
and the time of the PyTorch call that computes the same function
(torch.nn.GRU, torch.matmul on operands made beforehand). The plan that
`fwd_plan` / `dw_splits` choose is marked "chosen". The build log (ptxas
registers and spills) comes first. Fails if any plan misses chip_smoke.py's
tolerance against the plain version (KERNEL_ATOL, DW_RTOL). Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (DW_RTOL, KERNEL_ATOL, cuda_ms, gru_inputs, max_abs, max_rel,  # noqa: E402
                        nvidia_smi_line, randn, torch_gru_same_function)
from tinyrecurrentunet_torch.ops import build, cuda_gru  # noqa: E402
from tinyrecurrentunet_torch.ops import gru as gru_ops  # noqa: E402

FWD_SHAPES = [
    # name, rows, T, H, reverse
    ("fgru_fwd", 556, 16, 64, False),
    ("fgru_rev", 556, 16, 64, True),
    ("tgru", 16, 556, 128, False),
    ("large16k_fgru_fwd", 556, 16, 256, False),
    ("large16k_fgru_rev", 556, 16, 256, True),
    ("large16k_tgru", 16, 556, 512, False),
    # evaluation at batch 64 of 2 s clips, as validation inside train() runs it
    ("eval64_fgru", 16064, 16, 64, False),
    ("eval64_tgru", 1024, 251, 128, False),
    ("eval64_large16k_fgru", 16064, 16, 256, False),
    ("eval64_large16k_tgru", 1024, 251, 512, False),
]
DW_SHAPES = [
    ("train_fgru_fwd", 16064, 16, 64, False),
    ("train_fgru_rev", 16064, 16, 64, True),
    ("train_tgru", 1024, 251, 128, False),
]


def device_ms(fn, name: str, iters: int = 10) -> float:
    """Mean device time in ms of the kernels whose name contains `name`
    over `iters` calls of fn(), from torch.profiler (no host overhead)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages() if name in e.key)
    return total / iters / 1e3


def sweep_fwd(iters: int, num_sms: int) -> list[str]:
    device = torch.device("cuda")
    failures = []
    for seed, (name, rows, steps, hidden, reverse) in enumerate(FWD_SHAPES):
        args = gru_inputs(rows, steps, hidden, seed, device)
        want = gru_ops.gru_recurrence(*args, reverse=reverse)
        want64 = gru_ops.gru_recurrence(*(a.double() for a in args), reverse=reverse)
        plain_err64 = max(max_abs(a.double(), b) for a, b in zip(want, want64))
        with torch.no_grad():
            library_ms = cuda_ms(torch_gru_same_function(*args, reverse), iters)
        max_clusters = cuda_gru._max_clusters(device, hidden)
        chosen = cuda_gru.fwd_plan(rows, steps, hidden, num_sms, max_clusters)
        plans = [cuda_gru.FwdPlan("general", r) for r in (1, 2, 4, 8) if hidden * r * 2 <= 2048 or r == 1]
        plans += [cuda_gru.FwdPlan(chosen.path, r) for r in cuda_gru._RESIDENT[hidden][2]]
        for plan in plans:
            def run():
                return cuda_gru._launch(*args, reverse, plan=plan)

            got = run()
            torch.cuda.synchronize()
            err = max(max_abs(a, b) for a, b in zip(got, want))
            print(json.dumps({
                "kernel": "gru_fwd", "shape": name, "rows": rows, "T": steps, "H": hidden,
                **plan._asdict(), "chosen": plan == chosen, "max_clusters": max_clusters,
                "max_abs_err": err,
                "max_abs_err_vs_float64": max(max_abs(a.double(), b) for a, b in zip(got, want64)),
                "plain_abs_err_vs_float64": plain_err64,
                "ms": cuda_ms(run, iters), "device_ms": device_ms(run, "gru_fwd"),
                "library_ms": library_ms}), flush=True)
            if not err <= KERNEL_ATOL:
                failures.append(f"gru_fwd {name} {plan}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return failures


def sweep_dw(iters: int, num_sms: int) -> list[str]:
    device = torch.device("cuda")
    failures = []
    for seed, (name, rows, steps, hidden, reverse) in enumerate(DW_SHAPES):
        x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, 10 + seed, device)
        g = randn((rows, steps, hidden), 110 + seed, device)
        g_hT = randn((rows, hidden), 210 + seed, device)
        out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
        d_xp, want_dwh, want_dbh, _ = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
        h_prev = torch.cat([out[:, 1:], h0[:, None]], 1) if reverse else torch.cat([h0[:, None], out[:, :-1]], 1)
        hp_flat = h_prev.reshape(-1, hidden)
        dhp_flat = torch.cat([d_xp[..., : 2 * hidden], d_xp[..., 2 * hidden:] * saved[..., :hidden]], -1)
        dhp_flat = dhp_flat.reshape(-1, 3 * hidden)
        library_ms = cuda_ms(lambda: torch.matmul(hp_flat.T, dhp_flat), iters)
        want64 = hp_flat.double().T @ dhp_flat.double()
        n = rows * steps
        chosen = cuda_gru.dw_splits(n, hidden, num_sms)
        plans = [chosen]
        slabs = 3 * hidden // 192
        for blocks_per_sm in (1, 2, 4):
            splits = num_sms * blocks_per_sm // slabs
            per_split = -(-n // (splits * 32)) * 32
            plan = (-(-n // per_split), per_split)
            if plan not in plans:
                plans.append(plan)
        for plan in plans:
            def run():
                return cuda_gru._launch_dw(out, h0, d_xp, saved, reverse, plan=plan)

            part = run()
            dwh, dbh = cuda_gru.dw_sum(part, hidden)
            torch.cuda.synchronize()
            err = max(max_rel(dwh, want_dwh), max_rel(dbh, want_dbh))
            print(json.dumps({
                "kernel": "gru_dw_partial", "shape": name, "rows": rows, "T": steps, "H": hidden,
                "tensor_cores": cuda_gru.last_dw_plan[0], "splits": plan[0], "per_split": plan[1],
                "chosen": plan == chosen, "max_rel_err": err,
                "max_rel_err_vs_float64": max_rel(dwh.double(), want64),
                "plain_rel_err_vs_float64": max_rel(want_dwh.double(), want64),
                "library_rel_err_vs_float64": max_rel(torch.matmul(hp_flat.T, dhp_flat).double(), want64),
                "ms": cuda_ms(run, iters), "dw_sum_ms": cuda_ms(lambda: cuda_gru.dw_sum(part, hidden), iters),
                "library_ms": library_ms}), flush=True)
            if not err <= DW_RTOL:
                failures.append(f"gru_dw_partial {name} {plan}: max rel err {err:.3e} > {DW_RTOL:.0e}")
    return failures


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", choices=("fwd", "dw"))
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, text in build.build_all().items():
        print(f"[build:{name}] {text.strip()}", flush=True)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(nvidia_smi_line(), flush=True)
    failures = []
    if args.only != "dw":
        failures += sweep_fwd(args.iters, num_sms)
    if args.only != "fwd":
        failures += sweep_dw(args.iters, num_sms)
    if failures:
        sys.exit("\n".join(failures))


if __name__ == "__main__":
    main()
