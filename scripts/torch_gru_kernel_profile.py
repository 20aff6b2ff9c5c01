"""Sweeps the launch plans of the port's `gru_fwd`, `gru_dw_partial`,
`gru_bwd` and `gru_dw_sum` kernels on the card, at the shapes the flagship
and large16k give them in serving (batch 1, a 4 s clip), in evaluation and
training at batch 64 of 2 s clips, and (`gru_bwd`, `gru_dw_sum`) in training
at batch 8.

    python scripts/torch_gru_kernel_profile.py [--only fwd|dw|bwd] [--iters 20]

For every shape and every plan (path and rows per tile for `gru_fwd` and
`gru_bwd`, so every instantiation the library builds is launched; splits
for `gru_dw_partial`; words and lanes a block for `gru_dw_sum`) it prints
one JSON line: the error against the plain PyTorch version on the same
inputs, the errors of both against the plain version in float64, the
kernel's time by CUDA events and (`gru_fwd`, `gru_bwd`, `gru_dw_sum`) its
device time under torch.profiler, which leaves the host's launch cost out,
and the time of the PyTorch call that computes the same function
(torch.nn.GRU and its backward, torch.matmul on operands made beforehand,
torch.sum). `gru_dw_sum` also says whether two calls gave the same bits.
The plan that `fwd_plan` / `dw_splits` / `bwd_plan` / `sum_plan` choose is
marked "chosen". The build log (ptxas registers and spills) comes first.
Fails if any plan misses chip_smoke.py's tolerance against the plain
version (KERNEL_ATOL, DW_RTOL) or `gru_dw_sum` differs between two calls.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (DW_RTOL, KERNEL_ATOL, cuda_ms, device_ms, gru_inputs, max_abs,  # noqa: E402
                        max_rel, nvidia_smi_line, randn, torch_gru_same_function, torch_gru_train_calls)
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
# the training shapes, and the same at batch 8 of 2 s clips
BWD_SHAPES = DW_SHAPES + [
    ("train8_fgru_fwd", 2008, 16, 64, False),
    ("train8_tgru", 128, 251, 128, False),
]


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


def sweep_bwd(iters: int, num_sms: int) -> list[str]:
    """Every instantiation of `gru_bwd` (the general kernel at its
    rows_per_block, the resident one at every rows per tile built), then
    `gru_dw_sum` over the partials of the same shape at several plans."""
    device = torch.device("cuda")
    failures = []
    for seed, (name, rows, steps, hidden, reverse) in enumerate(BWD_SHAPES):
        x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, 10 + seed, device)
        g = randn((rows, steps, hidden), 110 + seed, device)
        g_hT = randn((rows, hidden), 210 + seed, device)
        out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
        bwd_args = (g, g_hT, out, saved, h0, wh)
        want = gru_ops.gru_recurrence_bwd(*bwd_args, reverse=reverse)
        want64 = gru_ops.gru_recurrence_bwd(*(a.double() for a in bwd_args), reverse=reverse)
        plain_err64 = max(max_abs(want[i].double(), want64[i]) for i in (0, 3))
        library_ms = device_ms(torch_gru_train_calls(x_proj, h0, wh, bh, reverse, g, g_hT, out)[1], iters=iters)
        chosen = cuda_gru.bwd_plan(rows, steps, hidden, num_sms)
        plans = [cuda_gru.BwdPlan("general", cuda_gru.rows_per_block(rows, hidden, num_sms))]
        plans += [cuda_gru.BwdPlan("registers", r) for r in cuda_gru._BWD_RESIDENT[hidden][1]]
        for plan in plans:
            def run():
                return cuda_gru._launch_bwd(*bwd_args, reverse, plan=plan)

            d_xp, dh0 = run()
            torch.cuda.synchronize()
            err = max(max_abs(d_xp, want[0]), max_abs(dh0, want[3]))
            print(json.dumps({
                "kernel": "gru_bwd", "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
                **plan._asdict(), "chosen": plan == chosen, "max_abs_err": err,
                "max_abs_err_vs_float64": max(max_abs(d_xp.double(), want64[0]), max_abs(dh0.double(), want64[3])),
                "plain_abs_err_vs_float64": plain_err64,
                "device_ms": device_ms(run, "gru_bwd", iters), "ms": cuda_ms(run, iters),
                "library_device_ms": library_ms}), flush=True)
            if not err <= KERNEL_ATOL:
                failures.append(f"gru_bwd {name} {plan}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")

        part = cuda_gru.dw_partial(out, h0, want[0], saved, reverse=reverse)
        splits, size = part.shape
        sum_want, sum_want64 = part.sum(dim=0), part.double().sum(dim=0)
        library_ms = device_ms(lambda: torch.sum(part, dim=0), iters=iters)
        chosen = cuda_gru.sum_plan(splits, size, num_sms)
        plans = [chosen] + [p for p in (cuda_gru.SumPlan(c, threads // c) for threads in (256, 128)
                                        for c in (8, 16, 32, 64, 128) if threads // c <= 32) if p != chosen]
        for plan in plans:
            def run():
                return cuda_gru._launch_sum(part, hidden, plan=plan)

            first, second = (torch.cat([dwh.reshape(-1), dbh]) for dwh, dbh in (run(), run()))
            torch.cuda.synchronize()
            err = max_rel(first, sum_want)
            same = bool(torch.equal(first, second))
            print(json.dumps({
                "kernel": "gru_dw_sum", "shape": name, "H": hidden, "splits": splits, "size": size,
                **plan._asdict(), "chosen": plan == chosen, "max_rel_err": err,
                "max_rel_err_vs_float64": max_rel(first.double(), sum_want64),
                "plain_rel_err_vs_float64": max_rel(sum_want.double(), sum_want64), "bit_identical": same,
                "device_ms": device_ms(run, "gru_dw_sum", iters), "ms": cuda_ms(run, iters),
                "library_device_ms": library_ms, "library_ms": cuda_ms(lambda: torch.sum(part, dim=0), iters)}),
                flush=True)
            if not err <= DW_RTOL or not same:
                failures.append(f"gru_dw_sum {name} {plan}: max rel err {err:.3e}, bit-identical {same}")
    return failures


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", choices=("fwd", "dw", "bwd"))
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
    if args.only in (None, "fwd"):
        failures += sweep_fwd(args.iters, num_sms)
    if args.only in (None, "dw"):
        failures += sweep_dw(args.iters, num_sms)
    if args.only in (None, "bwd"):
        failures += sweep_bwd(args.iters, num_sms)
    if failures:
        sys.exit("\n".join(failures))


if __name__ == "__main__":
    main()
