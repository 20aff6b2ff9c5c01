"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. build every CUDA source of the port (`tinyrecurrentunet_torch/ops/csrc`);
2. hold the GRU recurrence kernel against its plain PyTorch version on the
   card at the flagship's three launch shapes (FGRU forward and reverse,
   TGRU), the three of large16k and one ragged shape per path of the kernel
   (registers, cluster, general), check that each shape ran on the path its
   name says, and time it beside the plain version, its bound and
   torch.nn.GRU (cuDNN, a yardstick the port never calls); the same at the
   streaming path's launch shapes (one hop of the flagship, 4 hops a call,
   64 streams a call, one hop of large16k), with device times under
   torch.profiler;
3. drive the serving path: the offline `Denoiser` with config/proc16k.json
   and artifacts/TRUNet-proc/pretrained.npz on a seeded 4 s clip, with the
   launch counts set to 0 just before and read just after; check the output
   against the same Denoiser on the CPU, then time warm calls;
4. hold the training kernels (forward with residuals, BPTT, the two
   weight-gradient reduction kernels) against their plain versions at the
   flagship training step's three launch shapes (batch 64 of 2 s clips),
   and time each, by device time under torch.profiler (in turns with the
   PyTorch call, the lower of two readings; a reading that lost kernel
   records is taken again) and by CUDA events around the call, beside its
   plain version, its bound and a PyTorch call computing the same function
   (torch.nn.GRU forward and backward, a matmul, a sum); check that the
   forward and the BPTT ran on their resident paths there (timing the
   general kernels beside them) and that two sums of the same partials give
   the same bits; hold the forward (out, h_T and saved each) and the BPTT
   at one small ragged shape per path and direction, and the forward at
   large16k's two training launch shapes (batch 16), timed beside the
   general kernel;
5. drive the training path: the port's `train()` on config/proc16k.json in
   float32 (train_compute_dtype cleared, nothing else changed), batch 64 of
   2 s synthetic clips, 5 steps, with the launch counts set to 0 just before
   and read just after; check the losses, gradient norms and weights are
   finite; one step at batch 4 on the card against the same step on the CPU,
   each against a float64 step on its own input features; the steady-state
   step time;
6. drive the streaming path: `StreamingDenoiser` streams the same 4 s clip
   at one hop a call, with the launch counts set to 0 just before and read
   just after (3 gru_fwd a hop, nothing else); check it against the same
   streaming on the CPU and, at the 3-hop shift, against the card's offline
   Denoiser.run; log per-hop latency at 1 and 4 hops a call (median, p99,
   max, deadline misses against the hop, RTF, kernels a hop, the device's
   idle share), `MultiStreamDenoiser` at 1, 16, 64 and 256 streams (3 of 64
   streams checked against their single runs), a 10 s soak through the
   native stream host (built from cpp/ into build/trunet_host/) and one
   `stream_file` run.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W, dense): HBM bytes/s; FLOP/s in
# float32 outside the tensor cores, in TF32 and in bf16 on them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

# Kernel vs plain version, both float32 on the card: dot products of length
# H summed in another order (~H * 2^-24 relative per step), carried through
# up to ~500 steps of a contracting recurrence.
KERNEL_ATOL = 1e-4
# Denoiser on the card vs on the CPU: cuFFT and the CPU FFT differ in the
# last bit, which moves the float32 rounding of the ~1e3 rad unwrapped phase
# behind the demod features (~1e-4 on a few bins); the waveform stays well
# inside this bound (CPU port vs JAX measured 4.2e-5 on a 4 s clip).
DENOISE_ATOL = 2e-4
# Weight gradients, kernel vs plain version: sums over rows * T = 257,024
# row-steps taken in another order (per split, then over the splits) and, at
# H 64 and 128, as TF32 products with bf16 correction terms on the tensor
# cores (measured 4e-6 to 9e-6), so the error is held relative to the
# largest entry, max|a - b| / max|b|.
DW_RTOL = 1e-4
# One train step at batch 4 from the same weights and batch, on the card and
# on the CPU. The float32 gradient of this network is ill-conditioned
# (train-mode BatchNorm divides by batch standard deviations, the
# log-magnitude loss by bin magnitudes), and most of it comes from the
# rounding of the input features: cuFFT and the CPU's FFT round the noisy
# spectrogram differently, and the unwrapped phase carries that to ~1e-4 on
# some features. Each run is therefore held against a float64 step on the
# CPU that reads that run's own float32 input features
# (`signal.features.Float32Features`): what is left is the float32
# arithmetic of the network and the loss, 9.0e-4 relative L2 of all
# gradients on the CPU and 5.5-5.8e-4 on the card (NVIDIA H100 80GB HBM3,
# 700 W), while the two references lie 3.8e-2 apart (this script, phase 5).
# With a CPU-only PyTorch the same step is 9.9e-4 from its reference,
# 1.1e-2 from a float64 step on float64 features, and the JAX package's
# float32 step 9.2e-3 (tests/torch_step_conditioning.py). The card may be
# STEP_VS_F64 times as far from its reference as the CPU is from its own,
# or within the floors: about 3x the card's reading.
STEP_VS_F64 = 2.0
STEP_GRAD_FLOOR = 1e-3  # relative L2 of all gradients; measured 5.5-5.8e-4
STEP_NORM_FLOOR = 3e-5  # relative, grad_norm; measured 4.3-8.7e-6 (CPU 1.07e-5)
STEP_LOSS_RTOL = 1e-4  # each loss term, card vs CPU: the loss is well conditioned
STEP_STATS_ATOL = 1e-4  # BatchNorm running statistics after the step, card vs CPU
# Parameters after the AdamW step, card vs CPU. The first Adam step of an
# entry is lr(0) g / (|g| + 1e-8) plus weight decay: where both runs'
# gradients are at least ADAM_SIGN_TAU and of one sign, both steps are
# lr(0) sign(g) to 1e-3 lr(0), so PARAM_ATOL holds (float32 weights round at
# ~6e-8). Elsewhere a near-zero gradient steps by +-lr(0) with either sign:
# 2 lr(0). That is at most 1 - PARAM_EXACT_SHARE of the entries: 9.6% of
# them have a gradient below 1e-5 (tests/torch_step_conditioning.py), and
# 12.4% were below it in either run or of two signs in this script's
# reading (parameters elsewhere within 6.0e-8).
ADAM_SIGN_TAU = 1e-5
PARAM_ATOL = 1e-6
PARAM_EXACT_SHARE = 0.8
TRAIN_BATCH = 64
TRAIN_STEPS = 5
PROFILE_PAD_S = 0.01  # idle time at each end of a torch.profiler window (device_ms)
# Streaming (phase 6), card against CPU on the 4 s clip: as DENOISE_ATOL, the
# FFTs' last bit carried by the unwrapped phase. N streams against single
# streams on the card: cuDNN may take another convolution algorithm at
# another batch size; held to the same bound, the error is logged.
STREAM_ATOL = DENOISE_ATOL
# The 3-hop alignment of the streaming output with the offline output.
# The stream starts from zeros where the offline STFT reflects the clip, and
# with the trained flagship that start decays slowly (the TGRU's memory; the
# JAX package streams the same output, tests/test_torch_streaming.py). The
# relative RMS error by shift is logged from block 60 (the window of the
# JAX package's test, with random weights) and from ALIGN_FROM, and held
# from ALIGN_FROM: the 3-hop shift within ALIGN_RMS (measured 0.130), every
# other shift of 0-6 hops at least ALIGN_MARGIN times as far (measured
# >= 1.248).
ALIGN_FROM = 300
ALIGN_RMS = 0.25
ALIGN_MARGIN = 4.0
STREAM_COUNTS = (1, 16, 64, 256)  # multi-stream batch sizes timed
SOAK_SECONDS = 10.0

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "config", "proc16k.json")
ARTIFACT = os.path.join(REPO, "artifacts", "TRUNet-proc")
SAMPLE_RATE = 16000
CLIP_SECONDS = 4.0


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str | None = None, iters: int = 10, launches: int | None = None) -> float:
    """Mean device time in ms of the kernels whose name contains `name`
    (default: every kernel) over `iters` calls of fn(), from torch.profiler:
    the host's launch cost is left out, which CUDA events around a kernel of
    a few microseconds would measure instead.

    A reading counts the kernel records it matched and holds only if they
    are `iters` times the kernels one call launches (`launches`; by default
    as many as a profiled single call of fn() gives, read beside it): the
    profiler has been seen to return fewer records than were launched (1 to
    7 of 20 missing, three readings in a row, on one machine), and such a
    reading would be low. It is taken again, up to three times in all, and
    then this raises. The window is padded with PROFILE_PAD_S of idle time
    at each end, in case records near its edges are what goes missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def read(calls: int) -> tuple[int, float]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and (name is None or name in e.key)]
        return sum(e.count for e in events), sum(e.device_time_total for e in events)

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(3):
        per_call = launches if launches is not None else read(1)[0]
        count, total = read(iters)
        readings.append((per_call, count))
        if per_call > 0 and count == iters * per_call:
            return total / iters / 1e3
        log(f"[device_ms] {name or 'any kernel'}: {count} kernel records of {iters} x {per_call}, taken again")
    raise AssertionError(f"torch.profiler: kernel records of {name or 'any kernel'} over {iters} calls "
                         f"(per call, counted) {readings}, never {iters} x the kernels of one call")


def make_clip(seed: int = 0) -> np.ndarray:
    """A few harmonic tones plus white noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(CLIP_SECONDS * SAMPLE_RATE)) / SAMPLE_RATE
    clip = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 220.0), (0.2, 660.0), (0.1, 1500.0)))
    clip = clip + 0.1 * rng.standard_normal(t.shape)
    return clip.astype(np.float32)


def gru_inputs(rows: int, steps: int, hidden: int, seed: int, device):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(hidden)
    arrays = (
        rng.standard_normal((rows, steps, 3 * hidden)) * 0.5,
        rng.standard_normal((rows, hidden)) * 0.1,
        rng.uniform(-k, k, (hidden, 3 * hidden)),
        rng.uniform(-k, k, (3 * hidden,)),
    )
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def gru_bound(rows: int, steps: int, hidden: int) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, FLOPs) of one recurrence call: each
    input read once and each output written once; 2*H*3H FLOPs for h @ Wh
    and ~12 H for biases and gates per row and step."""
    g = 3 * hidden
    nbytes = 4 * (rows * steps * g + rows * hidden + hidden * g + g + rows * steps * hidden + rows * hidden)
    flops = rows * steps * (2 * hidden * g + 12 * hidden)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes, flops
    return t_ops * 1e3, "operations", nbytes, flops


def bound(nbytes: float, flops: float, tensor_cores: bool = False) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the HBM rate or the operations
    over the peak rate of their type, whichever is larger. The type is
    float32 outside the tensor cores, or, for a kernel that runs its product
    on them as `gru_dw_partial` does, one TF32 and two bf16 instructions per
    product, each at its own peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_TF32_FLOPS + 2 * flops / PEAK_BF16_FLOPS if tensor_cores else flops / PEAK_F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def train_kernel_work(kernel: str, rows: int, steps: int, hidden: int, splits: int):
    """(bytes, FLOPs) of one launch of a training kernel: each input read
    once, each output written once. Per row and step: the forward does
    h @ Wh (2 H 3H) and ~12 H of gates; the BPTT d_hp @ Wh^T (2 3H H) and
    ~20 H; the reduction h_prev^T d_hp (2 H 3H) and 4 H for dbh and dn r."""
    n, g = rows * steps, 3 * hidden
    dw = g * (hidden + 1)
    work = {
        "gru_fwd_train": (4 * (n * g + rows * hidden + hidden * g + g + n * hidden + rows * hidden
                               + n * 4 * hidden), n * (2 * hidden * g + 12 * hidden)),
        # g, g_hT, out (as h_prev), saved, h0, Wh in; d_xp, dh0 out
        "gru_bwd": (4 * (n * hidden + rows * hidden + n * hidden + n * 4 * hidden + rows * hidden
                         + hidden * g + n * g + rows * hidden), n * (2 * g * hidden + 20 * hidden)),
        # out (as h_prev), h0, d_xp, r of saved in; the partials out
        "gru_dw_partial": (4 * (n * hidden + rows * hidden + n * g + n * hidden + splits * dw),
                           n * (2 * hidden * g + 4 * hidden)),
        "gru_dw_sum": (4 * (splits * dw + dw), splits * dw),
    }
    return work[kernel]


def torch_gru_module(wh, bh) -> torch.nn.GRU:
    """torch.nn.GRU computing the recurrence over x_proj: identity input
    weights and zero input bias turn its input projection into x_proj."""
    g = wh.shape[-1]
    gru = torch.nn.GRU(g, g // 3, batch_first=True).to(wh.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(g))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(wh.T)
        gru.bias_hh_l0.copy_(bh)
    return gru


def torch_gru_same_function(x_proj, h0, wh, bh, reverse):
    """A call of torch.nn.GRU computing the same recurrence."""
    gru = torch_gru_module(wh, bh)
    xs = x_proj.flip(1) if reverse else x_proj

    def call():
        return gru(xs, h0[None])

    return call


def check_kernel(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 2 at one launch shape, which must run on `path` of gru_fwd."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    out_k, hT_k = cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    plan = cuda_gru.last_fwd_plan
    out_p, hT_p = gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    err = max((out_k - out_p).abs().max().item(), (hT_k - hT_p).abs().max().item())
    finite = bool(torch.isfinite(out_k).all() and torch.isfinite(hT_k).all())

    lib_call = torch_gru_same_function(x_proj, h0, wh, bh, reverse)
    with torch.no_grad():
        out_l, hT_l = lib_call()
    if reverse:
        out_l = out_l.flip(1)
    lib_err = max((out_l - out_p).abs().max().item(), (hT_l[0] - hT_p).abs().max().item())

    kernel_ms = cuda_ms(lambda: cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse), 20)
    plain_ms = cuda_ms(lambda: gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse), 3, 1)
    with torch.no_grad():
        library_ms = cuda_ms(lib_call, 20)
    bound_ms, bound_by, nbytes, flops = gru_bound(rows, steps, hidden)
    row = {
        "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
        "path": plan.path, "rows_per_tile": plan.rows_per_tile,
        "max_abs_err": err, "library_max_abs_err": lib_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }
    log(f"[kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_fwd {name}: ran on the {plan.path} path, expected {path}")
    if not finite:
        raise AssertionError(f"gru_fwd {name}: non-finite output")
    if err > KERNEL_ATOL:
        raise AssertionError(f"gru_fwd {name}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def check_streaming_kernel(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 2 at a launch shape of the streaming path: `check_kernel`, then
    device times under torch.profiler of the kernel, of torch.nn.GRU and of
    the plain version (a matmul and the gates a step). At T = 1 the event
    time around a call is the host's launch."""
    row = check_kernel(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops)
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, torch.device("cuda"))
    library = torch_gru_same_function(x_proj, h0, wh, bh, reverse)
    with torch.no_grad():
        row["device_ms"] = device_ms(lambda: cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse),
                                     iters=20, launches=1)
        row["library_device_ms"] = device_ms(library, iters=20)
        row["plain_device_ms"] = device_ms(
            lambda: gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse), iters=5)
    log(f"[stream-kernel] {json.dumps(row)}")
    return row


def randn(shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_abs(a, b) / max(b.abs().max().item(), 1e-30)


def torch_gru_train_calls(x_proj, h0, wh, bh, reverse, g, g_hT, want_out):
    """(forward call, backward call, max abs error of its outputs) of
    torch.nn.GRU computing the same recurrence in training: cuDNN's training
    forward and its backward for upstream (g, g_hT). A yardstick the port
    never calls."""
    gru = torch_gru_module(wh, bh)
    xs = (x_proj.flip(1) if reverse else x_proj).detach().requires_grad_()
    h0l = h0[None].detach().requires_grad_()
    out_l, h_l = gru(xs, h0l)
    err = max_abs(out_l.flip(1) if reverse else out_l, want_out)
    grads = (g.flip(1) if reverse else g, g_hT[None])
    inputs = [xs, h0l, gru.weight_hh_l0, gru.bias_hh_l0]
    return (lambda: gru(xs, h0l),
            lambda: torch.autograd.grad((out_l, h_l), inputs, grads, retain_graph=True), err)


def fwd_train_errors(got, want) -> dict[str, float]:
    """Max abs error of each output of the training forward: out, h_T, saved."""
    return {k: max_abs(a, b) for k, a, b in zip(("out", "h_T", "saved"), got, want)}


def check_train_kernels(name, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 4 at one launch shape: each training kernel against its plain
    version on the same inputs, then timed: device time under torch.profiler
    ("ms") and CUDA events around the wrapper's call ("call_ms"), the same
    two for the PyTorch call, and for `gru_fwd_train` and `gru_bwd` the
    device time of the general kernel, which the shape does not take.
    Returns one row per kernel."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    g = randn((rows, steps, hidden), seed + 100, device)
    g_hT = randn((rows, hidden), seed + 200, device)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count

    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    fwd_plan = cuda_gru.last_fwd_train_plan
    fwd_general = cuda_gru.FwdPlan("general", cuda_gru.rows_per_block(rows, hidden, num_sms))
    fwd_general_got = cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, reverse, plan=fwd_general)
    want = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    out, _, saved = want
    bwd_args = (g, g_hT, out, saved, h0, wh)
    d_xp, dh0 = cuda_gru.bptt(*bwd_args, reverse=reverse)
    bwd_plan = cuda_gru.last_bwd_plan
    general = cuda_gru.BwdPlan("general", cuda_gru.rows_per_block(rows, hidden, num_sms))
    gd_xp, gdh0 = cuda_gru._launch_bwd(*bwd_args, reverse, plan=general)
    p_dxp, p_dwh, p_dbh, p_dh0 = gru_ops.gru_recurrence_bwd(*bwd_args, reverse=reverse)
    part = cuda_gru.dw_partial(out, h0, p_dxp, saved, reverse=reverse)
    dw_plan = cuda_gru.last_dw_plan
    dwh, dbh = cuda_gru.dw_sum(part, hidden)
    sum_plan = cuda_gru.last_sum_plan
    dw_again = torch.cat([t.reshape(-1) for t in cuda_gru.dw_sum(part, hidden)])
    dw_sum_want = part.sum(dim=0)
    torch.cuda.synchronize()
    dw_got = torch.cat([dwh.reshape(-1), dbh])
    fwd_errors = fwd_train_errors(got, want)
    fwd_general_errors = fwd_train_errors(fwd_general_got, want)
    errors = {
        "gru_fwd_train": max(fwd_errors.values()),
        "gru_bwd": max(max_abs(d_xp, p_dxp), max_abs(dh0, p_dh0)),
        "gru_dw_partial": max(max_abs(dwh, p_dwh), max_abs(dbh, p_dbh)),
        "gru_dw_sum": max_abs(dw_got, dw_sum_want),
    }
    general_err = max(max_abs(gd_xp, p_dxp), max_abs(gdh0, p_dh0))
    fwd_general_err = max(fwd_general_errors.values())
    rel = {
        "gru_dw_partial": max(max_rel(dwh, p_dwh), max_rel(dbh, p_dbh)),
        "gru_dw_sum": max_rel(dw_got, dw_sum_want),
    }
    finite = all(bool(torch.isfinite(t).all()) for t in (*got, d_xp, dh0, dwh, dbh))

    fwd_lib, bwd_lib, lib_err = torch_gru_train_calls(x_proj, h0, wh, bh, reverse, g, g_hT, out)
    hidden_prev = torch.cat([out[:, 1:], h0[:, None]], 1) if reverse else torch.cat([h0[:, None], out[:, :-1]], 1)
    hp_flat = hidden_prev.reshape(-1, hidden)
    dhp_flat = torch.cat([p_dxp[..., : 2 * hidden], p_dxp[..., 2 * hidden :] * saved[..., :hidden]], -1)
    dhp_flat = dhp_flat.reshape(-1, 3 * hidden)
    timing = {
        "gru_fwd_train": (
            lambda: cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse),
            lambda: gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse),
            fwd_lib,
        ),
        "gru_bwd": (
            lambda: cuda_gru.bptt(*bwd_args, reverse=reverse),
            lambda: gru_ops.gru_recurrence_bwd(*bwd_args, reverse=reverse),
            bwd_lib,
        ),
        "gru_dw_partial": (
            lambda: cuda_gru.dw_partial(out, h0, p_dxp, saved, reverse=reverse),
            lambda: gru_ops.gru_weight_grads(out, h0, p_dxp, saved, reverse),
            lambda: torch.matmul(hp_flat.T, dhp_flat),
        ),
        "gru_dw_sum": (
            lambda: cuda_gru.dw_sum(part, hidden),
            lambda: part.sum(dim=0),
            lambda: torch.sum(part, dim=0),
        ),
    }
    # the general kernels, which these shapes do not take
    generals = {
        "gru_fwd_train": lambda: cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, reverse, plan=fwd_general),
        "gru_bwd": lambda: cuda_gru._launch_bwd(*bwd_args, reverse, plan=general),
    }
    rows_out = []
    for kernel, (run, plain, library) in timing.items():
        nbytes, flops = train_kernel_work(kernel, rows, steps, hidden, part.shape[0])
        bound_ms, bound_by = bound(nbytes, flops, tensor_cores=kernel == "gru_dw_partial" and dw_plan[0])
        # kernel, PyTorch call (and general kernel) in turns, the lower of two readings each
        turns = [(device_ms(run, launches=1), device_ms(library),
                  device_ms(generals[kernel], launches=1) if kernel in generals else None) for _ in range(2)]
        kernel_ms, library_ms, general_ms = zip(*turns)
        row = {
            "kernel": kernel, "shape": name, "rows": rows, "T": steps, "H": hidden,
            "reverse": reverse, "max_abs_err": errors[kernel], "max_rel_err": rel.get(kernel),
            "ms": min(kernel_ms), "call_ms": cuda_ms(run, 10), "plain_ms": cuda_ms(plain, 2, 1),
            "library_ms": min(library_ms), "library_call_ms": cuda_ms(library, 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        }
        if kernel in generals:
            row["general_ms"] = min(general_ms)
        if kernel == "gru_fwd_train":
            row["library_max_abs_err"] = lib_err
            row["path"], row["rows_per_tile"] = fwd_plan
            row["max_abs_err_by_output"] = fwd_errors
            row["general_rows_per_block"], row["general_max_abs_err"] = fwd_general.rows_per_tile, fwd_general_err
        if kernel == "gru_bwd":
            row["path"], row["rows_per_tile"] = bwd_plan
            row["general_rows_per_block"], row["general_max_abs_err"] = general.rows_per_tile, general_err
        if kernel == "gru_dw_partial":
            row["path"] = "tensor_cores" if dw_plan[0] else "simt"
            row["splits"], row["steps_per_split"] = dw_plan[1:]
        if kernel == "gru_dw_sum":
            row["cols"], row["groups"] = sum_plan
            row["bit_identical"] = bool(torch.equal(dw_got, dw_again))
        log(f"[train-kernel] {json.dumps(row)}")
        rows_out.append(row)
    if not finite:
        raise AssertionError(f"training kernels {name}: non-finite output")
    for kernel, plan in (("gru_fwd_train", fwd_plan), ("gru_bwd", bwd_plan)):
        if plan.path != "registers":
            raise AssertionError(f"{kernel} {name}: ran on the {plan.path} path, expected registers")
    for kernel, err in (("gru_fwd_train", errors["gru_fwd_train"]), ("gru_fwd_train general", fwd_general_err),
                        ("gru_bwd", errors["gru_bwd"]), ("gru_bwd general", general_err)):
        if err > KERNEL_ATOL:
            raise AssertionError(f"{kernel} {name}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    for kernel, value in rel.items():
        if value > DW_RTOL:
            raise AssertionError(f"{kernel} {name}: max rel err {value:.3e} > {DW_RTOL:.0e}")
    if not torch.equal(dw_got, dw_again):
        raise AssertionError(f"gru_dw_sum {name}: two calls on the same partials differ")
    return rows_out


def check_fwd_train_shape(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 4 at a small ragged shape: `gru_fwd_train` against its plain
    version, out, h_T and saved each on its own, on `path`."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    plan = cuda_gru.last_fwd_train_plan
    errs = fwd_train_errors(got, gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse))
    torch.cuda.synchronize()
    row = {"kernel": "gru_fwd_train", "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
           "path": plan.path, "rows_per_tile": plan.rows_per_tile, "max_abs_err": max(errs.values()),
           "max_abs_err_by_output": errs}
    log(f"[train-kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_fwd_train {name}: ran on the {plan.path} path, expected {path}")
    if rows % plan.rows_per_tile == 0 or steps % 2 == 0:
        raise AssertionError(f"gru_fwd_train {name} is not ragged: {row}")
    for what, err in errs.items():
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"gru_fwd_train {name}: {what} max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def check_fwd_train_large(name, path, rows, steps, hidden, seed, cuda_gru, gru_ops):
    """Phase 4 at a launch shape of large16k's training: `gru_fwd_train` on
    `path` against its plain version, timed by device time in turns with the
    general kernel and torch.nn.GRU's training forward."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh)
    plan = cuda_gru.last_fwd_train_plan
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    general = cuda_gru.FwdPlan("general", cuda_gru.rows_per_block(rows, hidden, num_sms))
    general_got = cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, False, plan=general)
    want = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh)
    errs, general_errs = fwd_train_errors(got, want), fwd_train_errors(general_got, want)
    fwd_lib, _, lib_err = torch_gru_train_calls(x_proj, h0, wh, bh, False, want[0], want[1], want[0])

    def run():
        return cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh)

    turns = [(device_ms(run, launches=1), device_ms(fwd_lib),
              device_ms(lambda: cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, False, plan=general), launches=1))
             for _ in range(2)]
    kernel_ms, library_ms, general_ms = (min(t) for t in zip(*turns))
    nbytes, flops = train_kernel_work("gru_fwd_train", rows, steps, hidden, 0)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"kernel": "gru_fwd_train", "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": False,
           "path": plan.path, "rows_per_tile": plan.rows_per_tile, "max_abs_err": max(errs.values()),
           "max_abs_err_by_output": errs, "ms": kernel_ms, "call_ms": cuda_ms(run, 5),
           "plain_ms": cuda_ms(lambda: gru_ops.gru_recurrence_train(x_proj, h0, wh, bh), 2, 1),
           "library_ms": library_ms, "library_max_abs_err": lib_err, "general_ms": general_ms,
           "general_rows_per_block": general.rows_per_tile, "general_max_abs_err": max(general_errs.values()),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
    log(f"[train-kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_fwd_train {name}: ran on the {plan.path} path, expected {path}")
    for what, err in (*errs.items(), *(("general " + k, v) for k, v in general_errs.items())):
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"gru_fwd_train {name}: {what} max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def check_bwd_shape(name, path, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    """Phase 4 at a small ragged shape: `gru_bwd` against its plain version,
    on `path`."""
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    g = randn((rows, steps, hidden), seed + 100, device)
    g_hT = randn((rows, hidden), seed + 200, device)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    d_xp, dh0 = cuda_gru.bptt(g, g_hT, out, saved, h0, wh, reverse=reverse)
    plan = cuda_gru.last_bwd_plan
    p_dxp, _, _, p_dh0 = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.cuda.synchronize()
    err = max(max_abs(d_xp, p_dxp), max_abs(dh0, p_dh0))
    row = {"kernel": "gru_bwd", "shape": name, "rows": rows, "T": steps, "H": hidden, "reverse": reverse,
           "path": plan.path, "rows_per_tile": plan.rows_per_tile, "max_abs_err": err}
    log(f"[train-kernel] {json.dumps(row)}")
    if plan.path != path:
        raise AssertionError(f"gru_bwd {name}: ran on the {plan.path} path, expected {path}")
    if rows % plan.rows_per_tile == 0 or steps % 2 == 0:
        raise AssertionError(f"gru_bwd {name} is not ragged: {row}")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"gru_bwd {name}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


def float32_training(cfg):
    """proc16k with train_compute_dtype cleared: the port trains in float32."""
    opt = dataclasses.replace(cfg.train.optimization, train_compute_dtype="")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))


def batch_of(dataset, count: int, device):
    items = [dataset.get(i) for i in range(count)]
    return [torch.from_numpy(np.stack([x[k] for x in items])).to(device) for k in (0, 1)]


def compare_train_step(cfg, dataset):
    """One step at batch 4 from the same weights and batch: on the card and
    on the CPU in float32, and for each a float64 step on the CPU that reads
    its float32 input features, the reference."""
    from tinyrecurrentunet_torch.signal import Featurizer
    from tinyrecurrentunet_torch.signal.features import Float32Features
    from tinyrecurrentunet_torch.train.schedule import linear_warmup_cosine_decay
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    opt = dataclasses.replace(cfg.train.optimization, batch_size_per_device=4)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))
    runs = {}
    for name, device, dtype, features_on in (
        ("card", "cuda", torch.float32, None), ("cpu", "cpu", torch.float32, None),
        ("card_f64", "cpu", torch.float64, "cuda"), ("cpu_f64", "cpu", torch.float64, "cpu"),
    ):
        state = create_train_state(cfg, device=device)
        state.model.to(dtype)
        clean, noisy = (t.to(dtype) for t in batch_of(dataset, 4, device))
        featurizer = Float32Features(Featurizer(cfg.featurizer), features_on) if features_on else None
        t0 = time.perf_counter()
        state, metrics = make_train_step(cfg, featurizer=featurizer)(state, clean, noisy)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": torch.cat([p.grad.reshape(-1).double().cpu() for p in state.model.parameters()]),
            "params": torch.cat([p.detach().reshape(-1).double().cpu() for p in state.model.parameters()]),
            "stats": torch.cat([b.reshape(-1).double().cpu() for b in state.model.buffers()]),
            "s": time.perf_counter() - t0,
        }
    card, cpu = runs["card"], runs["cpu"]

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    def norm_err(run, ref):
        return abs(run["metrics"]["grad_norm"] - ref["metrics"]["grad_norm"]) / ref["metrics"]["grad_norm"]

    lr0 = linear_warmup_cosine_decay(opt.learning_rate, opt.n_iters, opt.lr_divider, opt.warmup_proportion)(0)
    exact = (torch.minimum(cpu["grads"].abs(), card["grads"].abs()) >= ADAM_SIGN_TAU) & (
        cpu["grads"].sign() == card["grads"].sign())
    param_err = (card["params"] - cpu["params"]).abs()
    report = {
        "loss_rel_err_card_vs_cpu": {k: abs(card["metrics"][k] - cpu["metrics"][k]) / abs(cpu["metrics"][k])
                                     for k in cpu["metrics"] if k != "grad_norm"},
        "grad_rel_l2_vs_f64": {"card": rel_l2(card["grads"], runs["card_f64"]["grads"]),
                               "cpu": rel_l2(cpu["grads"], runs["cpu_f64"]["grads"])},
        "grad_norm_rel_err_vs_f64": {"card": norm_err(card, runs["card_f64"]),
                                     "cpu": norm_err(cpu, runs["cpu_f64"])},
        "grad_rel_l2_card_vs_cpu": rel_l2(card["grads"], cpu["grads"]),
        "grad_rel_l2_f64_references": rel_l2(runs["card_f64"]["grads"], runs["cpu_f64"]["grads"]),
        "param_exact_share": exact.double().mean().item(),
        "param_max_abs_err_card_vs_cpu_exact": param_err[exact].max().item(),
        "param_max_abs_err_card_vs_cpu": param_err.max().item(), "lr0": lr0,
        "bn_stats_max_abs_err_card_vs_cpu": (card["stats"] - cpu["stats"]).abs().max().item(),
        "step_s": {k: r["s"] for k, r in runs.items()}, "loss": card["metrics"]["loss"],
        "grad_norm": card["metrics"]["grad_norm"],
    }
    log(f"[train-step batch 4: card, cpu, each against float64 on its own features] {json.dumps(report)}")
    for name, err in report["loss_rel_err_card_vs_cpu"].items():
        if not err <= STEP_LOSS_RTOL:
            raise AssertionError(f"train step card vs CPU: {name} rel err {err:.3e} > {STEP_LOSS_RTOL:.0e}")
    for what, floor in (("grad_rel_l2_vs_f64", STEP_GRAD_FLOOR), ("grad_norm_rel_err_vs_f64", STEP_NORM_FLOOR)):
        errs = report[what]
        if not errs["card"] <= max(STEP_VS_F64 * errs["cpu"], floor):
            raise AssertionError(f"train step: card {what} {errs['card']:.3e} against the CPU's {errs['cpu']:.3e}")
    if not report["param_exact_share"] >= PARAM_EXACT_SHARE:
        raise AssertionError(f"train step card vs CPU: gradients of one sign on {report['param_exact_share']:.3f}")
    if not report["param_max_abs_err_card_vs_cpu_exact"] <= PARAM_ATOL:
        raise AssertionError(f"train step card vs CPU: params {report['param_max_abs_err_card_vs_cpu_exact']:.3e}")
    if not report["param_max_abs_err_card_vs_cpu"] <= 2 * lr0 + PARAM_ATOL:
        raise AssertionError(f"train step card vs CPU: params {report['param_max_abs_err_card_vs_cpu']:.3e}")
    if not report["bn_stats_max_abs_err_card_vs_cpu"] <= STEP_STATS_ATOL:
        raise AssertionError(f"train step card vs CPU: BN stats {report['bn_stats_max_abs_err_card_vs_cpu']:.3e}")
    return report


def train_main_path(cfg, cuda_gru):
    """Phase 5: the port's train() for TRAIN_STEPS steps at the config's
    batch, launch counts around it; then the card-vs-CPU step and the
    steady-state step time."""
    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset
    from tinyrecurrentunet_torch.train.loop import train
    from tinyrecurrentunet_torch.train.step import make_train_step

    opt = cfg.train.optimization
    if opt.batch_size_per_device != TRAIN_BATCH or cfg.trainset.crop_length_sec != 2:
        raise AssertionError("proc16k trains on batches of 64 clips of 2 s")
    dataset = SyntheticPairDataset(num_items=2 * TRAIN_BATCH, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    # the config's log directory (./ckpt) resolves inside a scratch directory
    # of the build tree, so an earlier run's checkpoints are never resumed
    workdir = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    # PyTorch's default for cuDNN: train() must turn TF32 off itself
    torch.backends.cudnn.allow_tf32 = True
    try:
        cuda_gru.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = train(cfg, dataset=dataset, max_iters=TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = cuda_gru.launch_counts()
        with open(os.path.join(workdir, "ckpt", cfg.train.exp_path, "logs", "metrics.jsonl")) as f:
            first = json.loads(f.readline())
    finally:
        os.chdir(cwd)
    log(f"[train] {TRAIN_STEPS} steps through train(): {train_s:.2f} s, launches {counts}, "
        f"step 0 loss {first['Train/Train-Loss']:.6f} grad_norm {first['Train/Gradient-Norm']:.4f}, "
        f"step {TRAIN_STEPS - 1} loss {metrics['loss']:.6f} grad_norm {metrics['grad_norm']:.4f}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train() on the card left TF32 on")
    expected = {k: 3 * TRAIN_STEPS for k in counts}
    expected["gru_fwd"] = 0  # train mode never runs the inference kernel
    if counts != expected:
        raise AssertionError(f"launches in {TRAIN_STEPS} train steps: {counts}, expected {expected}")
    logged = [first["Train/Train-Loss"], first["Train/Gradient-Norm"], metrics["loss"], metrics["grad_norm"]]
    if not (np.isfinite(logged).all() and all(bool(torch.isfinite(p).all()) for p in state.model.parameters())):
        raise AssertionError(f"training produced non-finite values: {logged}")

    # steady state: further steps from the trained state on one batch
    step = make_train_step(cfg)
    clean, noisy = batch_of(dataset, TRAIN_BATCH, "cuda")
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, clean, noisy), 5, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(state, clean, noisy)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    audio_s = TRAIN_BATCH * cfg.trainset.crop_length_sec
    summary = {
        "main_path": "train() proc16k float32", "batch": TRAIN_BATCH, "clip_s": cfg.trainset.crop_length_sec,
        "steps": TRAIN_STEPS, "train_s": train_s, "step_ms_cuda_events": step_ms,
        "step_ms_host_clock": host_ms, "audio_s_per_s": audio_s / (step_ms / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
        "final_loss": metrics["loss"], "final_grad_norm": metrics["grad_norm"],
    }
    log(json.dumps(summary))
    summary["card_vs_cpu"] = compare_train_step(cfg, dataset)
    return summary, counts


def percentiles_ms(seconds) -> dict:
    lat = np.asarray(seconds) * 1e3
    return {"median_ms": float(np.median(lat)), "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max())}


def hop_profile(step, calls: int) -> dict:
    """Kernels, memory copies and device busy time a call of step(), over
    `calls` calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    return {
        "kernels": sum(e.count for e in kernels) / calls,
        "copies": sum(e.count for e in copies) / calls,
        "device_busy_ms": sum(e.device_time_total for e in events) / calls / 1e3,
        "gru_fwd_device_ms": sum(e.device_time_total for e in kernels if "gru_fwd" in e.key) / calls / 1e3,
    }


def stream_latency(den, audio: np.ndarray, budget_s: float) -> dict:
    """Per-call latency on the host clock of `den.process_block` over the
    whole of `audio`, numpy block in, numpy block out (synchronised: the
    copy back waits for the device), then the device's share of it."""
    hop = den.hop
    blocks = [audio[i : i + hop] for i in range(0, len(audio) - hop + 1, hop)]
    state = den.init_state()
    for block in blocks[:5]:
        state = den.process_block(state, block)[1]
    state = den.init_state()
    lat = []
    for block in blocks:
        t0 = time.perf_counter()
        out, state = den.process_block(state, block)
        out.cpu().numpy()
        lat.append(time.perf_counter() - t0)
    box = {"state": den.init_state()}

    def step():
        box["state"] = den.process_block(box["state"], blocks[0])[1]

    prof = hop_profile(step, 20)
    row = {"chunk_frames": den.chunk_frames, "calls": len(lat), "budget_ms": budget_s * 1e3,
           **percentiles_ms(lat), "deadline_misses": int(np.sum(np.asarray(lat) > budget_s)),
           "rtf": float(np.sum(lat)) / (len(lat) * budget_s), **prof}
    row["kernels_a_hop"] = prof["kernels"] / den.chunk_frames
    row["device_idle_share"] = 1.0 - prof["device_busy_ms"] / row["median_ms"]
    return row


def relative_rms(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def streaming_main_path(cfg, clip: np.ndarray, cuda_gru) -> dict:
    """Phase 6: the port's streaming path on the card with the flagship's
    weights. The 4 s clip streamed at one hop a call, with the launch counts
    set to 0 just before and read just after (3 gru_fwd a hop, no other
    kernel); held against the same streaming on the CPU and, at the 3-hop
    shift, against the card's offline Denoiser.run. Then logged: per-hop
    latency at 1 and 4 hops a call, the multi-stream call at STREAM_COUNTS
    streams (and 3 of 64 streams held against their single runs), a
    SOAK_SECONDS soak through the native host and one stream_file run."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.infer.soak import run_soak
    from tinyrecurrentunet_torch.infer.stream import stream_file
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser
    from tinyrecurrentunet_torch.runtime import native
    from tinyrecurrentunet_torch.weights import load_pretrained

    sd = load_pretrained(ARTIFACT, cfg)
    hop = cfg.featurizer.hop_length
    budget_s = hop / SAMPLE_RATE
    hops = len(clip) // hop
    den = StreamingDenoiser(cfg, sd, device="cuda")
    den.process(clip[: 8 * hop])  # warm: cuDNN's first calls, the kernels' first launch
    torch.cuda.synchronize()
    cuda_gru.reset_launch_counts()
    t0 = time.perf_counter()
    out, state = den.process(clip)
    wall = time.perf_counter() - t0
    counts = cuda_gru.launch_counts()
    log(f"[stream] launches streaming {hops} hops: {counts}")
    if counts != {**{k: 0 for k in counts}, "gru_fwd": 3 * hops}:
        raise AssertionError(f"expected {3 * hops} gru_fwd launches (3 a hop) and no other, got {counts}")
    if out.shape != clip.shape or not np.isfinite(out).all() or int(state.feat_state.frame_count) != hops:
        raise AssertionError(f"streamed output bad: shape {out.shape}, finite {np.isfinite(out).all()}")
    ref, _ = StreamingDenoiser(cfg, sd, device="cpu").process(clip)
    err = float(np.abs(out - ref).max())
    log(f"[stream] max abs err card vs CPU {err:.3e} (tolerance {STREAM_ATOL:.0e}), peak {float(np.abs(ref).max()):.3f}")
    if err > STREAM_ATOL:
        raise AssertionError(f"streaming card vs CPU {err:.3e} > {STREAM_ATOL:.0e}")

    offline = Denoiser(cfg, sd, device="cuda").run(torch.from_numpy(clip).cuda()).cpu().numpy()
    def by_shift(k0: int, k1: int = hops - 6) -> dict:
        want = offline[(k0 - 3) * hop : (k1 - 3) * hop]
        shifts = {s: relative_rms(out[(k0 - 3 + s) * hop : (k1 - 3 + s) * hop], want) for s in range(7)}
        log(f"[stream] relative RMS error against offline, blocks {k0}-{k1}, by shift: {shifts}")
        return shifts

    by_shift(60)
    shifts = by_shift(ALIGN_FROM)
    others = min(v for s, v in shifts.items() if s != 3)
    if shifts[3] > ALIGN_RMS or others < ALIGN_MARGIN * shifts[3]:
        raise AssertionError(f"streaming output not at the 3-hop shift of offline: {shifts}")

    latency = [stream_latency(den, clip, budget_s)]
    latency.append(stream_latency(StreamingDenoiser(cfg, sd, chunk_frames=4, device="cuda"), clip, 4 * budget_s))
    for row in latency:
        log(f"[stream-latency] {json.dumps(row)}")

    rng = np.random.default_rng(6)
    multi = []
    for n in STREAM_COUNTS:
        ms = MultiStreamDenoiser(cfg, sd, n, device="cuda")
        blocks = (0.1 * rng.standard_normal((40, n, hop))).astype(np.float32)
        state = ms.init_state()
        for b in blocks[:5]:
            state = ms.process_block(state, b)[1]
        lat = []
        cuda_gru.reset_launch_counts()
        for b in blocks[5:]:
            t0 = time.perf_counter()
            o, state = ms.process_block(state, b)
            o.cpu().numpy()
            lat.append(time.perf_counter() - t0)
        launches = cuda_gru.launch_counts()["gru_fwd"] / len(lat)
        row = {"streams": n, "calls": len(lat), **percentiles_ms(lat), "gru_fwd_a_call": launches}
        row["realtime_streams"] = n * budget_s / (row["median_ms"] / 1e3)
        log(f"[multistream] {json.dumps(row)}")
        multi.append(row)
    ms64 = MultiStreamDenoiser(cfg, sd, 64, device="cuda")
    sec = SAMPLE_RATE  # 1 s of 64 different streams
    streams = np.stack([np.roll(clip, 977 * i)[:sec] * (0.5 + i / 128) for i in range(64)]).astype(np.float32)
    batched, _ = ms64.process(streams)
    multi_err = max(float(np.abs(batched[i] - den.process(streams[i])[0]).max()) for i in (0, 31, 63))
    log(f"[multistream] streams 0, 31, 63 of 64 against their single runs: max abs err {multi_err:.3e} "
        f"(tolerance {STREAM_ATOL:.0e})")
    if multi_err > STREAM_ATOL:
        raise AssertionError(f"multi-stream vs single streams {multi_err:.3e} > {STREAM_ATOL:.0e}")

    soak = run_soak(cfg, sd, duration_s=SOAK_SECONDS, device="cuda")
    log(f"[soak] {json.dumps(soak)} native library {native.library_path().relative_to(REPO)}")
    work = os.path.join(REPO, "build", "chip_smoke_stream")
    os.makedirs(work, exist_ok=True)
    from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav

    wav_in, wav_out = os.path.join(work, "noisy.wav"), os.path.join(work, "enhanced.wav")
    write_wav(wav_in, clip[:sec], SAMPLE_RATE)
    file_stats = stream_file(cfg, sd, wav_in, wav_out, device="cuda")
    enhanced, _ = read_wav(wav_out)
    log(f"[stream_file] {json.dumps(file_stats)}")
    if file_stats["blocks_processed"] != sec // hop or enhanced.shape != (sec,) or not np.isfinite(enhanced).all():
        raise AssertionError(f"stream_file: {file_stats}, output {enhanced.shape}")
    return {"hops": hops, "stream_s": wall, "max_abs_err_vs_cpu": err, "align_rms_by_shift": shifts,
            "latency": latency, "multistream": multi, "multistream_max_abs_err": multi_err,
            "soak": soak, "stream_file": file_stats, "counts": counts}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.models import TRUNet
    from tinyrecurrentunet_torch.ops import build, cuda_gru
    from tinyrecurrentunet_torch.ops import gru as gru_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.time()
    logs = build.build_all()
    log(f"[build] {sorted(logs)} in {time.time() - t0:.2f} s")
    for name, text in logs.items():
        log(f"[build:{name}] {text.strip()}")

    # 2. kernel against its plain version at the main path's shapes
    cfg = load_config(CONFIG)
    large = load_config(os.path.join(REPO, "config", "large16k.json"))
    clip = make_clip()
    bucket = Denoiser._bucket(len(clip), cfg.featurizer.hop_length)
    frames = bucket // cfg.featurizer.hop_length + 1
    fb = TRUNet(cfg.network, device="meta").bottleneck_freqs(cfg.featurizer.num_freqs)
    net = cfg.network
    large_fb = TRUNet(large.network, device="meta").bottleneck_freqs(large.featurizer.num_freqs)
    shapes = [
        # name, path of gru_fwd, rows, T, H, reverse
        ("fgru_fwd", "registers", frames, fb, net.fgru_hidden, False),
        ("fgru_bwd", "registers", frames, fb, net.fgru_hidden, True),
        ("tgru", "registers", fb, frames, net.tgru_hidden, False),
        ("large16k_fgru_fwd", "cluster", frames, large_fb, large.network.fgru_hidden, False),
        ("large16k_fgru_bwd", "cluster", frames, large_fb, large.network.fgru_hidden, True),
        ("large16k_tgru", "cluster", large_fb, frames, large.network.tgru_hidden, False),
        # rows not a multiple of the row tile, T odd: one per path
        ("ragged_registers", "registers", 133, 7, net.tgru_hidden, True),
        ("ragged_cluster", "cluster", 133, 5, large.network.fgru_hidden, False),
        ("ragged_general", "general", 301, 9, 40, True),
    ]
    rows = [
        check_kernel(name, path, r, t, h, rev, seed, cuda_gru, gru_ops)
        for seed, (name, path, r, t, h, rev) in enumerate(shapes)
    ]
    for row in rows[6:]:
        if row["rows"] % row["rows_per_tile"] == 0 or row["T"] % 2 == 0:
            raise AssertionError(f"{row['shape']} is not ragged: {row}")
    main_rows = rows[:3]  # the three launches of one flagship denoise call
    # gru_fwd at the streaming path's launch shapes: one hop of the flagship,
    # 4 hops a call, 64 streams a call, one hop of large16k
    fh, th, lfh, lth = net.fgru_hidden, net.tgru_hidden, large.network.fgru_hidden, large.network.tgru_hidden
    stream_shapes = [
        # name, path of gru_fwd, rows, T, H, reverse
        ("stream_fgru_fwd", "registers", 1, fb, fh, False),
        ("stream_fgru_bwd", "registers", 1, fb, fh, True),
        ("stream_tgru", "registers", fb, 1, th, False),
        ("stream_chunk4_fgru_fwd", "registers", 4, fb, fh, False),
        ("stream_chunk4_fgru_bwd", "registers", 4, fb, fh, True),
        ("stream_chunk4_tgru", "registers", fb, 4, th, False),
        ("stream_64_fgru_fwd", "registers", 64, fb, fh, False),
        ("stream_64_fgru_bwd", "registers", 64, fb, fh, True),
        ("stream_64_tgru", "registers", 64 * fb, 1, th, False),
        ("large16k_stream_fgru_fwd", "cluster", 1, large_fb, lfh, False),
        ("large16k_stream_fgru_bwd", "cluster", 1, large_fb, lfh, True),
        ("large16k_stream_tgru", "cluster", large_fb, 1, lth, False),
    ]
    streaming_rows = [
        check_streaming_kernel(name, path, r, t, h, rev, 100 + seed, cuda_gru, gru_ops)
        for seed, (name, path, r, t, h, rev) in enumerate(stream_shapes)
    ]

    # 3. the serving path
    denoiser = Denoiser.from_pretrained(cfg, ARTIFACT, device="cuda")
    cuda_gru.reset_launch_counts()
    out = denoiser(clip)
    torch.cuda.synchronize()
    counts = cuda_gru.launch_counts()
    launches = counts["gru_fwd"]
    log(f"[main] launches in one denoise call: {counts}")
    if counts != {**{k: 0 for k in counts}, "gru_fwd": 3}:
        raise AssertionError(f"expected 3 gru_fwd launches and no other per call, got {counts}")
    if out.shape != clip.shape or not np.isfinite(out).all():
        raise AssertionError(f"denoised output bad: shape {out.shape}, finite {np.isfinite(out).all()}")
    ref = Denoiser.from_pretrained(cfg, ARTIFACT, device="cpu")(clip)
    denoise_err = float(np.abs(out - ref).max())
    log(f"[main] max abs err card vs CPU {denoise_err:.3e} (tolerance {DENOISE_ATOL:.0e}), "
        f"peak {float(np.abs(ref).max()):.3f}")
    if denoise_err > DENOISE_ATOL:
        raise AssertionError(f"denoise card vs CPU {denoise_err:.3e} > {DENOISE_ATOL:.0e}")

    audio_dev = torch.from_numpy(np.pad(clip, (0, bucket - len(clip)))).cuda()
    device_ms = cuda_ms(lambda: denoiser.run(audio_dev), 20, 3)
    for _ in range(3):
        denoiser(clip)
    t0 = time.perf_counter()
    n_calls = 20
    for _ in range(n_calls):
        denoiser(clip)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / n_calls * 1e3
    log(json.dumps({
        "main_path": "Denoiser proc16k offline", "clip_s": CLIP_SECONDS, "bucket_samples": bucket,
        "frames": frames, "run_ms_cuda_events": device_ms, "call_ms_host_clock": call_ms,
        "rtf": call_ms / 1e3 / CLIP_SECONDS, "max_abs_err_vs_cpu": denoise_err,
    }))

    # 4. the training kernels at the flagship training step's launch shapes
    train_cfg = float32_training(cfg)
    train_frames = int(train_cfg.trainset.crop_length_sec * SAMPLE_RATE) // cfg.featurizer.hop_length + 1
    train_shapes = [
        ("train_fgru_fwd", TRAIN_BATCH * train_frames, fb, net.fgru_hidden, False),
        ("train_fgru_bwd", TRAIN_BATCH * train_frames, fb, net.fgru_hidden, True),
        ("train_tgru", TRAIN_BATCH * fb, train_frames, net.tgru_hidden, False),
    ]
    train_rows = [
        row
        for seed, (name, r, t, h, rev) in enumerate(train_shapes)
        for row in check_train_kernels(name, r, t, h, rev, 10 + seed, cuda_gru, gru_ops)
    ]
    # gru_fwd_train at rows not a multiple of the row tile and T odd, both
    # directions, on each path
    ragged_fwd_shapes = [
        (path, r, t, h, rev)
        for path, r, t, h in (("registers", 1001, 13, 64), ("registers", 133, 7, 128),
                              ("cluster", 133, 5, 256), ("cluster", 19, 3, 512), ("general", 301, 9, 40))
        for rev in (False, True)
    ]
    ragged_fwd = [
        check_fwd_train_shape(f"ragged_{path}_h{h}_{'rev' if rev else 'fwd'}", path, r, t, h, rev, 60 + i,
                              cuda_gru, gru_ops)
        for i, (path, r, t, h, rev) in enumerate(ragged_fwd_shapes)
    ]
    # gru_fwd_train at large16k's training launch shapes, at its own batch
    large_batch = large.train.optimization.batch_size_per_device
    large_frames = int(large.trainset.crop_length_sec * SAMPLE_RATE) // large.featurizer.hop_length + 1
    large_fwd = [
        check_fwd_train_large("large16k_train_fgru", "cluster", large_batch * large_frames, large_fb,
                              large.network.fgru_hidden, 70, cuda_gru, gru_ops),
        check_fwd_train_large("large16k_train_tgru", "cluster", large_batch * large_fb, large_frames,
                              large.network.tgru_hidden, 71, cuda_gru, gru_ops),
    ]
    # gru_bwd at rows not a multiple of the row tile and T odd, both
    # directions, on each path
    ragged_bwd_shapes = [
        (path, r, t, h, rev)
        for path, r, t, h in (("registers", 1001, 13, 64), ("registers", 133, 7, 128), ("general", 301, 9, 40))
        for rev in (False, True)
    ]
    ragged_bwd = [
        check_bwd_shape(f"ragged_{path}_h{h}_{'rev' if rev else 'fwd'}", path, r, t, h, rev, 40 + i,
                        cuda_gru, gru_ops)
        for i, (path, r, t, h, rev) in enumerate(ragged_bwd_shapes)
    ]

    # 5. the training path
    train_summary, train_counts = train_main_path(train_cfg, cuda_gru)

    # 6. the streaming path
    t6 = time.time()
    stream = streaming_main_path(cfg, clip, cuda_gru)
    log(f"[stream] phase 6 in {time.time() - t6:.1f} s")

    kernel = {
        "name": "gru_fwd",
        "route": "cuda",
        "source": "tinyrecurrentunet_torch/ops/csrc/gru_fwd.cu",
        "replaces": "tinyrecurrentunet_tpu/ops/pallas_gru.py:32",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "shapes": rows,
        # one hop of the streaming path: 3 launches (phase 6)
        "streaming_launches": stream["counts"]["gru_fwd"],
        "streaming_hops": stream["hops"],
        "streaming_shapes": streaming_rows,
    }
    kernel["max_abs_err"] = max(kernel["max_abs_err"], max(r["max_abs_err"] for r in streaming_rows))
    kernel["max_err"] = kernel["max_abs_err"]
    kernel["kernel_ms"] = kernel["ms"]
    kernels = [kernel]
    replaces = {
        "gru_fwd_train": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:74",
        "gru_bwd": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:118",
        "gru_dw_partial": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:118",
        "gru_dw_sum": "tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:118",
    }
    for name, site in replaces.items():
        mine = [r for r in train_rows if r["kernel"] == name]  # one train step's three launches
        entry = {
            "name": name,
            "route": "cuda",
            "source": "tinyrecurrentunet_torch/ops/csrc/gru_train.cu",
            "replaces": site,
            "launches": train_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # dWh and dbh are sums over 257k row-steps, entries up to ~1e3:
            # their tolerance is relative (DW_RTOL)
            "max_rel_err": max((r["max_rel_err"] for r in mine if r["max_rel_err"] is not None),
                               default=None),
            # device time (torch.profiler), the PyTorch call's too; call_ms
            # by CUDA events around the wrapper
            "ms": sum(r["ms"] for r in mine),
            "call_ms": sum(r["call_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine) else "operations",
            "library_ms": sum(r["library_ms"] for r in mine),
            "shapes": mine,
        }
        if name == "gru_fwd_train":
            # the resident kernel of gru_fwd.cu, with its residuals saved; the
            # general kernel (any other H) is in gru_train.cu
            entry["source"] = "tinyrecurrentunet_torch/ops/csrc/gru_fwd.cu"
            entry["general_source"] = "tinyrecurrentunet_torch/ops/csrc/gru_train.cu"
            entry["max_abs_err"] = max(r["max_abs_err"] for r in mine + ragged_fwd + large_fwd)
            entry["general_ms"] = sum(r["general_ms"] for r in mine)
            entry["paths"] = sorted({r["path"] for r in mine + ragged_fwd + large_fwd})
            entry["ragged_shapes"] = ragged_fwd
            entry["large16k_shapes"] = large_fwd
        if name == "gru_bwd":
            entry["max_abs_err"] = max(r["max_abs_err"] for r in mine + ragged_bwd)
            entry["general_ms"] = sum(r["general_ms"] for r in mine)
            entry["paths"] = sorted({r["path"] for r in mine + ragged_bwd})
            entry["ragged_shapes"] = ragged_bwd
        kernels.append(entry)
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
