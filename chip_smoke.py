"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. build every CUDA source of the port (`tinyrecurrentunet_torch/ops/csrc`);
2. hold the GRU recurrence kernel against its plain PyTorch version on the
   card at the flagship's three launch shapes (FGRU forward and reverse,
   TGRU) and one large16k shape, and time it beside the plain version, its
   bound and torch.nn.GRU (cuDNN, a yardstick the port never calls);
3. drive the main path: the offline `Denoiser` with config/proc16k.json and
   artifacts/TRUNet-proc/pretrained.npz on a seeded 4 s clip, with the
   launch counts set to 0 just before and read just after; check the output
   against the same Denoiser on the CPU, then time warm calls.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Kernel vs plain version, both float32 on the card: dot products of length
# H summed in another order (~H * 2^-24 relative per step), carried through
# up to ~500 steps of a contracting recurrence.
KERNEL_ATOL = 1e-4
# Denoiser on the card vs on the CPU: cuFFT and the CPU FFT differ in the
# last bit, which moves the float32 rounding of the ~1e3 rad unwrapped phase
# behind the demod features (~1e-4 on a few bins); the waveform stays well
# inside this bound (CPU port vs JAX measured 4.2e-5 on a 4 s clip).
DENOISE_ATOL = 2e-4

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


def torch_gru_same_function(x_proj, h0, wh, bh, reverse):
    """torch.nn.GRU computing the same recurrence: identity input weights and
    zero input bias turn its input projection into x_proj itself."""
    g = x_proj.shape[-1]
    hidden = g // 3
    gru = torch.nn.GRU(g, hidden, batch_first=True).to(x_proj.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(g))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(wh.T)
        gru.bias_hh_l0.copy_(bh)
    xs = x_proj.flip(1) if reverse else x_proj

    def call():
        return gru(xs, h0[None])

    return call


def check_kernel(name, rows, steps, hidden, reverse, seed, cuda_gru, gru_ops):
    device = torch.device("cuda")
    x_proj, h0, wh, bh = gru_inputs(rows, steps, hidden, seed, device)
    out_k, hT_k = cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
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
        "max_abs_err": err, "library_max_abs_err": lib_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }
    log(f"[kernel] {json.dumps(row)}")
    if not finite:
        raise AssertionError(f"gru_fwd {name}: non-finite output")
    if err > KERNEL_ATOL:
        raise AssertionError(f"gru_fwd {name}: max abs err {err:.3e} > {KERNEL_ATOL:.0e}")
    return row


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
    shapes = [
        ("fgru_fwd", frames, fb, net.fgru_hidden, False),
        ("fgru_bwd", frames, fb, net.fgru_hidden, True),
        ("tgru", fb, frames, net.tgru_hidden, False),
        ("large16k_tgru", fb, frames, large.network.tgru_hidden, False),
    ]
    rows = [
        check_kernel(name, r, t, h, rev, seed, cuda_gru, gru_ops)
        for seed, (name, r, t, h, rev) in enumerate(shapes)
    ]
    main_rows = rows[:3]  # the three launches of one flagship denoise call

    # 3. the main path
    denoiser = Denoiser.from_pretrained(cfg, ARTIFACT, device="cuda")
    cuda_gru.launches = 0
    out = denoiser(clip)
    torch.cuda.synchronize()
    launches = cuda_gru.launches
    log(f"[main] gru_fwd launches in one denoise call: {launches}")
    if launches != 3:
        raise AssertionError(f"expected 3 gru_fwd launches per call, got {launches}")
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
    }
    kernel["max_err"] = kernel["max_abs_err"]
    kernel["kernel_ms"] = kernel["ms"]
    log(nvidia_smi_line())
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
