"""Offline cleaning of recordings: one clip a call through the program's
`Denoiser.__call__` (numpy in, numpy out), closed loop.

Parameters (the cell's `params`): `pool` clips whose lengths are the
`pool` quantiles of a log-uniform law on [`min_s`, `max_s`] seconds (the
same lengths for every seed; the speech, the noise kind, the SNR and the
order of the calls come from the seed), each clip's first and last
n_fft / 2 + 1 samples silent (below), played in a fresh seeded order each
pass; about one call in `sample_every` has its output kept, drawn
from the seed, and `sample` of the kept outputs are checked, the longest
clip's last output among them; `slice_calls` calls are profiled in a
traced run.

Set-up loads the shipped weights (the benchmark's own reader), builds the
Denoiser with TF32 off as the port's CLI sets it (infer/denoise.py:256-257),
makes the pool and calls each clip once, which captures every length
bucket the window uses. The window then calls clip after clip.

End to end: `denoise_audio_s_per_s`, the seconds of input audio whose
cleaned output reached the host in the window, over the window.

Checked (`rms_err_rel`): each sampled output against the reference's
denoising of the same clip (`reference/serve.py`): the RMS of the
difference over the reference's RMS, worst clip (`harness.errors`; the
widest gap, `max_err_rel`, is kept beside it for calibration). Its control
is the reference with TF32 on.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from trubench import harness
from trubench.inputs import procgen
from trubench.reference import net, serve, weights
from trubench.work import gru, model


def pool(seed: int, params: dict, sr: int, n_fft: int) -> list[np.ndarray]:
    """The clips, each with its first and last n_fft / 2 + 1 samples set to
    digital silence. A centred STFT reflects the clip at both ends, so its
    first and last frames are even: their spectra are real, and a bin that
    lies near zero there flips sign under float32 rounding, which moves its
    phase features by up to 2 in whichever program computes them (the
    float32 and float64 FFTs of one frame part there). Silent edges make
    those frames exactly zero on both sides, so every seed's clips are
    equally well conditioned."""
    n, lo, hi = params["pool"], params["min_s"], params["max_s"]
    rng = np.random.default_rng(seed)
    lengths = [int(round(sr * lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]
    kinds, edge = procgen.ADDITIVE_KINDS, n_fft // 2 + 1
    clips = [procgen.noisy_pair(rng, length, sr, kinds[i % len(kinds)])[1] for i, length in enumerate(lengths)]
    for clip in clips:
        clip[:edge] = 0.0
        clip[-edge:] = 0.0
    return clips


def order(seed: int, n: int):
    """Clip indices: a fresh seeded permutation of the pool each pass."""
    rng = np.random.default_rng((seed, 1))
    while True:
        yield from rng.permutation(n)


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.ops import cuda_gru

    p, fz, net_cfg = ctx.params, ctx.config["featurizer"], ctx.config["network"]
    sr, hop = fz["sample_rate"], fz["hop_length"]
    cfg = ctx.program_config()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = weights.load(ctx)
    clips = pool(ctx.seed, p, sr, fz["n_fft"])
    denoiser = Denoiser(cfg, state, device=ctx.device)
    if ctx.fault is not None:
        ctx.fault(denoiser)
    for clip in clips:
        denoiser(clip)
    harness.settle(ctx.device)

    keep = np.random.default_rng((ctx.seed, 2))
    calls = order(ctx.seed, len(clips))
    longest = int(np.argmax([len(c) for c in clips]))
    kept, ms_per_s, served, failed, frames, last_longest = [], [], 0.0, 0, 0, None
    setup_s = ctx.setup_s()
    start = time.perf_counter()
    while True:
        i = next(calls)
        t = time.perf_counter()
        out = denoiser(clips[i])
        done = time.perf_counter()
        seconds = len(clips[i]) / sr
        ms_per_s.append((done - t) * 1e3 / seconds)
        served += seconds
        frames += model.frames(len(clips[i]), hop)
        failed += int(not np.isfinite(out).all())
        if keep.integers(p["sample_every"]) == 0:
            kept.append((i, out))
        if i == longest:
            last_longest = out
        if done - start >= ctx.seconds:
            break
    window = done - start
    peak = harness.memory_peak(ctx.device)
    facts = {"ms_per_audio_s": ms_per_s, "window_s": window, "forward_frames": frames, "dtype": "float32"}

    slice_ = None
    if ctx.trace:
        from trubench import trace

        sliced = [next(calls) for _ in range(p["slice_calls"])]
        it = itertools.cycle(sliced)  # every profile (a retake too) starts at the slice's first clip

        def traced():
            with harness.span("call", True):
                denoiser(clips[next(it)])

        slice_ = trace.traced(traced, len(sliced), p["named_calls"], lambda: cuda_gru.launch_counts()["gru_fwd"])
        fb = net.bottleneck_freqs(net_cfg, fz["n_fft"] // 2 + 1)
        facts["slice_gru_bound_s"] = sum(
            2 * gru.bound_s(*gru.forward(t, fb, net_cfg["fgru_hidden"]))
            + gru.bound_s(*gru.forward(fb, t, net_cfg["tgru_hidden"]))
            for t in (model.frames(len(clips[i]), hop) for i in sliced))
    del denoiser
    harness.free_program()

    picked = np.random.default_rng((ctx.seed, 3)).permutation(len(kept))[:max(p["sample"] - 1, 0)]
    sample = [kept[j] for j in picked] + ([(longest, last_longest)] if last_longest is not None else [])
    device = harness.reference_device(ctx.device)
    params = {k: v.to(device) for k, v in state.items()}
    refs = [serve.denoise(params, ctx.config, clips[i], device) for i, _ in sample]
    facts["program"] = harness.errors((out, ref) for (_, out), ref in zip(sample, refs))
    checks = harness.checks(facts["program"], ctx, ("rms_err_rel",))
    if ctx.calibrate:
        with harness.tf32():
            control = [serve.denoise(params, ctx.config, clips[i], device) for i, _ in sample]
        facts["control"] = harness.errors(zip(control, refs))
        facts["control_checks"] = harness.checks(facts["control"], ctx, ("rms_err_rel",))
    return harness.Outcome({"denoise_audio_s_per_s": served / window, "setup_s": setup_s}, len(ms_per_s), failed,
                           checks, peak, facts, slice_)
