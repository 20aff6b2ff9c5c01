"""Live streams: every stream's next hop in one call of the program's
`MultiStreamDenoiser.process_block` (numpy in), its output brought back to
the host as numpy, closed loop: the next call starts when the last ended.

Parameters (the cell's `params`): `streams` streams, each playing one of
`clips` noisy clips of `clip_s` seconds (speech, noise kind and SNR from
the seed; the same lengths for every seed), looping, from its own offset
(a whole number of hops); the clip and the offset of each stream come from
the seed. `sample_streams` streams are checked, one drawn from each equal
block of streams; `slice_calls` calls are profiled in a traced run.

Set-up loads the shipped weights (the benchmark's own reader), builds the
denoiser with TF32 off as the port's stream CLI sets it
(infer/stream.py:227-228), makes the clips, and makes the first call,
which captures the hop's graph. The window makes call after call.

End to end: `stream_hop_p95_ms`, the 95th percentile over every call of
the window of the host time from handing the hop (numpy) to the call until
its output is numpy on the host. Beside it (facts): every call's ms.

Checked (`rms_err_rel`): every hop of the sampled streams, from the first
call to the window's last, against the reference's streaming of the same
input (`reference/serve.py`): the RMS of the difference over the
reference's RMS, worst stream (`harness.errors`; the widest gap,
`max_err_rel`, is kept beside it for calibration). Its control is the
reference with TF32 on.
"""

from __future__ import annotations

import time

import numpy as np

from trubench import harness
from trubench.inputs import procgen
from trubench.reference import net, serve, weights
from trubench.work import gru


class Streams:
    """The seeded inputs: hop k of every stream, and a stream's first hops."""

    def __init__(self, seed: int, params: dict, sr: int, hop: int):
        rng = np.random.default_rng(seed)
        hops = int(params["clip_s"] * sr) // hop
        kinds = procgen.ADDITIVE_KINDS
        clips = [procgen.noisy_pair(rng, hops * hop, sr, kinds[i % len(kinds)])[1] for i in range(params["clips"])]
        self.hops = np.stack(clips).reshape(len(clips), hops, hop)
        self.clip = rng.integers(len(clips), size=params["streams"])
        self.offset = rng.integers(hops, size=params["streams"])

    def block(self, k: int) -> np.ndarray:
        return self.hops[self.clip, (self.offset + k) % self.hops.shape[1]]

    def audio(self, streams, count: int) -> np.ndarray:
        """The first `count` hops of `streams`, (len(streams), count hop)."""
        idx = (self.offset[streams, None] + np.arange(count)[None]) % self.hops.shape[1]
        return self.hops[self.clip[streams, None], idx].reshape(len(streams), -1)


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.ops import cuda_gru

    p, fz, net_cfg = ctx.params, ctx.config["featurizer"], ctx.config["network"]
    hop, n = fz["hop_length"], p["streams"]
    cfg = ctx.program_config()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state_dict = weights.load(ctx)
    inputs = Streams(ctx.seed, p, fz["sample_rate"], hop)
    blocks = n // p["sample_streams"]
    checked = np.random.default_rng((ctx.seed, 1)).integers(blocks, size=p["sample_streams"]) \
        + blocks * np.arange(p["sample_streams"])
    denoiser = MultiStreamDenoiser(cfg, state_dict, n, 1, device=ctx.device)
    if ctx.fault is not None:
        ctx.fault(denoiser)
    state = denoiser.init_state()
    out, state = denoiser.process_block(state, inputs.block(0))
    outs = [out.cpu().numpy()[checked]]
    harness.settle(ctx.device)

    call_ms, failed, k = [], 0, 1
    setup_s = ctx.setup_s()
    start = time.perf_counter()
    while True:
        block = inputs.block(k)
        t = time.perf_counter()
        out, state = denoiser.process_block(state, block)
        out = out.cpu().numpy()
        done = time.perf_counter()
        call_ms.append((done - t) * 1e3)
        failed += int(not np.isfinite(out).all())
        outs.append(out[checked])
        k += 1
        if done - start >= ctx.seconds:
            break
    window = done - start
    peak = harness.memory_peak(ctx.device)
    facts = {"call_ms": call_ms, "window_s": window, "forward_frames": len(call_ms) * n, "dtype": "float32"}

    slice_ = None
    if ctx.trace:
        from trubench import trace

        def traced():
            nonlocal k, state
            block = inputs.block(k)
            with harness.span("call", True):
                with harness.span("process_block", True):
                    result, state = denoiser.process_block(state, block)
                with harness.span("copy_out", True):
                    result.cpu().numpy()
            k += 1

        slice_ = trace.traced(traced, p["slice_calls"], p["named_calls"], lambda: cuda_gru.launch_counts()["gru_fwd"])
        fb = net.bottleneck_freqs(net_cfg, fz["n_fft"] // 2 + 1)
        facts["slice_gru_bound_s"] = p["slice_calls"] * (
            2 * gru.bound_s(*gru.forward(n, fb, net_cfg["fgru_hidden"]))
            + gru.bound_s(*gru.forward(n * fb, 1, net_cfg["tgru_hidden"])))
    del denoiser, state
    harness.free_program()

    served = np.concatenate(outs, axis=1)  # (checked, hops x hop): from the first call to the window's last
    audio = inputs.audio(checked, len(outs))
    device = harness.reference_device(ctx.device)
    params = {key: v.to(device) for key, v in state_dict.items()}
    ref = serve.stream(params, ctx.config, audio, device)
    facts["program"] = harness.errors(zip(served, ref))
    checks = harness.checks(facts["program"], ctx, ("rms_err_rel",))
    if ctx.calibrate:
        with harness.tf32():
            control = serve.stream(params, ctx.config, audio, device)
        facts["control"] = harness.errors(zip(control, ref))
        facts["control_checks"] = harness.checks(facts["control"], ctx, ("rms_err_rel",))
    e2e = {"stream_hop_p95_ms": float(np.percentile(call_ms, 95)), "setup_s": setup_s}
    return harness.Outcome(e2e, len(call_ms), failed, checks, peak, facts, slice_)
