"""What the per-layer metrics share: shares of the profiled slice and the
model's utilization of the window. A reader returns None where its run has
nothing to read (no slice, no GRU kernel record); it never returns 0 for a
share of a roofline or of a peak.
"""

from __future__ import annotations

import numpy as np

from trubench import trace
from trubench.work import model
from trubench.work.peaks import FLOPS


def percentile(reading: dict, key: str, q: float):
    values = reading["facts"].get(key)
    return float(np.percentile(values, q)) if values else None


def mfu(reading: dict, config: dict):
    """Model FLOPs of the window's frames (forward, x3 for training) over
    the window's seconds times the published peak of the cell's dtype, %."""
    facts = reading["facts"]
    if not facts.get("forward_frames"):
        return None
    fz = config["featurizer"]
    flops = model.forward_flops_per_frame(config["network"], fz["n_fft"] // 2 + 1) * facts["forward_frames"]
    return 100.0 * flops / (facts["window_s"] * FLOPS[facts["dtype"]])


def device_share(reading: dict, kinds: tuple):
    """Device time of kernels of `kinds` over all device time in the slice, %."""
    sl = reading["slice"]
    if sl is None or not sl.ops:
        return None
    part = sl.device_s([op for op in sl.ops if trace.kind_of(op[0]) in kinds])
    return 100.0 * part / sl.device_s()


def gru_roofline(reading: dict):
    """The GRU work's least time (from shapes) over its kernels' device time, %."""
    sl = reading["slice"]
    bound = reading["facts"].get("slice_gru_bound_s")
    if sl is None or not bound:
        return None
    spent = sl.device_s(sl.kernels(trace.GRU))
    return 100.0 * bound / spent if spent > 0 else None


def idle_share(reading: dict):
    sl = reading["slice"]
    if sl is None or sl.seconds <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.seconds)


def config(name: str) -> dict:
    from trubench import harness

    return harness.load_json("configs", name)


def nccl_share(reading: dict):
    """NCCL kernels' device time over all device time, %, highest rank."""
    slices = reading["facts"].get("rank_slices")
    if not slices:
        return None
    shares = [100.0 * sl.device_s(sl.kernels(trace.NCCL)) / sl.device_s() for sl in slices if sl.ops]
    return max(shares) if shares and max(shares) > 0 else None
