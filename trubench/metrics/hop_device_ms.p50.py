"""Median over the untraced window's calls of a call's device interval (ms),
as the program's recorder timed it (`utils/profiling.py`): from before the
hop's staging copy to after its output's clone. The window's calls are the
recorder's last `len(call_ms)` `trunet.stream.call` calls."""

import statistics

LAYER = "whole step"
UNIT = "ms"
MOVES = "stream_hop_p95_ms"
WORKLOADS = ["proc16k-stream-256"]


def read(reading: dict):
    calls = _window("trunet.stream.call", len(reading["facts"].get("call_ms") or ()))
    if calls is None or any(c.device is None for c in calls):
        return None
    return statistics.median((c.device[1] - c.device[0]) / 1e6 for c in calls)


def _window(name: str, n: int):
    """The last `n` calls named `name` in the program's recorder; None where
    there are none to read, the ring holds fewer or has overwritten one, or
    the program has no recorder. The recorder's other window readers
    (`untraced_idle_share.*`, `pad_share.denoise`) take it from here."""
    if not n:
        return None
    from tinyrecurrentunet_torch.utils import profiling

    if not hasattr(profiling, "calls"):
        return None
    try:
        calls = profiling.calls(name, last=n)
    except profiling.Overflow:
        return None
    return calls if len(calls) == n else None
