"""Share of the untraced window outside the program's calls on the card:
100 x (1 - the window calls' device intervals, as the program's recorder
timed them (`utils/profiling.py`), over the window). A call's interval runs
from its start event, recorded before the staging copy, to its end event,
after the output's copy to the host, and all of it counts as busy: the
card's gaps inside it (the host issuing the copy after the start event;
the gaps between the graph's kernels) are not counted. So this is the idle
between calls (the host's padding and staging of the next clip), not all
of the card's idle. The window's calls are the recorder's last
`len(ms_per_audio_s)` `trunet.denoise.call` calls: the profiled slice
after the window stays out of its ring."""

from trubench import harness

LAYER = "device"
UNIT = "%"
MOVES = "denoise_audio_s_per_s"
WORKLOADS = ["large16k-denoise-mixed"]


def read(reading: dict):
    facts = reading["facts"]
    window = harness.load_module("metrics", "hop_device_ms.p50")._window
    calls = window("trunet.denoise.call", len(facts.get("ms_per_audio_s") or ()))
    if calls is None or any(c.device is None for c in calls):
        return None
    busy_ns = sum(c.device[1] - c.device[0] for c in calls)
    return 100.0 * (1.0 - busy_ns / 1e9 / facts["window_s"])
