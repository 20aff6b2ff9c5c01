"""Share of the samples the card worked on in the untraced window that were
padding: the window calls' `padded_samples` (a clip's length bucket less
its length, `Denoiser._bucket`) over their `samples` plus
`padded_samples`, as the program's recorder counted them on each
`trunet.denoise.call` (`utils/profiling.py`). The window's calls are the
recorder's last `len(ms_per_audio_s)` calls of that name."""

from trubench import harness

LAYER = "entry, serving"
UNIT = "%"
MOVES = "denoise_audio_s_per_s"
WORKLOADS = ["large16k-denoise-mixed"]


def read(reading: dict):
    window = harness.load_module("metrics", "hop_device_ms.p50")._window
    calls = window("trunet.denoise.call", len(reading["facts"].get("ms_per_audio_s") or ()))
    if calls is None or any({"samples", "padded_samples"} - set(c.counts) for c in calls):
        return None
    padded = sum(c.counts["padded_samples"] for c in calls)
    return 100.0 * padded / (padded + sum(c.counts["samples"] for c in calls))
