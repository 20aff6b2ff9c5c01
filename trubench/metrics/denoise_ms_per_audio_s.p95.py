"""95th percentile over the window's calls of `Denoiser.__call__`'s host ms per
second of the clip's audio."""

from trubench import readers

LAYER = "entry, serving"
UNIT = "ms"
MOVES = "denoise_audio_s_per_s"
WORKLOADS = ["large16k-denoise-mixed"]


def read(reading: dict):
    return readers.percentile(reading, "ms_per_audio_s", 95)
