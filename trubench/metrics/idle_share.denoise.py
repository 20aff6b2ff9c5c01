"""Share of the profiled slice in which no operation ran on the card."""

from trubench import readers

LAYER = "device"
UNIT = "%"
MOVES = "denoise_audio_s_per_s"
WORKLOADS = ["large16k-denoise-mixed"]


def read(reading: dict):
    return readers.idle_share(reading)
