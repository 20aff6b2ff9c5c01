"""Share of the profiled slice in which no operation ran on the card."""

from trubench import readers

LAYER = "device"
UNIT = "%"
MOVES = "train_audio_s_per_s"
WORKLOADS = ["proc16k-train-bf16"]


def read(reading: dict):
    return readers.idle_share(reading)
