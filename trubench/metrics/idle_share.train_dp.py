"""Share of the profiled slice in which no operation ran on the card, on the
rank where it is highest."""

from trubench import readers

LAYER = "device"
UNIT = "%"
MOVES = "dp_train_audio_s_per_s"
WORKLOADS = ["proc16k-train-dp4"]


def read(reading: dict):
    return readers.idle_share(reading)
