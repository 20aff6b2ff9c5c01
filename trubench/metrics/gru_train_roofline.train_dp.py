"""The least time of the steps' GRU forward, BPTT and weight-gradient work
(`work/gru.py`, from shapes) over the device time of the GRU kernel records."""

from trubench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "dp_train_audio_s_per_s"
WORKLOADS = ["proc16k-train-dp4"]


def read(reading: dict):
    return readers.gru_roofline(reading)
