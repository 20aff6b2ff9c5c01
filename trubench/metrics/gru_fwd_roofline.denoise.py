"""The least time of the clips' three GRU recurrences over their own frames
(`work/gru.py`, from shapes) over the device time of the GRU kernel records."""

from trubench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "denoise_audio_s_per_s"
WORKLOADS = ["large16k-denoise-mixed"]


def read(reading: dict):
    return readers.gru_roofline(reading)
