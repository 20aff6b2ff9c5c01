"""Model FLOPs of the window (from the configuration's shapes, `work/model.py`)
over the window's seconds times the published peak of the cell's dtype."""

from trubench import readers

LAYER = "whole step"
UNIT = "%"
MOVES = "denoise_audio_s_per_s"
WORKLOADS = ["large16k-denoise-mixed"]


def read(reading: dict):
    return readers.mfu(reading, readers.config("large16k"))
