"""Model FLOPs of the window (from the configuration's shapes, `work/model.py`)
over the window's seconds times the published peak of the cell's dtype."""

from trubench import readers

LAYER = "whole step"
UNIT = "%"
MOVES = "train_audio_s_per_s"
WORKLOADS = ["proc16k-train-bf16"]


def read(reading: dict):
    return readers.mfu(reading, readers.config("proc16k"))
