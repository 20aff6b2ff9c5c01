"""Model FLOPs of the window (from the configuration's shapes, `work/model.py`)
over the window's seconds times the published peak of the cell's dtype."""

from trubench import readers

LAYER = "whole step"
UNIT = "%"
MOVES = "stream_hop_p95_ms"
WORKLOADS = ["proc16k-stream-256"]


def read(reading: dict):
    return readers.mfu(reading, readers.config("proc16k"))
