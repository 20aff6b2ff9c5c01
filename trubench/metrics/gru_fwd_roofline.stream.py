"""The least time of the calls' three GRU recurrences (`work/gru.py`, from
shapes) over the device time of the GRU kernel records."""

from trubench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "stream_hop_p95_ms"
WORKLOADS = ["proc16k-stream-256"]


def read(reading: dict):
    return readers.gru_roofline(reading)
