"""Median over every call of the window of the host ms of one call of
`MultiStreamDenoiser.process_block`, hop in to output on the host."""

from trubench import readers

LAYER = "entry, streaming"
UNIT = "ms"
MOVES = "stream_hop_p95_ms"
WORKLOADS = ["proc16k-stream-256"]


def read(reading: dict):
    return readers.percentile(reading, "call_ms", 50)
