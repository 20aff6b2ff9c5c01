"""Seconds the process spent in `trunet.graph.capture` spans (the warm-ups
and the capture of each CUDA graph, `utils/graphs.py`), as the program's
recorder holds them (`utils/profiling.py`): every capture of the run, all
of them in set-up."""

LAYER = "whole step"
UNIT = "s"
MOVES = "setup_s"
WORKLOADS = ["proc16k-train-bf16", "proc16k-stream-256", "large16k-denoise-mixed"]


def read(reading: dict):
    if "window_s" not in reading["facts"]:  # no run to read
        return None
    from tinyrecurrentunet_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    try:
        spans = profiling.spans("trunet.graph.capture")
    except profiling.Overflow:
        return None
    return sum(end - start for start, end in spans) / 1e9 if spans else None
