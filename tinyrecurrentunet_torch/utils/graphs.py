"""Capturing a body of work into a CUDA graph, the sequence the port's three
replayed paths share: offline serving (a graph a length bucket,
`infer/denoise.py`), streaming (a graph a hop, `infer/streaming.py`) and
training (a graph a batch shape, `train/step.py`).

`capture(body, restore, pool)` runs `body()` WARMUP times eagerly on a side
stream (the kernels' build and one-time attribute and occupancy calls,
cuFFT's plans, cuDNN's choices, state made lazily such as AdamW's), calls
`restore()` after them where the body advances state of its own, then
captures one call of `body()` into a new `torch.cuda.CUDAGraph`, in the
memory pool `pool` where one is given, under `cuda_gru.capture_tally`. The
captured call runs nothing: the graph's replays do. A failure in the
warm-up or the capture raises, and no graph is returned. The whole is a
`trunet.graph.capture` span of the port's recorder (`utils/profiling.py`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.utils import profiling

WARMUP = 3  # eager runs of the body before its capture


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    launches: dict  # the kernels' launches one replay runs, for cuda_gru.add_launches
    output: Any  # what the captured call of body() returned: its static outputs


def capture(body: Callable[[], Any], restore: Callable[[], None] | None = None, pool=None) -> Captured:
    """Warm `body` up on a side stream, `restore()`, capture one call."""
    with profiling.span("trunet.graph.capture"):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                body()
        torch.cuda.current_stream().wait_stream(side)
        if restore is not None:
            restore()
        graph = torch.cuda.CUDAGraph()
        with cuda_gru.capture_tally() as tally, torch.cuda.graph(graph, pool=pool):
            output = body()
    return Captured(graph, tally, output)


def pool_bytes(pool) -> int | None:
    """Bytes the card reserves in the segments of the graph memory pool
    `pool` (torch.cuda.memory_snapshot); None where the snapshot names no
    pools."""
    segments = torch.cuda.memory_snapshot()
    if pool is None or not any("segment_pool_id" in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == tuple(pool))
