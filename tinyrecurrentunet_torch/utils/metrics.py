"""Training metrics: a JSONL log of scalars, and TensorBoard events when the
`tensorboard` package is installed. Counterpart of
`tinyrecurrentunet_tpu/utils/metrics.py`, with its scalar names
(Train/Train-Loss, Train/Gradient-Norm, Train/learning-rate, ...)."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricsWriter:
    def __init__(self, directory: str, use_tensorboard: bool = True):
        os.makedirs(directory, exist_ok=True)
        self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard not installed: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(directory, "tensorboard"))

    def scalars(self, step: int, values: Mapping[str, float]):
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
