"""Checkpoints of the port, counterpart of `tinyrecurrentunet_tpu/train/checkpoint.py`.

- `CheckpointManager`: `<log directory>/<exp_path>/checkpoint/<iteration>.pt`,
  a `torch.save` of the model's state_dict, the optimizer's, the update count,
  the iteration and the training seconds; restored by the `max` (latest) or
  an integer selector. This is the port's own format: Orbax checkpoints stay
  with the JAX package. Under data parallelism rank 0 writes, the other
  ranks wait for it at a barrier, and every rank restores from the file.
- `save_pretrained_params`: the standalone `pretrained.npz` (params, BN
  running statistics, decode-critical settings under `meta/`) in the JAX
  package's key layout, which both packages load.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from tinyrecurrentunet_torch import parallel
from tinyrecurrentunet_torch.train.state import TrainState, load_optimizer_state
from tinyrecurrentunet_torch.weights import variables_from_state_dict

_CKPT_NAME = re.compile(r"^(\d+)\.pt$")


def checkpoint_dir(log_directory: str, exp_path: str) -> str:
    return os.path.join(os.path.abspath(log_directory), exp_path, "checkpoint")


class CheckpointManager:
    """Save and restore with the reference's selector semantics."""

    def __init__(self, log_directory: str, exp_path: str):
        self.directory = checkpoint_dir(log_directory, exp_path)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        names = (_CKPT_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in names if m)

    def save(self, step: int, state: TrainState, training_time_seconds: int = 0):
        """Called by every rank: rank 0 writes, the others wait until it has."""
        if parallel.rank() == 0:
            payload = {
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "updates": state.step,
                "iter": step,
                "training_time_seconds": training_time_seconds,
            }
            os.makedirs(self.directory, exist_ok=True)
            tmp = self._path(step) + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
        parallel.barrier()

    def resolve_step(self, selector: str | int) -> int:
        """'max' -> latest step (-1 if none); int/int-string -> that step."""
        if selector == "max":
            steps = self.all_steps()
            return steps[-1] if steps else -1
        return int(selector)

    def load(self, selector: str | int = "max", device="cpu") -> dict | None:
        """The payload of the checkpoint `selector` names, its tensors on
        `device`, or None when there is no such checkpoint."""
        step = self.resolve_step(selector)
        if step < 0 or step not in self.all_steps():
            return None
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def restore(self, state: TrainState, selector: str | int = "max"):
        """Load into `state` in place. Returns (state, iteration,
        training_time_seconds), or (state, -1, 0) when there is nothing to
        restore (a fresh start)."""
        payload = self.load(selector, next(state.model.parameters()).device)
        if payload is None:
            return state, -1, 0
        state.model.load_state_dict(payload["model"])
        load_optimizer_state(state.optimizer, payload["optimizer"])
        state.step = int(payload["updates"])
        return state, int(payload["iter"]), int(payload["training_time_seconds"])


def _flat_keys(tree: dict, prefix: str):
    """{"A": {"kernel": x}} -> {"<prefix>['A']/['kernel']": x}, the JAX keypath strings."""
    for name, value in tree.items():
        key = f"{prefix}/['{name}']"
        if isinstance(value, dict):
            yield from _flat_keys(value, key)
        else:
            yield key, value


def save_pretrained_params(directory: str, model: torch.nn.Module, meta: dict | None = None):
    """`<directory>/pretrained.npz` from the model's params and BN running
    statistics, with the JAX package's keys (`params/['A']/['B']/['kernel']`,
    `batch_stats/…`, `meta/<key>`); `meta` is `weights.artifact_meta(cfg)`."""
    arrays = {}
    for section, tree in variables_from_state_dict(model.state_dict()).items():
        arrays.update(_flat_keys(tree, section))
    for key, value in (meta or {}).items():
        arrays[f"meta/{key}"] = np.asarray(value)
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "pretrained.npz"), **arrays)
