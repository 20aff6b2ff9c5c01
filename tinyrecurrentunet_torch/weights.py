"""Weights: `pretrained.npz` <-> the port's `state_dict`.

Counterpart of the `pretrained.npz` half of `tinyrecurrentunet_tpu/train/checkpoint.py`.
The npz holds the flax variables flattened to keys such as
`params/['GRUBlock_1']/['GRU_0']/['wh_fwd']`, the BatchNorm running
statistics under `batch_stats/…` and the artifact's decode-critical settings
under `meta/…`. Round-1 artifacts stored params without the `params/` prefix.

`state_dict_from_variables` converts nested flax variables (numpy leaves),
{"params": …, "batch_stats": …}, into a state_dict of `models.TRUNet`:

- Dense `kernel` (in, out) -> `weight` (out, in)
- Conv `kernel` (k, Cin/groups, Cout) -> `weight` (Cout, Cin/groups, k);
  `depthwise_kernel` -> `depthwise_weight` likewise
- `tr_kernel` (k, Cin, Cout) -> `tr_weight` (Cin, Cout, k), taps flipped
- BatchNorm `scale` -> `weight`, `mean`/`var` -> `running_mean`/`running_var`
- GRU `wi_*`, `wh_*`, `bi_*`, `bh_*` keep their names and layouts.

`variables_from_state_dict` is its exact inverse (a 1-D `weight` is a
BatchNorm scale, 2-D a Dense kernel, 3-D a conv kernel); the training's
`save_pretrained_params` writes its result as the npz above.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from tinyrecurrentunet_torch.config import Config
from tinyrecurrentunet_torch.ops.conv import (
    conv_transpose_weight_from_jax,
    conv_transpose_weight_to_jax,
    conv_weight_from_jax,
    conv_weight_to_jax,
)

_SECTIONS = ("params", "batch_stats")


def artifact_meta(cfg: Config) -> dict:
    """The settings a weights artifact must agree on with its loader."""
    return {
        "phm_source": cfg.network.phm_source,
        "channels": ",".join(cfg.featurizer.channels),
        "sample_rate": cfg.featurizer.sample_rate,
    }


def check_artifact_meta(meta: Mapping[str, Any], cfg: Config, artifact: str):
    """Raise when a recorded artifact setting contradicts the config."""
    if not meta:
        return  # artifact predates recorded settings: nothing to check
    expected = artifact_meta(cfg)
    for key in ("phm_source", "channels", "sample_rate"):
        recorded = str(meta.get(key, "")) or None
        if recorded and recorded != str(expected[key]):
            raise ValueError(
                f"{artifact} was trained with {key}={recorded!r} but the "
                f"config says {expected[key]!r} — loading it would silently "
                f"decode with an incompatible head. Pin {key} in the config "
                "to the recorded value (or re-export the artifact)."
            )


def _parse_key(key: str) -> tuple[str, list[str]]:
    """"params/['A']/['B']/['kernel']" -> ("params", ["A", "B", "kernel"])."""
    parts = key.split("/")
    section = parts[0] if parts[0] in _SECTIONS + ("meta",) else "params"
    if parts[0] == section:
        parts = parts[1:]
    return section, [p[2:-2] if p.startswith("['") and p.endswith("']") else p for p in parts]


def read_npz(path: str) -> tuple[dict, dict]:
    """-> (nested variables {"params": …, "batch_stats": …}, meta dict)."""
    variables: dict = {s: {} for s in _SECTIONS}
    meta = {}
    with np.load(path) as data:
        for key in data.files:
            section, names = _parse_key(key)
            if section == "meta":
                meta[names[0]] = data[key][()]
                continue
            node = variables[section]
            for name in names[:-1]:
                node = node.setdefault(name, {})
            node[names[-1]] = data[key]
    return variables, meta


def _flatten(tree: Mapping, prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(value, dtype=np.float32)


def _convert_param(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        return "weight", value.T if value.ndim == 2 else conv_weight_from_jax(value)
    if leaf == "depthwise_kernel":
        return "depthwise_weight", conv_weight_from_jax(value)
    if leaf == "tr_kernel":
        return "tr_weight", conv_transpose_weight_from_jax(value)
    if leaf == "scale":
        return "weight", value
    return leaf, value


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Nested flax variables (numpy leaves) -> state_dict of `models.TRUNet`."""
    state = {}
    for path, value in _flatten(variables["params"]):
        leaf, value = _convert_param(path[-1], value)
        state[".".join(path[:-1] + (leaf,))] = torch.tensor(value)
    for path, value in _flatten(variables.get("batch_stats", {})):
        key = ".".join(path[:-1] + (_STAT_NAMES[path[-1]],))
        state[key] = torch.tensor(value)
    return state


def _param_to_jax(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "weight":
        if value.ndim == 1:
            return "scale", value
        return "kernel", value.T if value.ndim == 2 else conv_weight_to_jax(value)
    if leaf == "depthwise_weight":
        return "depthwise_kernel", conv_weight_to_jax(value)
    if leaf == "tr_weight":
        return "tr_kernel", conv_transpose_weight_to_jax(value)
    return leaf, value


_STAT_LEAVES = {v: k for k, v in _STAT_NAMES.items()}


def variables_from_state_dict(state: Mapping[str, torch.Tensor]) -> dict:
    """state_dict of `models.TRUNet` -> nested flax variables {"params": …,
    "batch_stats": …} with float32 numpy leaves; the exact inverse of
    `state_dict_from_variables`."""
    variables: dict = {s: {} for s in _SECTIONS}
    for key, tensor in state.items():
        *path, leaf = key.split(".")
        value = tensor.detach().cpu().numpy().astype(np.float32)
        if leaf in _STAT_LEAVES:
            section, (leaf, value) = "batch_stats", (_STAT_LEAVES[leaf], value)
        else:
            section, (leaf, value) = "params", _param_to_jax(leaf, value)
        node = variables[section]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return variables


def load_pretrained(directory: str, cfg: Config | None = None) -> dict[str, torch.Tensor]:
    """`<directory>/pretrained.npz` -> state_dict; with `cfg`, the artifact's
    recorded settings are checked against it first."""
    path = os.path.join(directory, "pretrained.npz")
    variables, meta = read_npz(path)
    if cfg is not None:
        check_artifact_meta(meta, cfg, path)
    return state_dict_from_variables(variables)
