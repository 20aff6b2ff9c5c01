"""Weights for both sides: the shipped `pretrained.npz` read by the
benchmark's own reader, or weights drawn from the seed on the card.

Both give a state_dict in the port's names and torch's layouts, which the
benchmark loads into the program and hands, as the same tensors, to the
reference (`reference/net.py` says the layouts).
"""

from __future__ import annotations

import numpy as np
import torch


def _path(key: str) -> list[str]:
    """"params/['A']/['B']/['kernel']" -> ["params", "A", "B", "kernel"]."""
    return [p[2:-2] if p.startswith("['") else p for p in key.split("/")]


def read_pretrained(path: str) -> dict[str, torch.Tensor]:
    """flax variables of `pretrained.npz` -> float32 state_dict on the host."""
    state = {}
    with np.load(path) as data:
        for key in data.files:
            section, *names = _path(key)
            if section == "meta":
                continue
            value = np.asarray(data[key], np.float32)
            leaf, module = names[-1], ".".join(names[:-1])
            if section == "batch_stats":
                leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
            elif leaf == "kernel":  # Dense (in, out); Conv (k, Cin, Cout)
                leaf, value = "weight", value.T if value.ndim == 2 else value.transpose(2, 1, 0)
            elif leaf == "depthwise_kernel":  # (k, 1, C)
                leaf, value = "depthwise_weight", value.transpose(2, 1, 0)
            elif leaf == "tr_kernel":  # (k, Cin, Cout): taps flipped for torch's transposed conv
                leaf, value = "tr_weight", value[::-1].transpose(1, 2, 0)
            elif leaf == "scale":
                leaf = "weight"
            state[f"{module}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))
    return state


def _fan_in(name: str, shape: tuple) -> int:
    if name.endswith("tr_weight"):
        return shape[0] * shape[2]
    if len(shape) == 3:  # (Cout, Cin/groups, k)
        return shape[1] * shape[2]
    return shape[1]  # Dense (out, in)


@torch.no_grad()
def seeded(like: dict[str, torch.Tensor], seed: int, device) -> dict[str, torch.Tensor]:
    """A state_dict shaped as `like`, drawn on `device` from `seed` in one
    call: lecun-normal kernels, GRU weights and biases normal with std
    1/sqrt(H), other biases 0, BatchNorm at identity."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(t.numel() for t in like.values())
    draw = torch.randn(total, generator=gen, device=device)
    state, offset = {}, 0
    for name, ref in like.items():
        values = draw[offset:offset + ref.numel()].reshape(ref.shape).clone()
        offset += ref.numel()
        leaf = name.rsplit(".", 1)[-1]
        if ".GRU_0." in name:
            hidden = like[name.rsplit(".", 1)[0] + ".wh_fwd"].shape[0]
            values *= hidden ** -0.5
        elif leaf in ("running_var",) or (leaf == "weight" and ref.dim() == 1):
            values.fill_(1.0)
        elif leaf in ("bias", "running_mean", "depthwise_bias", "tr_bias"):
            values.zero_()
        else:
            values *= _fan_in(name, tuple(ref.shape)) ** -0.5
        state[name] = values
    return state


def load(ctx) -> dict[str, torch.Tensor]:
    """The configuration's shipped weights, or the state_dict a test gives it."""
    if "state_dict" in ctx.config:
        return ctx.config["state_dict"]
    return read_pretrained(str(ctx.root / ctx.config["weights"]))
