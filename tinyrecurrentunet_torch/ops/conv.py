"""1-D conv / transposed conv with the JAX package's length semantics.

Counterpart of `tinyrecurrentunet_tpu/ops/conv.py`, on top of
`torch.nn.functional.conv1d` / `conv_transpose1d`. Activations keep the JAX
layout (B, L, C); weights are in torch's layouts, converted once from the
JAX layouts by `conv_weight_from_jax` / `conv_transpose_weight_from_jax`.

- conv:           L_out = (L + 2p - k)//s + 1
- conv_transpose: L_out = (L - 1)*s - 2p + k

The JAX transposed conv is zero-stuffing followed by an unflipped
correlation; torch's conv_transpose1d correlates with the flipped kernel, so
the taps are flipped once, in the weight conversion:
w_torch[cin, cout, j] = w_jax[k-1-j, cin, cout]. The `*_to_jax` functions
are the exact inverses, for weights the port writes back in JAX's layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def conv_weight_from_jax(w: np.ndarray) -> np.ndarray:
    """(k, Cin/groups, Cout) -> torch conv1d weight (Cout, Cin/groups, k)."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def conv_transpose_weight_from_jax(w: np.ndarray) -> np.ndarray:
    """(k, Cin, Cout) -> torch conv_transpose1d weight (Cin, Cout, k), taps flipped."""
    return np.ascontiguousarray(np.transpose(w[::-1], (1, 2, 0)))


def conv_weight_to_jax(w: np.ndarray) -> np.ndarray:
    """Inverse of `conv_weight_from_jax`: (Cout, Cin/groups, k) -> (k, Cin/groups, Cout)."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def conv_transpose_weight_to_jax(w: np.ndarray) -> np.ndarray:
    """Inverse of `conv_transpose_weight_from_jax`: (Cin, Cout, k) -> (k, Cin, Cout)."""
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1))[::-1])


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int,
    padding: int,
    groups: int = 1,
) -> torch.Tensor:
    """x (B, L, Cin), weight (Cout, Cin/groups, k) -> (B, L_out, Cout)."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int,
    padding: int,
) -> torch.Tensor:
    """x (B, L, Cin), weight (Cin, Cout, k) -> (B, (L-1)*stride - 2*padding + k, Cout)."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding)
    return y.transpose(1, 2)


def pad_or_crop(x: torch.Tensor, target_len: int, dim: int = -2) -> torch.Tensor:
    """Pad (or crop, for a negative diff) `dim` to target_len: diff//2 at the
    front (Python floor division, so a crop of an odd diff takes one more at
    the front), the remainder at the back."""
    cur = x.shape[dim]
    diff = target_len - cur
    if diff == 0:
        return x
    front, back = diff // 2, diff - diff // 2
    dim = dim % x.dim()
    if diff > 0:
        pads = [0, 0] * (x.dim() - 1 - dim) + [front, back]
        return F.pad(x, pads)
    return x.narrow(dim, -front, target_len)
