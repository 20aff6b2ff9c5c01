"""GRU in plain PyTorch: the CPU path and the oracle of the CUDA kernel.

Counterpart of `tinyrecurrentunet_tpu/ops/gru.py`, with torch.nn.GRU math:
gate order r, z, n; separate input and hidden biases, the hidden bias inside
r * (h @ Wh_n + bh_n). The input projection of all steps is one matmul
outside the recurrence; the recurrence walks a projected input.

Layouts: weights as the JAX package stores them, wi (D, 3H), wh (H, 3H),
bi and bh (3H,). Sequences are batch-major, x (B, L, D) and x_proj
(B, L, 3H), outputs (B, L, H).
"""

from __future__ import annotations

import torch


def gru_project_inputs(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    """Input projection of all steps: (..., D) @ (D, 3H) + (3H,)."""
    return torch.matmul(x, wi) + bi


def gru_cell(x_proj_t: torch.Tensor, h: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor):
    """One cell update from a projected input: x_proj_t (B, 3H), h (B, H)."""
    h_proj = torch.matmul(h, wh) + bh
    xr, xz, xn = x_proj_t.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_recurrence(
    x_proj: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """The recurrence over a projected input, x_proj (B, L, 3H), h0 (B, H).

    `reverse` walks time right to left; outputs stay aligned with the input
    positions. Returns (outputs (B, L, H), h at the last step walked (B, H)).
    """
    length = x_proj.shape[1]
    out = x_proj.new_empty(x_proj.shape[:2] + h0.shape[-1:])
    h = h0
    steps = range(length - 1, -1, -1) if reverse else range(length)
    for t in steps:
        h = gru_cell(x_proj[:, t], h, wh, bh)
        out[:, t] = h
    return out, h


def gru_scan(
    x: torch.Tensor,
    h0: torch.Tensor,
    wi: torch.Tensor,
    wh: torch.Tensor,
    bi: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """Full-sequence GRU, x (B, L, D) -> (outputs (B, L, H), final h (B, H))."""
    return gru_recurrence(gru_project_inputs(x, wi, bi), h0, wh, bh, reverse=reverse)
