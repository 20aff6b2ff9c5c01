"""Segment-wise cosine-similarity loss, counterpart of
`tinyrecurrentunet_tpu/losses/cossim.py`: 1 - cosine similarity over the
progressive segments [0, 508), [508, 1016), [1016, 2032), [2032, 4062),
averaged over segments and batch; norms clamped below at eps."""

from __future__ import annotations

import torch

DEFAULT_SEGMENTS = (508, 1016, 2032, 4062)


def cossim_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    segments: tuple = DEFAULT_SEGMENTS,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x, y: (..., T) waveforms; returns a scalar."""
    if x.dim() == 1:
        x, y = x[None], y[None]
    total = 0.0
    prev = 0
    for g in segments:
        a, b = x[..., prev:g], y[..., prev:g]
        dot = torch.sum(a * b, dim=-1)
        na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=eps)
        nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=eps)
        total = total + torch.mean(1.0 - dot / (na * nb))
        prev = g
    return total / len(segments)
