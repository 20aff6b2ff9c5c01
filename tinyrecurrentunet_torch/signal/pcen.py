"""Per-Channel Energy Normalization (PCEN).

Counterpart of `tinyrecurrentunet_tpu/signal/pcen.py`: the IIR smoother
M[t] = (1-s) M[t-1] + s x[t], M[-1] = 0, then
(x / (M + eps)^alpha + delta)^r - delta^r.

The smoother is a blocked scan, a handful of ops whatever T is: inside each
block of 32 frames M is one product with the 32x32 lower-triangular matrix
s (1-s)^(t-u), and the carry from block to block is one product with the
lower-triangular matrix (1-s)^(32 (b-b')). Every power is a decay, so
nothing overflows (the closed form with (1-s)^-t reaches 5e13 at 10 s).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 32


def _decay_matrix(n: int, base: float, scale: float, like: torch.Tensor):
    """Lower-triangular (n, n) matrix scale * base^(i-j) for j <= i, else 0."""
    idx = torch.arange(n, dtype=torch.float64)
    diff = idx[:, None] - idx[None, :]
    mat = torch.where(diff >= 0, scale * base ** diff.clamp(min=0), torch.zeros(()))
    return mat.to(dtype=like.dtype, device=like.device)


def smoother(x: torch.Tensor, s: float, dim: int = -2):
    """M[t] = (1-s) M[t-1] + s x[t] along `dim`, M[-1] = 0."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    a = 1.0 - s
    nb = -(-n // _BLOCK)
    xb = F.pad(x, (0, nb * _BLOCK - n)).reshape(x.shape[:-1] + (nb, _BLOCK))
    inblock = xb @ _decay_matrix(_BLOCK, a, s, x).T  # (..., nb, B)
    ends = inblock[..., -1]  # (..., nb)
    carries = ends @ _decay_matrix(nb, a**_BLOCK, 1.0, x).T  # M at each block end
    prev = F.pad(carries, (1, 0))[..., :-1]  # M just before each block
    steps = (a ** torch.arange(1, _BLOCK + 1, dtype=torch.float64)).to(x)
    m = inblock + prev[..., None] * steps
    m = m.reshape(x.shape[:-1] + (nb * _BLOCK,))[..., :n]
    return m.movedim(-1, dim)


def pcen(
    x: torch.Tensor,
    eps: float = 1e-6,
    s: float = 0.025,
    alpha: float = 0.98,
    delta: float = 2.0,
    r: float = 0.5,
    dim: int = -2,
) -> torch.Tensor:
    """PCEN of a (..., T, F) magnitude; `dim` is the time axis."""
    m = smoother(x, s, dim)
    return (x / torch.pow(m + eps, alpha) + delta) ** r - delta**r


def pcen_step(
    x_t: torch.Tensor,
    m_prev: torch.Tensor,
    eps: float = 1e-6,
    s: float = 0.025,
    alpha: float = 0.98,
    delta: float = 2.0,
    r: float = 0.5,
):
    """One streaming PCEN step on a (..., F) frame: returns (pcen_t, m_t).

    Counterpart of `pcen_step` in `tinyrecurrentunet_tpu/signal/pcen.py`.
    From m_prev = 0 the first frame gives M[0] = s x[0], as `pcen` does.
    """
    m_t = (1.0 - s) * m_prev + s * x_t
    out = (x_t / torch.pow(m_t + eps, alpha) + delta) ** r - delta**r
    return out, m_t
