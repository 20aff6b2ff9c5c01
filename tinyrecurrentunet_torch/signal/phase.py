"""Phase demodulation / remodulation.

Counterpart of `tinyrecurrentunet_tpu/signal/phase.py`: the STFT phase is
unwrapped along time and fed to the network as (sin, cos) channels, and
remodulated with arctan2.

`unwrap` has np.unwrap semantics (period 2*pi, the tie rule of
`jnp.unwrap`). In exact arithmetic the unwrap corrections are multiples of
2*pi and sin/cos of the unwrapped phase equal sin/cos of the raw phase; in
float32 they are not, and the unwrapped phase grows to ~1e3 rad over a few
seconds, where one float32 step is ~1e-4. The demod features therefore carry
the rounding of the cumulative sum, and two sums taken in different orders
differ by ~1e-3 on a 4 s clip. So the cumulative sum here takes its additions
in the order of XLA's CPU cumsum (sequential within blocks of 16, block
totals summed the same way recursively), which reproduces the JAX reference
on the CPU bit for bit, and is deterministic on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_CUMSUM_BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right cumulative sum along the last axis, one add per step."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] += out[..., k - 1]
    return out


def blocked_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative sum along `dim` in the addition order of XLA's CPU cumsum.

    Sequential inside blocks of 16; the block totals are summed the same way
    (recursively) and added to each block as an exclusive prefix.
    """
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        out = _sequential_cumsum(x)
    else:
        nb = -(-n // _CUMSUM_BLOCK)
        xp = F.pad(x, (0, nb * _CUMSUM_BLOCK - n))
        inblock = _sequential_cumsum(xp.reshape(x.shape[:-1] + (nb, _CUMSUM_BLOCK)))
        totals = blocked_cumsum(inblock[..., -1])
        exclusive = F.pad(totals, (1, 0))[..., :-1]
        out = (inblock + exclusive[..., None]).reshape(x.shape[:-1] + (nb * _CUMSUM_BLOCK,))
        out = out[..., :n]
    return out.movedim(-1, dim)


def unwrap(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """np.unwrap (period 2*pi) along `dim`, shape-preserving."""
    if p.shape[dim] == 0:
        return p
    period = torch.tensor(2.0 * math.pi, dtype=p.dtype).item()
    interval = torch.tensor(period / 2, dtype=p.dtype).item()
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + interval, period) - interval
    # tie rule (tinyrecurrentunet_tpu/signal/phase.py:43): -pi -> +pi for dd > 0
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    ph_correct = torch.where(dd.abs() < interval, torch.zeros_like(dd), ddmod - dd)
    rest = p.narrow(dim, 1, p.shape[dim] - 1) + blocked_cumsum(ph_correct, dim)
    return torch.cat([p.narrow(dim, 0, 1), rest], dim=dim)


def unwrap_step(phase_t: torch.Tensor, prev_phase: torch.Tensor, prev_corr: torch.Tensor):
    """One streaming step of `unwrap` along time, on (..., F) frames.

    Counterpart of `unwrap_step` in `tinyrecurrentunet_tpu/signal/phase.py`:
    the correction of this frame is added to the running sum `prev_corr`.
    Returns (unwrapped phase_t, new correction). The running sum takes its
    additions one frame at a time, so over many frames it rounds otherwise
    than `unwrap`'s blocked cumsum (tests/test_torch_streaming.py).
    """
    period = torch.tensor(2.0 * math.pi, dtype=phase_t.dtype).item()
    interval = torch.tensor(math.pi, dtype=phase_t.dtype).item()
    dd = phase_t - prev_phase
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    ph_correct = torch.where(dd.abs() < interval, torch.zeros_like(dd), ddmod - dd)
    new_corr = prev_corr + ph_correct
    return phase_t + new_corr, new_corr


def demod_phase(phase: torch.Tensor, dim: int = -2):
    """(sin(unwrap), cos(unwrap)) along the time axis `dim`
    (`real_demod = sin`, `imag_demod = cos`)."""
    unwrapped = unwrap(phase, dim=dim)
    return torch.sin(unwrapped), torch.cos(unwrapped)


def mod_phase(real_demod: torch.Tensor, imag_demod: torch.Tensor) -> torch.Tensor:
    """Wrapped phase from demodulated channels; (0, 0) maps to phase 0."""
    both_zero = (real_demod == 0.0) & (imag_demod == 0.0)
    safe_real = torch.where(both_zero, torch.zeros_like(real_demod), real_demod)
    safe_imag = torch.where(both_zero, torch.ones_like(imag_demod), imag_demod)
    return torch.atan2(safe_real, safe_imag)
