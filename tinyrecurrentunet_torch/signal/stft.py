"""STFT / iSTFT with torch.stft/istft semantics, in the (..., T, F) layout.

Counterpart of `tinyrecurrentunet_tpu/signal/stft.py`:

- center=True pads the signal by n_fft//2 on both sides (reflect).
- `window=None` is the rectangular (all-ones) window of length n_fft, the
  featurizer's; a shorter window is zero-padded symmetrically to n_fft.
- istft divides the overlap-add by the summed squared-window envelope where
  the envelope exceeds 1e-11, trims the center padding and returns `length`
  samples ((T-1)*hop by default).

The transforms are `torch.fft.rfft`/`irfft` (cuFFT on the card); framing is
`Tensor.unfold` and overlap-add is `F.fold`, both free of atomics.

`hann_window` and `stft_magnitude` serve the MR-STFT loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """torch.hann_window(periodic=True): 0.5 - 0.5 cos(2 pi n / N), float32,
    computed in float64 as the JAX package does."""
    n = np.arange(win_length)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.tensor(window, dtype=torch.float32, device=device)


def _pad_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    win_length = window.shape[0]
    if win_length == n_fft:
        return window
    lpad = (n_fft - win_length) // 2
    return F.pad(window, (lpad, n_fft - win_length - lpad))


def _window(window, n_fft, like: torch.Tensor) -> torch.Tensor:
    if window is None:
        return torch.ones(n_fft, dtype=like.dtype, device=like.device)
    return _pad_window(window.to(like.dtype), n_fft)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Slice a (..., L) signal into (..., T, n_fft) frames, T = 1 + (L-n_fft)//hop
    (a view)."""
    return x.unfold(-1, n_fft, hop_length)


def overlap_add(frames: torch.Tensor, hop_length: int, length: int | None = None) -> torch.Tensor:
    """Inverse of frame_signal: (..., T, n_fft) frames -> (..., (T-1)*hop +
    n_fft) by summation, cut to the first `length` samples if given."""
    lead = frames.shape[:-2]
    num_frames, n_fft = frames.shape[-2:]
    total = (num_frames - 1) * hop_length + n_fft
    cols = frames.reshape(-1, num_frames, n_fft).transpose(1, 2)
    out = F.fold(
        cols, output_size=(1, total), kernel_size=(1, n_fft), stride=(1, hop_length)
    )
    out = out.reshape(lead + (total,))
    return out if length is None else out[..., :length]


def stft(
    x: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 128,
    window: torch.Tensor | None = None,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Complex STFT of a (..., L) signal -> (..., T, F), F = n_fft//2+1."""
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode=pad_mode)[:, 0]
    frames = frame_signal(x, n_fft, hop_length)  # (N, T, n_fft)
    if window is not None:
        frames = frames * _pad_window(window.to(x.dtype), n_fft)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.reshape(lead + spec.shape[-2:])


def istft(
    spec: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 128,
    window: torch.Tensor | None = None,
    center: bool = True,
    length: int | None = None,
) -> torch.Tensor:
    """Inverse STFT of (..., T, F) complex -> (..., L) real."""
    num_frames = spec.shape[-2]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    win = _window(window, n_fft, frames)
    signal = overlap_add(frames * win, hop_length)
    env = overlap_add((win * win).expand(num_frames, n_fft), hop_length)
    signal = signal / torch.where(env > 1e-11, env, torch.ones_like(env))

    full = signal.shape[-1]
    if center:
        pad = n_fft // 2
        out_len = full - 2 * pad if length is None else length
        if out_len > full:
            raise ValueError(f"length {out_len} exceeds the {full} samples of the OLA")
        # lax.dynamic_slice clamps the start so the slice stays in range
        start = min(pad, full - out_len)
        signal = signal[..., start : start + out_len]
    elif length is not None:
        signal = signal[..., :length]
    return signal


def stft_magnitude(
    x: torch.Tensor,
    fft_size: int,
    hop_size: int,
    win_length: int,
    window: torch.Tensor | None = None,
    clamp_min: float = 1e-7,
) -> torch.Tensor:
    """Magnitude spectrogram sqrt(clamp(re^2 + im^2, min)) of shape (..., T, F).

    The clamp before the square root keeps the gradient finite at silence.
    """
    if window is None:
        window = hann_window(win_length, device=x.device)
    spec = stft(x, n_fft=fft_size, hop_length=hop_size, window=window)
    power = spec.real**2 + spec.imag**2
    return torch.sqrt(torch.clamp(power, min=clamp_min))
