"""The reference's signal path: features in NumPy, the head and the losses
in plain PyTorch.

Features (the network's input, a function of the data alone) are made on
the host. The spectra are float64 FFTs of a rectangular window, rounded to
complex64 as the program holds them. The channels, in the configuration's
order: the log-magnitude in dB, normalised to [-1, 1]; PCEN, whose
smoother M[t] = (1 - s) M[t-1] + s x[t] from M[-1] = 0 runs in float64;
and sin and cos of the phase unwrapped along time (np.unwrap's rule). The
unwrap adds its corrections in float32, in the order the program adds them
(one frame after another while streaming, and offline in blocks of 16
frames with the block totals summed the same way, the order the shipped
models were trained in): a phase unwrapped over minutes grows to ~1e4 rad,
where one float32 step is ~1e-3 rad, so the order of the sum is part of
what a float32 program computes.

Offline frames are centred (reflect padding); streaming frames start at
zeros before the first sample and drop nothing (`stream_frames`).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import lfilter

CUMSUM_BLOCK = 16


def frames(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(..., L) -> (..., 1 + (L - n_fft)//hop, n_fft)."""
    count = 1 + (x.shape[-1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(count)[:, None]
    return x[..., idx]


def spectra(frames_: np.ndarray) -> np.ndarray:
    return np.fft.rfft(frames_.astype(np.float64), axis=-1).astype(np.complex64)


def offline_spectra(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Centred STFT (..., T, F) of (..., L), T = 1 + L // hop."""
    pad = [(0, 0)] * (audio.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    return spectra(frames(np.pad(audio, pad, mode="reflect"), n_fft, hop))


def stream_spectra(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """The spectrum frame a stream makes at each hop of (..., K hop): frame k
    ends at sample (k + 1) hop, zeros before the first sample."""
    pad = [(0, 0)] * (audio.ndim - 1) + [(n_fft - hop, 0)]
    return spectra(frames(np.pad(audio, pad), n_fft, hop))


def _sequential_cumsum(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x, axis=-1, dtype=np.float32)  # one float32 add a step


def blocked_cumsum(x: np.ndarray) -> np.ndarray:
    """Cumulative float32 sum along the last axis, sequential in blocks of
    16, the block totals summed the same way and added to each block."""
    n = x.shape[-1]
    if n <= CUMSUM_BLOCK:
        return _sequential_cumsum(x)
    nb = -(-n // CUMSUM_BLOCK)
    xp = np.zeros(x.shape[:-1] + (nb * CUMSUM_BLOCK,), np.float32)
    xp[..., :n] = x
    inblock = _sequential_cumsum(xp.reshape(x.shape[:-1] + (nb, CUMSUM_BLOCK)))
    totals = blocked_cumsum(inblock[..., -1])
    exclusive = np.concatenate([np.zeros(x.shape[:-1] + (1,), np.float32), totals[..., :-1]], axis=-1)
    out = (inblock + exclusive[..., None]).reshape(x.shape[:-1] + (nb * CUMSUM_BLOCK,))
    return out[..., :n]


def unwrapped(phase: np.ndarray, streaming: bool) -> np.ndarray:
    """float32 phase (..., T, F) unwrapped along T: np.unwrap's corrections
    (period 2 pi, -pi taken as +pi where the step is positive), summed in
    the program's order."""
    phase = phase.astype(np.float32)
    pi, two_pi = np.float32(np.pi), np.float32(2 * np.pi)
    dd = np.diff(phase, axis=-2)
    ddmod = np.mod(dd + pi, two_pi) - pi
    ddmod = np.where((ddmod == -pi) & (dd > 0), pi, ddmod)
    correct = np.where(np.abs(dd) < pi, np.float32(0), ddmod - dd).astype(np.float32)
    correct = np.moveaxis(correct, -2, -1)
    total = _sequential_cumsum(correct) if streaming else blocked_cumsum(correct)
    total = np.moveaxis(total, -1, -2)
    return np.concatenate([phase[..., :1, :], phase[..., 1:, :] + total], axis=-2)


def features(spec: np.ndarray, fz: dict, streaming: bool) -> np.ndarray:
    """complex64 spectra (..., T, F) -> float32 features (..., T, F, C)."""
    mag = np.abs(spec)
    phase = np.where(mag == 0, np.float32(0), np.angle(spec)).astype(np.float32)
    chans = []
    for name in fz["channels"]:
        if name == "logmag":
            db = 20.0 * np.log10(np.maximum(mag.astype(np.float64), 1e-7)) - fz["ref_level_db"]
            chans.append(np.clip((db - fz["min_level_db"]) / -fz["min_level_db"] * 2.0 - 1.0, -1.0, 1.0))
        elif name == "pcen":
            s, x = fz["pcen_s"], mag.astype(np.float64)
            m = lfilter([s], [1.0, -(1.0 - s)], x, axis=-2)
            chans.append((x / (m + fz["pcen_eps"]) ** fz["pcen_alpha"] + fz["pcen_delta"]) ** fz["pcen_r"]
                         - fz["pcen_delta"] ** fz["pcen_r"])
        elif name in ("real_demod", "imag_demod"):
            ph = unwrapped(phase, streaming)
            chans.append(np.sin(ph) if name == "real_demod" else np.cos(ph))
        else:
            raise ValueError(f"unknown feature channel {name!r}")
    return np.stack(chans, axis=-1).astype(np.float32)


def bsigmoid_spec(output: torch.Tensor, spec: torch.Tensor, channels: int) -> torch.Tensor:
    """TRU-Net's beta-sigmoid complex mask applied to the noisy spectra:
    |M_s| = 2 sigmoid, M_s + M_n = 1 by the law of cosines, the sign of the
    phase from tanh of a logit."""
    mix, noise = output[..., :channels], output[..., channels:]
    m_s = 2.0 * torch.sigmoid(mix[..., 0])
    m_n = 2.0 * torch.sigmoid(noise[..., 0])
    cos = torch.clamp((1.0 + m_s * m_s - m_n * m_n) / (2.0 * m_s + 1e-6), -1.0, 1.0)
    sin = torch.tanh(mix[..., 1]) * torch.sqrt(torch.clamp(1.0 - cos * cos, min=1e-6))
    return torch.complex(m_s * cos, m_s * sin) * spec


def overlap_add(frames_: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., T, n_fft) -> (..., (T - 1) hop + n_fft), n_fft a multiple of hop."""
    *lead, count, n_fft = frames_.shape
    parts = n_fft // hop
    pieces = frames_.reshape(*lead, count, parts, hop)
    total = (count - 1 + parts) * hop
    out = 0
    for m in range(parts):
        piece = pieces[..., m, :].reshape(*lead, count * hop)
        out = out + torch.nn.functional.pad(piece, (m * hop, total - count * hop - m * hop))
    return out


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """Inverse of the centred rectangular STFT: overlap-add over the window
    count at each sample, the centre padding cut, `length` samples."""
    count = spec.shape[-2]
    signal = overlap_add(torch.fft.irfft(spec, n=n_fft, dim=-1), hop)
    env = overlap_add(torch.ones((count, n_fft), dtype=signal.dtype, device=signal.device), hop)
    signal = signal / torch.where(env > 1e-11, env, torch.ones_like(env))
    start = min(n_fft // 2, signal.shape[-1] - length)
    return signal[..., start:start + length]


def stft_magnitude(x: torch.Tensor, fft: int, hop: int, win: int) -> torch.Tensor:
    """Hann-windowed magnitude (B, T, F) for the MR-STFT loss, clamped below
    at 1e-7 in power."""
    window = torch.hann_window(win, periodic=True, dtype=torch.float64, device=x.device).to(x.dtype)
    spec = torch.stft(x, fft, hop, win, window, center=True, pad_mode="reflect", return_complex=True)
    spec = spec.transpose(-1, -2)
    return torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-7))
