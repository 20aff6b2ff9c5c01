"""Noise augmentation: random gain + low/high-pass biquads, a copy of
`tinyrecurrentunet_tpu/data/augment.py` (numpy/scipy, host-side): the same
draws from the same `rng` give the same waveform.

Gain uniformly from {-12 .. -5 dB step 0.033}, low-pass cutoff {7k..10k step
100} (below 0.95 Nyquist), high-pass {800..1200 step 50}, Q=0.7, applied to
the noise waveform before mixing. Biquad coefficients follow the RBJ
audio-EQ cookbook; the low-pass also makes the synthetic data's noise."""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def _biquad_coeffs(sample_rate: float, cutoff: float, q: float, kind: str):
    w0 = 2.0 * np.pi * cutoff / sample_rate
    alpha = np.sin(w0) / (2.0 * q)
    cosw = np.cos(w0)
    if kind == "lowpass":
        b = np.array([(1 - cosw) / 2, 1 - cosw, (1 - cosw) / 2])
    elif kind == "highpass":
        b = np.array([(1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2])
    else:
        raise ValueError(kind)
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return b / a[0], a / a[0]


def lowpass_biquad(x: np.ndarray, sample_rate: float, cutoff: float, q: float = 0.7):
    b, a = _biquad_coeffs(sample_rate, cutoff, q, "lowpass")
    return lfilter(b, a, x).astype(np.float32)


def highpass_biquad(x: np.ndarray, sample_rate: float, cutoff: float, q: float = 0.7):
    b, a = _biquad_coeffs(sample_rate, cutoff, q, "highpass")
    return lfilter(b, a, x).astype(np.float32)


def apply_gain(x: np.ndarray, gain_db: float) -> np.ndarray:
    return (x * 10.0 ** (gain_db / 20.0)).astype(np.float32)


class DataAugment:
    """Randomized gain + band-limit augmentation for noise waveforms."""

    def __init__(
        self,
        sample_rate: int = 48000,
        min_gain: float = -12.0,
        max_gain: float = -5.0,
        gain_step: float = 0.033,
        lp_range: tuple = (7000, 10000, 100),
        hp_range: tuple = (800, 1200, 50),
        q: float = 0.7,
    ):
        self.sample_rate = sample_rate
        self.q = q
        self.gains = np.arange(min_gain, max_gain, gain_step)
        self.lp_freqs = np.arange(*lp_range)
        self.hp_freqs = np.arange(*hp_range)
        # keep cutoffs physical at low sample rates: at 16 kHz a 10 kHz
        # low-pass exceeds Nyquist
        nyquist = sample_rate / 2.0
        self.lp_freqs = self.lp_freqs[self.lp_freqs < nyquist * 0.95]
        if self.lp_freqs.size == 0:
            self.lp_freqs = np.array([nyquist * 0.9])

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        gain = rng.choice(self.gains)
        lp = rng.choice(self.lp_freqs)
        hp = rng.choice(self.hp_freqs)
        x = apply_gain(x, gain)
        x = lowpass_biquad(x, self.sample_rate, lp, self.q)
        x = highpass_biquad(x, self.sample_rate, hp, self.q)
        return x
