"""Biquad low-pass of the synthetic data, a copy of the part of
`tinyrecurrentunet_tpu/data/augment.py` the port uses (RBJ audio-EQ
cookbook coefficients, scipy's lfilter). Host-side numpy/scipy."""

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
