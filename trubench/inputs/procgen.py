"""Seeded speech and noise, frozen so that later changes to the program
cannot change the benchmark's inputs.

Copied from the port at commit d4c8964: `_resonator`, `_envelope`,
`_VOWELS`, `synth_speech` and `synth_noise` from
`tinyrecurrentunet_torch/data/procgen.py:105-318` (the testsets' babble
only), `mix_at_snr` from `procgen.py:424-431`, and the low-pass biquad
from `tinyrecurrentunet_torch/data/augment.py:16-32`. `noisy_pair` is the
benchmark's own: one clean utterance, one additive noise, one SNR.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

ADDITIVE_KINDS = ("white", "pink", "band", "hum", "babble", "clicks", "modulated")
SNR_RANGE_DB = (-5.0, 25.0)  # the DNS-2020 recipe the shipped models were trained on


def _biquad_coeffs(sample_rate: float, cutoff: float, q: float):
    w0 = 2.0 * np.pi * cutoff / sample_rate
    alpha = np.sin(w0) / (2.0 * q)
    cosw = np.cos(w0)
    b = np.array([(1 - cosw) / 2, 1 - cosw, (1 - cosw) / 2])
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return b / a[0], a / a[0]


def lowpass_biquad(x: np.ndarray, sample_rate: float, cutoff: float, q: float = 0.7):
    b, a = _biquad_coeffs(sample_rate, cutoff, q)
    return lfilter(b, a, x).astype(np.float32)


def _resonator(x: np.ndarray, sr: int, freq: float, bw: float) -> np.ndarray:
    """Two-pole resonator (formant) filter."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * freq / sr
    a = np.array([1.0, -2.0 * r * np.cos(theta), r * r])
    b = np.array([1.0 - r])
    return lfilter(b, a, x)


def _envelope(n: int, sr: int, attack_s: float = 0.015, release_s: float = 0.03):
    """Raised-cosine attack/release envelope."""
    env = np.ones(n)
    a = min(int(attack_s * sr), n // 2)
    r = min(int(release_s * sr), n // 2)
    if a > 0:
        env[:a] = 0.5 * (1 - np.cos(np.pi * np.arange(a) / a))
    if r > 0:
        env[n - r :] = 0.5 * (1 + np.cos(np.pi * np.arange(r) / r))
    return env


# Vowel-ish formant targets (F1, F2, F3) in Hz — rough adult ranges.
_VOWELS = np.array(
    [
        (730, 1090, 2440),  # /a/
        (270, 2290, 3010),  # /i/
        (300, 870, 2240),  # /u/
        (530, 1840, 2480),  # /e/
        (570, 840, 2410),  # /o/
        (660, 1720, 2410),  # /ae/
        (490, 1350, 1690),  # /er/
    ],
    dtype=np.float64,
)


def synth_speech(rng: np.random.Generator, length: int, sr: int) -> np.ndarray:
    """Speech-like waveform: syllables of voiced vowels / fricatives / pauses."""
    out = np.zeros(length, np.float64)
    f0_base = rng.uniform(90.0, 240.0)
    pos = 0
    while pos < length:
        u = rng.uniform()
        if u < 0.55:  # voiced syllable
            dur = int(rng.uniform(0.10, 0.30) * sr)
            dur = min(dur, length - pos)
            if dur < int(0.02 * sr):
                break
            t = np.arange(dur) / sr
            # f0 contour: base + declination + vibrato-ish wander + jitter
            f0 = f0_base * (
                1.0
                + rng.uniform(-0.15, 0.25)
                - 0.1 * t / max(t[-1], 1e-6)
                + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
            )
            phase = np.cumsum(f0) / sr
            # glottal source: impulse train with shimmer
            pulses = np.zeros(dur)
            marks = np.nonzero(np.diff(np.floor(phase)) > 0)[0]
            pulses[marks] = 1.0 + 0.1 * rng.standard_normal(len(marks))
            # glottal pulse shaping: one-pole lowpass twice (-12 dB/oct)
            g = np.exp(-2.0 * np.pi * 250.0 / sr)
            src = lfilter([1 - g], [1, -g], pulses)
            src = lfilter([1 - g], [1, -g], src)
            # formant filter: interpolate between two vowels across the segment
            v0 = _VOWELS[rng.integers(len(_VOWELS))]
            v1 = _VOWELS[rng.integers(len(_VOWELS))]
            seg = np.zeros(dur)
            # piecewise-constant formant glide (8 subsegments)
            n_sub = 8
            edges = np.linspace(0, dur, n_sub + 1).astype(int)
            for k in range(n_sub):
                lo, hi = edges[k], edges[k + 1]
                if hi <= lo:
                    continue
                frac = (k + 0.5) / n_sub
                formants = v0 * (1 - frac) + v1 * frac
                sub = np.zeros(hi - lo)
                for fi, (ff, amp, bw) in enumerate(
                    zip(formants, (1.0, 0.63, 0.35), (90.0, 120.0, 160.0))
                ):
                    ff = min(ff, 0.45 * sr)
                    sub += amp * _resonator(src[lo:hi], sr, ff, bw)
                seg[lo:hi] = sub
            # radiation: first difference brightens the spectrum
            seg = np.diff(seg, prepend=0.0)
            # voiced segments carry most of speech's energy: normalize each
            # to a target level (the glottal low-pass otherwise leaves them
            # ~30 dB below the fricatives, inverting speech's balance)
            rms = np.sqrt(np.mean(seg**2) + 1e-12)
            seg *= rng.uniform(0.10, 0.20) / max(rms, 1e-9)
            seg *= _envelope(dur, sr)
            out[pos : pos + dur] += seg
            pos += dur
        elif u < 0.75:  # unvoiced fricative burst
            dur = int(rng.uniform(0.05, 0.15) * sr)
            dur = min(dur, length - pos)
            if dur < int(0.01 * sr):
                break
            noise = rng.standard_normal(dur)
            center = rng.uniform(2000.0, min(6000.0, 0.42 * sr))
            seg = _resonator(noise, sr, center, rng.uniform(500.0, 1500.0))
            # fricatives sit ~12-20 dB below the voiced level
            rms = np.sqrt(np.mean(seg**2) + 1e-12)
            seg *= rng.uniform(0.015, 0.04) / max(rms, 1e-9)
            seg *= _envelope(dur, sr)
            out[pos : pos + dur] += seg
            pos += dur
        else:  # pause
            pos += int(rng.uniform(0.05, 0.25) * sr)
    rms = np.sqrt(np.mean(out**2) + 1e-12)
    out *= rng.uniform(0.05, 0.12) / max(rms, 1e-6)
    return out.astype(np.float32)


def synth_noise(
    rng: np.random.Generator,
    length: int,
    sr: int,
    kind: str | None = None,
) -> np.ndarray:
    """One noise waveform of the requested kind, unit-ish RMS."""
    if kind is None:
        kind = ADDITIVE_KINDS[rng.integers(len(ADDITIVE_KINDS))]
    if kind == "white":
        x = rng.standard_normal(length)
    elif kind == "pink":
        spec = np.fft.rfft(rng.standard_normal(length))
        f = np.maximum(np.fft.rfftfreq(length, 1 / sr), 1.0)
        x = np.fft.irfft(spec / np.sqrt(f), n=length)
    elif kind == "band":
        center = rng.uniform(300.0, min(6000.0, 0.42 * sr))
        x = _resonator(rng.standard_normal(length), sr, center, rng.uniform(100.0, 2000.0))
    elif kind == "hum":
        base = rng.choice([50.0, 60.0])
        t = np.arange(length) / sr
        x = np.zeros(length)
        for h in range(1, 6):
            x += rng.uniform(0.2, 1.0) / h * np.sin(
                2 * np.pi * base * h * t + rng.uniform(0, 2 * np.pi)
            )
        x += 0.05 * rng.standard_normal(length)
    elif kind == "babble":
        x = np.zeros(length)
        for _ in range(5):
            x += synth_speech(rng, length, sr).astype(np.float64)
    elif kind == "clicks":
        x = np.zeros(length)
        n_clicks = max(int(length / sr * rng.uniform(3, 12)), 1)
        burst_len = int(0.008 * sr)
        burst_t = np.arange(burst_len)
        for _ in range(n_clicks):
            p = rng.integers(0, max(length - burst_len, 1))
            freq = rng.uniform(1500.0, min(5000.0, 0.4 * sr))
            burst = np.exp(-burst_t / (0.002 * sr)) * np.sin(
                2 * np.pi * freq / sr * burst_t
            )
            x[p : p + burst_len] += rng.uniform(0.5, 2.0) * burst
        x += 0.02 * rng.standard_normal(length)
    elif kind == "modulated":
        env_f = rng.uniform(0.5, 4.0)
        t = np.arange(length) / sr
        env = 0.3 + 0.7 * 0.5 * (1 + np.sin(2 * np.pi * env_f * t + rng.uniform(0, 2 * np.pi)))
        x = rng.standard_normal(length) * env
        x = lowpass_biquad(x, sr, min(4000.0, 0.4 * sr)).astype(np.float64)
    else:
        raise ValueError(f"unknown noise kind {kind!r}")
    rms = np.sqrt(np.mean(x**2) + 1e-12)
    return (x / max(rms, 1e-9)).astype(np.float32)


def mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    """Scale `noise` so the mixture has the requested SNR, return the mix."""
    p_clean = float(np.mean(clean.astype(np.float64) ** 2)) + 1e-12
    p_noise = float(np.mean(noise.astype(np.float64) ** 2)) + 1e-12
    scale = np.sqrt(p_clean / (p_noise * 10.0 ** (snr_db / 10.0)))
    return (clean + scale * noise).astype(np.float32)


def noisy_pair(rng: np.random.Generator, length: int, sr: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(clean, noisy) float32 of `length` samples: synthetic speech and one
    noise of `kind` mixed at an SNR drawn from SNR_RANGE_DB."""
    clean = synth_speech(rng, length, sr)
    noise = synth_noise(rng, length, sr, kind)
    return clean, mix_at_snr(clean, noise, float(rng.uniform(*SNR_RANGE_DB)))
