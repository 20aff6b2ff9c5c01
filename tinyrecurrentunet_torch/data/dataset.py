"""Synthetic clean/noisy pairs, a copy of `SyntheticPairDataset` of
`tinyrecurrentunet_tpu/data/dataset.py`: the same items for the same
(seed, index), so the port and the JAX package train on the same data.

The corpus datasets (`CleanNoisyPairDataset`, `ProceduralSpeechDataset`)
are a later slice of the port.
"""

from __future__ import annotations

import numpy as np

from tinyrecurrentunet_torch.data.augment import lowpass_biquad


class SyntheticPairDataset:
    """Harmonic 'speech-like' tones with band-limited noise, deterministic
    per (seed, index). Items: (clean (L,), noisy (L,), id)."""

    # Fixed-length in-memory items: the training loop keeps the whole corpus
    # on the device and gathers each batch there.
    device_cacheable = True

    def __init__(
        self,
        num_items: int = 64,
        length_sec: float = 2.0,
        sample_rate: int = 16000,
        snr_db: float = 5.0,
        seed: int = 0,
    ):
        self.num_items = num_items
        self.length = int(length_sec * sample_rate)
        self.sample_rate = sample_rate
        self.snr_db = snr_db
        self.seed = seed

    def __len__(self):
        return self.num_items

    def get(self, index: int, rng: np.random.Generator | None = None):
        rng = np.random.default_rng((self.seed, index))
        t = np.arange(self.length) / self.sample_rate
        f0 = rng.uniform(100.0, 300.0)
        clean = np.zeros(self.length, np.float32)
        for h in range(1, 5):
            clean += (0.3 / h) * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)
            ).astype(np.float32)
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t)).astype(np.float32)
        clean *= env * 0.3
        noise = rng.standard_normal(self.length).astype(np.float32)
        noise = lowpass_biquad(noise, self.sample_rate, self.sample_rate * 0.4)
        p_clean = np.mean(clean**2) + 1e-12
        p_noise = np.mean(noise**2) + 1e-12
        noise *= np.sqrt(p_clean / (p_noise * 10 ** (self.snr_db / 10)))
        return clean, clean + noise, f"synthetic_{index}"
