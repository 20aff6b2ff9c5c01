"""Clean/noisy pair datasets, copies of `tinyrecurrentunet_tpu/data/dataset.py`
(numpy, host-side): the same items for the same index and `rng`.

- `CleanNoisyPairDataset`: training items mix a clean file with a random
  augmented noise file after a random crop ("mix" mode) or load DNS-style
  clean/noisy pairs ("pairs" mode); the testing subset loads the DNS
  no-reverb synthetic pairs sorted by fileid.
- `SyntheticPairDataset`: tones + filtered noise, deterministic per
  (seed, index), so training runs without a corpus on disk.

The procedural dataset (`ProceduralSpeechDataset`) is a later slice of the
port.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from tinyrecurrentunet_torch.config import TrainsetConfig
from tinyrecurrentunet_torch.data.audio_io import read_wav
from tinyrecurrentunet_torch.data.augment import DataAugment, lowpass_biquad


def _sorted_dns(names: Sequence[str]):
    """DNS test file names sort by their trailing `..._<snr>_<fileid>.wav`."""
    return sorted(names, key=_dns_key)


def _dns_key(name: str) -> str:
    return "_".join(name.split("_")[-2:])


class CleanNoisyPairDataset:
    """Items: (clean (L,), noisy (L,), fileid: str)."""

    def __init__(self, cfg: TrainsetConfig, subset: str = "training"):
        if subset not in ("training", "testing"):
            raise ValueError(f"subset must be training|testing, got {subset!r}")
        self.cfg = cfg
        self.subset = subset
        self.aug = DataAugment(sample_rate=cfg.sample_rate)
        root = cfg.root

        if subset == "training":
            clean_dir = os.path.join(root, "clean")
            self.files = [
                os.path.join(clean_dir, f) for f in sorted(os.listdir(clean_dir)) if f.endswith(".wav")
            ]
            if cfg.mode == "mix":
                noise_dir = os.path.join(root, cfg.noise_dir)
                self.noise_files = [
                    os.path.join(noise_dir, f) for f in sorted(os.listdir(noise_dir)) if f.endswith(".wav")
                ]
                if not self.noise_files:
                    raise FileNotFoundError(f"no noise wavs under {noise_dir}")
            else:  # pairs: parallel noisy/ directory
                noisy_dir = os.path.join(root, "noisy")
                self.pair_files = [os.path.join(noisy_dir, os.path.basename(f)) for f in self.files]
        else:
            # DNS-2020 layout, or a clean/noisy pair root given directly
            p = os.path.join(root, "datasets/test_set/synthetic/no_reverb")
            if not os.path.isdir(p):
                p = root
            clean = _sorted_dns(os.listdir(os.path.join(p, "clean")))
            noisy = _sorted_dns(os.listdir(os.path.join(p, "noisy")))
            self.files = []
            for c, n in zip(clean, noisy):
                if _dns_key(c) != _dns_key(n):
                    raise ValueError(f"unpaired test files {c} / {n}")
                self.files.append((os.path.join(p, "clean", c), os.path.join(p, "noisy", n)))

    def __len__(self):
        return len(self.files)

    def get(self, index: int, rng: np.random.Generator):
        cfg = self.cfg
        if self.subset == "testing":
            clean_path, noisy_path = self.files[index]
            clean, _ = read_wav(clean_path)
            noisy, _ = read_wav(noisy_path)
            return clean, noisy, os.path.basename(clean_path)

        path = self.files[index]
        clean, sr = read_wav(path)
        if clean.ndim > 1:
            clean = clean[0]
        crop = int(cfg.crop_length_sec * sr)

        if cfg.mode == "mix":
            noise_path = self.noise_files[rng.integers(len(self.noise_files))]
            noise, _ = read_wav(noise_path)
            if noise.ndim > 1:
                noise = noise[0]
            noise = self.aug(noise, rng)
            if crop > 0:
                clean = _random_crop(clean, crop, rng)
                noise = _fit_length(noise, crop, rng)
            else:
                noise = _fit_length(noise, len(clean), rng)
            noisy = clean + noise
        else:
            noisy, _ = read_wav(self.pair_files[index])
            if noisy.ndim > 1:
                noisy = noisy[0]
            if crop > 0:
                start = rng.integers(0, max(len(clean) - crop, 0) + 1)
                clean = clean[start : start + crop]
                noisy = noisy[start : start + crop]
        return clean, noisy, os.path.basename(path)


def _random_crop(x: np.ndarray, crop: int, rng: np.random.Generator):
    if len(x) <= crop:
        return _fit_length(x, crop, rng)
    start = rng.integers(0, len(x) - crop + 1)
    return x[start : start + crop]


def _fit_length(x: np.ndarray, length: int, rng: np.random.Generator):
    """Crop randomly or tile to reach `length` (a short noise file is tiled)."""
    if len(x) > length:
        start = rng.integers(0, len(x) - length + 1)
        return x[start : start + length]
    if len(x) < length:
        reps = int(np.ceil(length / max(len(x), 1)))
        x = np.tile(x, reps)
    return x[:length]


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
