"""Multi-resolution STFT loss, counterpart of `tinyrecurrentunet_tpu/losses/mrstft.py`.

Per resolution: spectral convergence ||Y - X||_F / ||Y||_F and the mean
absolute log-magnitude difference, on Hann-windowed magnitudes (win_length
zero-padded to fft_size); both averaged over the bank and scaled by
sc_lambda / mag_lambda. `band="high"` keeps the upper half of the frequency
bins.
"""

from __future__ import annotations

import dataclasses

import torch

from tinyrecurrentunet_torch.config import STFTLossConfig
from tinyrecurrentunet_torch.signal.stft import hann_window, stft_magnitude


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """||Y - X||_F / ||Y||_F."""
    return torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """mean |log Y - log X|."""
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


@dataclasses.dataclass(frozen=True)
class MultiResolutionSTFTLoss:
    """Callable (x, y) -> (sc_loss, mag_loss); x, y are (..., T) waveforms,
    flattened to (B, T)."""

    config: STFTLossConfig = dataclasses.field(default_factory=STFTLossConfig)

    def __call__(self, x: torch.Tensor, y: torch.Tensor):
        cfg = self.config
        x = x.reshape(-1, x.shape[-1])
        y = y.reshape(-1, y.shape[-1])
        sc_loss = 0.0
        mag_loss = 0.0
        for fft_size, hop, win_length in zip(cfg.fft_sizes, cfg.hop_sizes, cfg.win_lengths):
            window = hann_window(win_length, device=x.device)
            x_mag = stft_magnitude(x, fft_size, hop, win_length, window)
            y_mag = stft_magnitude(y, fft_size, hop, win_length, window)
            if cfg.band == "high":
                half = x_mag.shape[-1] // 2
                x_mag = x_mag[..., half:]
                y_mag = y_mag[..., half:]
            sc_loss = sc_loss + spectral_convergence_loss(x_mag, y_mag)
            mag_loss = mag_loss + log_stft_magnitude_loss(x_mag, y_mag)
        n = len(cfg.fft_sizes)
        return sc_loss * cfg.sc_lambda / n, mag_loss * cfg.mag_lambda / n
