"""Phase-aware masks (PHM) and the denoising head.

Counterpart of `tinyrecurrentunet_tpu/models/phm.py`. The network emits two
stacked feature sets (mixture and noise estimates); the head turns them into
a complex mask on the noisy spectrogram and inverts the STFT.

- "bsigmoid" (the flagship's): the TRU-Net paper's beta-sigmoid complex mask.
  Magnitudes |M| = 2 sigmoid(zeta) for speech and noise; the speech mask's
  phase from the law of cosines (M_s + M_n = 1), its sign from tanh of a
  logit.
- "mixture": sigmoid(beta * phase difference) on the observed magnitude and
  phase.
- "network": the same mask on the magnitude and phase decoded from the
  network's own mixture feature set.
"""

from __future__ import annotations

import torch

from tinyrecurrentunet_torch.config import NetworkConfig
from tinyrecurrentunet_torch.signal.features import Featurizer, db_to_amp, denorm_db
from tinyrecurrentunet_torch.signal.phase import mod_phase


def phase_aware_mask(phase_mixture, phase_estimated, beta: float = 0.5):
    """sigmoid(beta * (phase_mixture - phase_estimated))."""
    return torch.sigmoid(beta * (phase_mixture - phase_estimated))


def bsigmoid_complex_mask(
    zeta_speech: torch.Tensor,
    zeta_noise: torch.Tensor,
    sign_logit: torch.Tensor,
    mask_ceiling: float = 2.0,
) -> torch.Tensor:
    """Complex speech mask from the speech/noise logits and the sign logit."""
    m_s = mask_ceiling * torch.sigmoid(zeta_speech)
    m_n = mask_ceiling * torch.sigmoid(zeta_noise)
    cos = torch.clamp((1.0 + m_s * m_s - m_n * m_n) / (2.0 * m_s + 1e-6), -1.0, 1.0)
    sin = torch.tanh(sign_logit) * torch.sqrt(torch.clamp(1.0 - cos * cos, min=1e-6))
    return torch.complex(m_s * cos, m_s * sin)


def split_feature_sets(output: torch.Tensor, num_channels: int):
    """(..., 2*C) network output -> (mixture, noise) sets of (..., C)."""
    return output[..., :num_channels], output[..., num_channels:]


def denoised_spec_from_output(
    output: torch.Tensor,
    featurizer: Featurizer,
    beta: float = 0.5,
    mixture_spec: torch.Tensor | None = None,
    source: str = "mixture",
) -> torch.Tensor:
    """Network output (..., T, F, 2*C) -> denoised complex spec (..., T, F)."""
    cfg = featurizer.config
    mix, noise = split_feature_sets(output, cfg.num_channels)

    if source == "bsigmoid":
        if mixture_spec is None:
            raise ValueError("source='bsigmoid' requires mixture_spec")
        mask = bsigmoid_complex_mask(mix[..., 0], noise[..., 0], mix[..., 1], mask_ceiling=2.0)
        return mask * mixture_spec

    mix_ch = featurizer.split_channels(mix)
    noise_ch = featurizer.split_channels(noise)
    phase_mix_est = mod_phase(mix_ch["real_demod"], mix_ch["imag_demod"])
    phase_noise = mod_phase(noise_ch["real_demod"], noise_ch["imag_demod"])
    mask = phase_aware_mask(phase_mix_est, phase_noise, beta)

    if source == "mixture":
        if mixture_spec is None:
            raise ValueError("source='mixture' requires mixture_spec")
        denoised_mag = mask * mixture_spec.abs()
        phase_out = mixture_spec.angle()
    elif source == "network":
        mix_mag = db_to_amp(denorm_db(mix_ch["logmag"], cfg.min_level_db, cfg.ref_level_db))
        denoised_mag = mask * mix_mag
        phase_out = phase_mix_est
    else:
        raise ValueError(f"unknown phm source {source!r}")
    return torch.complex(denoised_mag * torch.cos(phase_out), denoised_mag * torch.sin(phase_out))


def denoise_output_to_audio(
    output: torch.Tensor,
    featurizer: Featurizer,
    network_config: NetworkConfig,
    length: int | None = None,
    mixture_spec: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full head: network output -> denoised waveform (PHM + iSTFT)."""
    spec = denoised_spec_from_output(
        output,
        featurizer,
        network_config.phm_beta,
        mixture_spec=mixture_spec,
        source=network_config.phm_source,
    )
    return featurizer.istft(spec, length=length)
