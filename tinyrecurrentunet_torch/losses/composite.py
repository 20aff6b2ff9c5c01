"""The composite training loss, counterpart of
`tinyrecurrentunet_tpu/losses/composite.py`.

noisy waveform -> features (no gradient: data) -> network -> PHM head on the
noisy spectrogram -> iSTFT -> waveform losses: ell_p, multi-resolution STFT,
and optionally the noise-side MR-STFT, cosine similarity and the auxiliary
feature-matching term. The gradient flows through the network, the head
and the iSTFT.
"""

from __future__ import annotations

import torch
from torch import nn

from tinyrecurrentunet_torch.config import LossConfig, NetworkConfig
from tinyrecurrentunet_torch.losses.cossim import cossim_loss
from tinyrecurrentunet_torch.losses.mrstft import MultiResolutionSTFTLoss
from tinyrecurrentunet_torch.models.phm import denoise_output_to_audio, split_feature_sets
from tinyrecurrentunet_torch.signal.features import Featurizer


@torch.no_grad()
def per_item_weights(clean_audio: torch.Tensor, noisy_audio: torch.Tensor) -> torch.Tensor:
    """w_i = mean_b rms(noise_b) / rms(noise_i), clipped to [1/4, 4], shape
    (B, 1) for (B, L) inputs; data only, so no gradient."""
    noise_ref = noisy_audio - clean_audio
    rms = torch.sqrt(torch.mean(noise_ref * noise_ref, dim=-1) + 1e-10)
    w = torch.clamp(torch.mean(rms) / (rms + 1e-6), 0.25, 4.0)
    return w[..., None]


def loss_fn(
    model: nn.Module,
    clean_audio: torch.Tensor,
    noisy_audio: torch.Tensor,
    featurizer: Featurizer,
    network_config: NetworkConfig,
    loss_config: LossConfig,
    tgru_h0: torch.Tensor | None = None,
):
    """The composite loss of (B, L) or (L,) waveforms.

    The model runs in the mode it is in: in training mode its BatchNorms use
    and update the batch statistics. `tgru_h0` is the TGRU carry-in of a
    TBPTT segment. Returns (loss, loss_dict, tgru_h); loss_dict holds the
    terms and "loss", as 0-dim tensors.
    """
    with torch.no_grad():
        noisy_spec = featurizer.spectrogram(noisy_audio)
        noisy_feat = featurizer.features_from_spec(noisy_spec)
    output, tgru_h = model(noisy_feat, tgru_h0)
    denoised = denoise_output_to_audio(
        output, featurizer, network_config, length=clean_audio.shape[-1], mixture_spec=noisy_spec
    )

    loss_dict = {}
    clean_eff, noisy_eff = clean_audio, noisy_audio
    if loss_config.per_item_norm and clean_audio.dim() >= 2:
        w = per_item_weights(clean_audio, noisy_audio)
        denoised = denoised * w
        clean_eff = clean_audio * w
        noisy_eff = noisy_audio * w

    err = denoised - clean_eff
    if loss_config.ell_p == 1:
        ell_p_loss = torch.mean(torch.abs(err))
    elif loss_config.ell_p == 2:
        ell_p_loss = torch.mean(err * err)
    else:
        raise ValueError(f"ell_p must be 1 or 2, got {loss_config.ell_p}")
    loss = loss_config.ell_p_lambda * ell_p_loss
    loss_dict["ell_p"] = ell_p_loss

    if loss_config.stft_lambda > 0:
        sc_loss, mag_loss = MultiResolutionSTFTLoss(loss_config.stft_config)(denoised, clean_eff)
        loss = loss + (sc_loss + mag_loss) * loss_config.stft_lambda
        loss_dict["stft_sc"] = sc_loss * loss_config.stft_lambda
        loss_dict["stft_mag"] = mag_loss * loss_config.stft_lambda

    if loss_config.noise_stft_lambda > 0:
        mrstft = MultiResolutionSTFTLoss(loss_config.stft_config)
        n_sc, n_mag = mrstft(noisy_eff - denoised, noisy_eff - clean_eff)
        loss = loss + (n_sc + n_mag) * loss_config.noise_stft_lambda
        loss_dict["noise_stft"] = (n_sc + n_mag) * loss_config.noise_stft_lambda

    if loss_config.cossim_lambda > 0:
        cs = cossim_loss(denoised, clean_eff)
        loss = loss + loss_config.cossim_lambda * cs
        loss_dict["cossim"] = cs

    if loss_config.aux_feature_lambda > 0:
        with torch.no_grad():
            clean_feat = featurizer(clean_audio)
            noise_feat = featurizer(noisy_audio - clean_audio)
        mix_est, noise_est = split_feature_sets(output, featurizer.config.num_channels)
        aux = torch.mean(torch.abs(mix_est - clean_feat)) + torch.mean(torch.abs(noise_est - noise_feat))
        loss = loss + loss_config.aux_feature_lambda * aux
        loss_dict["aux_feature"] = aux

    loss_dict["loss"] = loss
    return loss, loss_dict, tgru_h
