"""The featurizer: waveform <-> (..., T, F, C) feature tensors.

Counterpart of `tinyrecurrentunet_tpu/signal/features.py`: rectangular-window
STFT, then the channels in config order — normalised dB log-magnitude
clamped to [-1, 1], PCEN, and sin/cos of the phase unwrapped along time
(axis -2); `inverse` turns features back into a waveform. The streaming path (`init_state`, `step_from_spec_frame`) takes
one spectrum frame at a time and carries the unwrap and PCEN state in a
`FeaturizerState`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tinyrecurrentunet_torch.config import FeaturizerConfig
from tinyrecurrentunet_torch.signal.pcen import pcen, pcen_step
from tinyrecurrentunet_torch.signal.phase import demod_phase, mod_phase, unwrap_step
from tinyrecurrentunet_torch.signal.stft import istft as _istft
from tinyrecurrentunet_torch.signal.stft import stft as _stft


class FeaturizerState(NamedTuple):
    """Streaming carry of the featurizer, one entry per sequential op; the
    (F,) tensors may carry leading stream axes (..., F), frame_count (...)."""

    prev_phase: torch.Tensor  # raw phase of the previous frame
    unwrap_corr: torch.Tensor  # accumulated unwrap correction
    pcen_m: torch.Tensor  # PCEN smoother state
    frame_count: torch.Tensor  # int32, 0 before the first frame


def phase_of(spec: torch.Tensor) -> torch.Tensor:
    """The angle of each bin, 0 where the bin is exactly 0. torch.fft.rfft
    gives such a bin (digital silence, zero padding) a real part of -0.0
    about half the time, whose angle is pi; JAX's FFT gives +0.0 and 0."""
    return torch.where(spec.abs() == 0, torch.zeros_like(spec), spec).angle()


def amp_to_db(magnitude: torch.Tensor, ref_level_db: float = 25.0) -> torch.Tensor:
    """20*log10(clamp(mag, 1e-7)) - ref."""
    return 20.0 * torch.log10(torch.clamp(magnitude, min=1e-7)) - ref_level_db


def db_to_amp(db_spec: torch.Tensor) -> torch.Tensor:
    """10^(db/20)."""
    return torch.pow(10.0, db_spec / 20.0)


def norm_db(db_spec: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    """Scale dB values into [-1, 1]."""
    return torch.clamp(((db_spec - min_level_db) / -min_level_db) * 2.0 - 1.0, -1.0, 1.0)


def denorm_db(
    norm_spec: torch.Tensor, min_level_db: float = -100.0, ref_level_db: float = 25.0
) -> torch.Tensor:
    """Inverse of norm_db, re-adding the reference level."""
    return (
        ((torch.clamp(norm_spec, -1.0, 1.0) + 1.0) / 2.0) * -min_level_db
        + min_level_db
        + ref_level_db
    )


def to_reference_layout(features: torch.Tensor) -> torch.Tensor:
    """(..., T, F, C) -> (..., T, C, F), the reference's tensor layout, which
    the ONNX and TorchScript artifacts take and return."""
    return features.transpose(-1, -2)


def from_reference_layout(features: torch.Tensor) -> torch.Tensor:
    """(..., T, C, F) -> (..., T, F, C)."""
    return features.transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class Featurizer:
    """Waveform <-> feature-tensor transforms, parameterised by config."""

    config: FeaturizerConfig = dataclasses.field(default_factory=FeaturizerConfig)

    def spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
        """Complex STFT (..., T, F); rectangular window, center/reflect."""
        return _stft(audio, n_fft=self.config.n_fft, hop_length=self.config.hop_length)

    def _channel(self, name: str, magnitude, real_demod, imag_demod):
        c = self.config
        if name == "logmag":
            return norm_db(amp_to_db(magnitude, c.ref_level_db), c.min_level_db)
        if name == "pcen":
            return pcen(
                magnitude,
                eps=c.pcen_eps,
                s=c.pcen_s,
                alpha=c.pcen_alpha,
                delta=c.pcen_delta,
                r=c.pcen_r,
                dim=-2,
            )
        if name == "real_demod":
            return real_demod
        if name == "imag_demod":
            return imag_demod
        raise ValueError(name)

    def features_from_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """Complex spec (..., T, F) -> features (..., T, F, C)."""
        magnitude = spec.abs()
        real_demod, imag_demod = demod_phase(phase_of(spec), dim=-2)
        chans = [
            self._channel(name, magnitude, real_demod, imag_demod)
            for name in self.config.channels
        ]
        return torch.stack(chans, dim=-1)

    def init_state(self, streams: tuple = (), device=None) -> FeaturizerState:
        """The state before the first frame, for `streams` leading axes."""
        shape = tuple(streams) + (self.config.num_freqs,)
        return FeaturizerState(
            prev_phase=torch.zeros(shape, device=device),
            unwrap_corr=torch.zeros(shape, device=device),
            pcen_m=torch.zeros(shape, device=device),
            frame_count=torch.zeros(tuple(streams), dtype=torch.int32, device=device),
        )

    def step_from_spec_frame(self, spec_t: torch.Tensor, state: FeaturizerState):
        """One streaming step from a complex spectrum frame (..., F).

        Returns (features_t (..., F, C), new state). Fed the offline STFT
        frames one at a time it gives `features_from_spec`, up to the
        rounding of the unwrap's running sum.
        """
        c = self.config
        magnitude = spec_t.abs()
        raw_phase = phase_of(spec_t)
        # the first frame passes through: no previous frame to unwrap against
        started = (state.frame_count > 0)[..., None]
        prev_phase = torch.where(started, state.prev_phase, raw_phase)
        unwrapped, new_corr = unwrap_step(raw_phase, prev_phase, state.unwrap_corr)
        pcen_m = state.pcen_m
        chans = []
        for name in c.channels:
            if name == "logmag":
                chans.append(norm_db(amp_to_db(magnitude, c.ref_level_db), c.min_level_db))
            elif name == "pcen":
                out, pcen_m = pcen_step(
                    magnitude, state.pcen_m, eps=c.pcen_eps, s=c.pcen_s,
                    alpha=c.pcen_alpha, delta=c.pcen_delta, r=c.pcen_r,
                )
                chans.append(out)
            elif name == "real_demod":
                chans.append(torch.sin(unwrapped))
            elif name == "imag_demod":
                chans.append(torch.cos(unwrapped))
            else:
                raise ValueError(name)
        new_state = FeaturizerState(raw_phase, new_corr, pcen_m, state.frame_count + 1)
        return torch.stack(chans, dim=-1), new_state

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        """Waveform (..., L) -> features (..., T, F, C)."""
        return self.features_from_spec(self.spectrogram(audio))

    def split_channels(self, features: torch.Tensor) -> dict:
        """(..., C) feature tensor -> {channel_name: (...)} dict."""
        return {name: features[..., i] for i, name in enumerate(self.config.channels)}

    def complex_spec(
        self, logmag_norm: torch.Tensor, real_demod: torch.Tensor, imag_demod: torch.Tensor
    ) -> torch.Tensor:
        """The complex spec of a normalised log-magnitude and a demodulated
        phase: magnitude from `denorm_db`, phase re-modulated (`mod_phase`)."""
        wrap = mod_phase(real_demod, imag_demod)
        magnitude = db_to_amp(denorm_db(logmag_norm, self.config.min_level_db, self.config.ref_level_db))
        return torch.complex(magnitude * torch.cos(wrap), magnitude * torch.sin(wrap))

    def inverse(self, features: torch.Tensor, length: int | None = None) -> torch.Tensor:
        """Features (..., T, F, C) -> waveform (..., L), from the logmag and
        demod channels."""
        ch = self.split_channels(features)
        spec = self.complex_spec(ch["logmag"], ch["real_demod"], ch["imag_demod"])
        return self.istft(spec, length=length)

    def istft(self, spec: torch.Tensor, length: int | None = None) -> torch.Tensor:
        return _istft(
            spec, n_fft=self.config.n_fft, hop_length=self.config.hop_length, length=length
        )


class Float32Features:
    """The featurizer of a float64 reference train step that reads a float32
    run's own input features: the noisy spectrogram and its features are
    computed in float32 on `device` and cast up to float64 on the CPU; the
    network, the head, the iSTFT and the loss then run in float64. The
    rounding of the features moves float32 gradients of the flagship ten
    times more than the network's own arithmetic does (PERF.md), so a
    reference on its own float64 features cannot tell a fault from it.
    Passed as `make_train_step(cfg, featurizer=...)`."""

    def __init__(self, featurizer: Featurizer, device="cpu"):
        self.featurizer, self.device = featurizer, device

    def __getattr__(self, name):
        return getattr(self.featurizer, name)

    def spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
        spec = self.featurizer.spectrogram(audio.to(self.device, torch.float32))
        return spec.to("cpu", torch.complex128)

    def features_from_spec(self, spec: torch.Tensor) -> torch.Tensor:
        feats = self.featurizer.features_from_spec(spec.to(self.device, torch.complex64))
        return feats.to("cpu", torch.float64)
