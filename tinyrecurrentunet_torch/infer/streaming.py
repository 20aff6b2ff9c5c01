"""Streaming denoiser: hop-sized blocks in, blocks out, all state explicit.

Counterpart of `tinyrecurrentunet_tpu/infer/streaming.py`. One block step
slides the STFT window, runs the featurizer's streaming step (unwrap and
PCEN state), TRUNet with the TGRU carry, the PHM head and the iSTFT
overlap-add. The state stays on the denoiser's device, `cuda` unless the
caller asks for `cpu`; the step runs under `torch.inference_mode()` with the
model in eval mode, so on a card every GRU recurrence of a step goes through
the kernel `gru_fwd`: three launches a step (the FGRU's two directions at
rows x 16 x 64, the TGRU at 16 x chunk x 128 for the flagship).

Alignment contract (hop h, n_fft = 4h, centered offline STFT):
  output block k == offline-denoised samples [(k-3)h, (k-2)h)
i.e. 3 hops of algorithmic latency (24 ms at 16 kHz). The first blocks
differ from offline (zero-fill stands in for reflect padding); the
difference decays with the PCEN smoother and GRU forget gates, and the
phase-unwrap state differs only by multiples of 2*pi (sin/cos-invariant).

`chunk_frames=K` processes K hops per call: the same math as K single
steps (tested), one model call for K hops at K*hop latency; the TGRU walks
the K frames inside the call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tinyrecurrentunet_torch.config import Config
from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.models.phm import denoised_spec_from_output
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.signal.features import FeaturizerState
from tinyrecurrentunet_torch.signal.stft import frame_signal, overlap_add


class StreamState(NamedTuple):
    in_buffer: torch.Tensor  # (n_fft,) last n_fft input samples
    feat_state: FeaturizerState  # (F,) tensors, frame_count ()
    tgru_h: torch.Tensor  # (1, F_bottleneck, tgru_hidden)
    ola_buffer: torch.Tensor  # (n_fft,) overlap-add accumulator


class StreamCore:
    """The model, the featurizer and the step shared by the single- and the
    multi-stream denoiser; every tensor of a step has a leading stream axis."""

    def __init__(self, cfg: Config, state_dict: dict, chunk_frames: int = 1, device="cuda"):
        fz_cfg = cfg.featurizer
        if fz_cfg.n_fft % fz_cfg.hop_length != 0:
            raise ValueError("streaming requires hop | n_fft")
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = TRUNet(cfg.network, device=self.device)
        self.model.load_state_dict(state_dict)
        self.model.eval()
        self.featurizer = Featurizer(fz_cfg)
        self.frame_hop = fz_cfg.hop_length
        self.chunk_frames = chunk_frames
        self.hop = self.frame_hop * chunk_frames  # samples per call
        self.n_fft = fz_cfg.n_fft

    def _input(self, samples) -> torch.Tensor:
        """numpy or tensor samples -> float32 on the denoiser's device."""
        return torch.as_tensor(samples, dtype=torch.float32, device=self.device)

    def _spectra(self, in_buffer: torch.Tensor, blocks: torch.Tensor):
        """Slide the analysis window over new samples (N, k*hop): returns
        (the k new spectrum frames (N, k, F), the next input buffer)."""
        full = torch.cat([in_buffer, blocks], dim=-1)  # (N, n_fft + k*hop)
        frames = frame_signal(full, self.n_fft, self.frame_hop)[:, 1:]
        specs = torch.fft.rfft(frames, n=self.n_fft, dim=-1)
        return specs, full[:, blocks.shape[-1]:]

    def _advance(self, specs: torch.Tensor, feat_state: FeaturizerState, tgru_h, ola_buffer):
        """k spectrum frames of N streams (N, k, F) -> (out (N, k*hop),
        feat_state, tgru_h, ola_buffer) after them."""
        k, hop, n_fft = specs.shape[1], self.frame_hop, self.n_fft
        feats = []
        for i in range(k):
            feats_t, feat_state = self.featurizer.step_from_spec_frame(specs[:, i], feat_state)
            feats.append(feats_t)
        output, tgru_h = self.model(torch.stack(feats, dim=1), tgru_h)  # (N, k, F, 2C)
        net = self.cfg.network
        spec_out = denoised_spec_from_output(
            output, self.featurizer, net.phm_beta, mixture_spec=specs, source=net.phm_source
        )
        frames = torch.fft.irfft(spec_out, n=n_fft, dim=-1)  # (N, k, n_fft)
        total = overlap_add(frames, hop)  # (N, (k-1)*hop + n_fft), a new tensor
        total[:, :n_fft] += ola_buffer
        out = total[:, : k * hop] / float(n_fft // hop)
        ola = F.pad(total[:, k * hop :], (0, hop))
        return out, feat_state, tgru_h, ola


def _batched(state: FeaturizerState) -> FeaturizerState:
    return FeaturizerState(*(t[None] for t in state))


def _unbatched(state: FeaturizerState) -> FeaturizerState:
    return FeaturizerState(*(t[0] for t in state))


class StreamingDenoiser(StreamCore):
    """One stream, `chunk_frames` hops a call."""

    def init_state(self) -> StreamState:
        dev = self.device
        return StreamState(
            in_buffer=torch.zeros(self.n_fft, device=dev),
            feat_state=self.featurizer.init_state(device=dev),
            tgru_h=self.model.init_tgru_state(1, self.cfg.featurizer.num_freqs, device=dev),
            ola_buffer=torch.zeros(self.n_fft, device=dev),
        )

    @torch.inference_mode()
    def process_block(self, state: StreamState, block):
        """chunk_frames*hop samples in (numpy or tensor) -> (the same number
        of samples, delayed, as a tensor on the device; the new state)."""
        specs, in_buffer = self._spectra(state.in_buffer[None], self._input(block)[None])
        out, feat_state, tgru_h, ola = self._advance(
            specs, _batched(state.feat_state), state.tgru_h, state.ola_buffer[None]
        )
        return out[0], StreamState(in_buffer[0], _unbatched(feat_state), tgru_h, ola[0])

    @torch.inference_mode()
    def process_spec_frame(self, state: StreamState, spec_t):
        """Per-frame step from an externally computed complex STFT frame
        (F,): fed the offline STFT frames it reproduces the offline pipeline
        (no zero-fill startup transient). chunk_frames == 1 only."""
        if self.chunk_frames != 1:
            raise ValueError("process_spec_frame requires chunk_frames=1")
        spec_t = torch.as_tensor(spec_t, device=self.device)
        out, feat_state, tgru_h, ola = self._advance(
            spec_t[None, None], _batched(state.feat_state), state.tgru_h, state.ola_buffer[None]
        )
        return out[0], StreamState(state.in_buffer, _unbatched(feat_state), tgru_h, ola[0])

    def process(self, audio: np.ndarray):
        """Stream a whole waveform (L,) block by block; returns (the output
        (L,) as numpy, 3-hop latency included; the final state)."""
        audio = np.asarray(audio, np.float32)
        length = len(audio)
        audio = np.pad(audio, (0, (-length) % self.hop))
        samples = self._input(audio)
        state = self.init_state()
        blocks = []
        for i in range(0, len(audio), self.hop):
            out, state = self.process_block(state, samples[i : i + self.hop])
            blocks.append(out)
        return torch.cat(blocks).cpu().numpy()[:length], state
