"""Batched multi-stream denoiser: N concurrent real-time streams on one card.

Counterpart of `tinyrecurrentunet_tpu/infer/multistream.py`, the serving
mode for many streams: every per-stream state (sliding STFT window,
unwrap/PCEN carry, TGRU hidden, OLA tail) has a leading stream axis, and
one call advances all N streams by `chunk_frames` hops. The model batches
over its leading axis, so N streams cost the launches of one stream (three
`gru_fwd` a call on a card, the FGRU at N*k rows, the TGRU at N*16).

Each stream equals its own StreamingDenoiser run: the batch axis never
mixes streams (the convolutions are frame-local; the FGRU and TGRU batch
over streams x frames and streams x frequencies). On the CPU they agree to
float32 rounding; on a card cuDNN may choose another convolution algorithm
for another batch size, so a stream and its single run agree to a stated
tolerance (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tinyrecurrentunet_torch.infer.streaming import StreamCore
from tinyrecurrentunet_torch.signal.features import FeaturizerState


class MultiStreamState(NamedTuple):
    in_buffer: torch.Tensor  # (N, n_fft)
    feat_state: FeaturizerState  # tensors (N, F); frame_count (N,)
    tgru_h: torch.Tensor  # (N, F_b, H)
    ola_buffer: torch.Tensor  # (N, n_fft)


class MultiStreamDenoiser(StreamCore):
    """N streams, `chunk_frames` hops a call; N and chunk_frames are fixed
    when it is built, so one CUDA graph serves every call.

    The state `process_block` returns is the denoiser's own buffers, and the
    next call advances them in place: pass it back as it is. Any other state
    (a fresh `init_state()`, another denoiser's) is copied into the buffers
    first. As with the JAX package's donated state, a state an earlier call
    returned has been consumed once a later call has run: it reads as the
    latest state.
    """

    def __init__(self, cfg, state_dict: dict, num_streams: int, chunk_frames: int = 1, device="cuda"):
        super().__init__(cfg, state_dict, chunk_frames=chunk_frames, device=device, num_streams=num_streams)
        in_buffer, prev_phase, unwrap_corr, pcen_m, frame_count, tgru_h, ola = self._buffers
        self._state = MultiStreamState(in_buffer, FeaturizerState(prev_phase, unwrap_corr, pcen_m, frame_count),
                                       tgru_h, ola)
        self._block_shape = (num_streams, self.hop)

    def init_state(self) -> MultiStreamState:
        n, dev = self.num_streams, self.device
        return MultiStreamState(
            in_buffer=torch.zeros((n, self.n_fft), device=dev),
            feat_state=self.featurizer.init_state((n,), device=dev),
            tgru_h=self.model.init_tgru_state(n, self.cfg.featurizer.num_freqs, device=dev),
            ola_buffer=torch.zeros((n, self.n_fft), device=dev),
        )

    def process_block(self, state: MultiStreamState, blocks):
        """blocks (N, chunk_frames*hop) in -> (the same shape, delayed, on
        the device; the new state, which is the denoiser's buffers)."""
        return self._process(state, blocks)

    def process(self, audio: np.ndarray):
        """Stream N waveforms (N, L) block by block; returns ((N, L) numpy,
        the final state)."""
        audio = np.asarray(audio, np.float32)
        n, length = audio.shape
        if n != self.num_streams:
            raise ValueError(f"{n} waveforms for {self.num_streams} streams")
        audio = np.pad(audio, ((0, 0), (0, (-length) % self.hop)))
        samples = self._input(audio)
        state = self.init_state()
        outs = []
        for i in range(0, audio.shape[-1], self.hop):
            out, state = self.process_block(state, samples[:, i : i + self.hop])
            outs.append(out)
        return torch.cat(outs, dim=-1).cpu().numpy()[:, :length], state
