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

The step runs in place, as the JAX package's jitted step runs over its
donated state (`jax.jit(step, donate_argnums=(1,))`): the denoiser owns the
state's buffers, a static input and a static output, and its step
(`StreamCore._step_into`) reads the state from the buffers and writes the
next state into them at its end. On the CPU `process_block` runs that body.
On a card its first call warms the body up on a side stream (the kernels'
build, cuFFT's plans, cuDNN's choices), captures one call of it into a CUDA
graph and replays the graph; every later call stages the block into the
static input through pinned host memory, replays the graph and copies the
output out: one graph launch a hop, where the body is ~320 launches. A
capture or a replay that fails raises; nothing falls back to the eager
body. `process_spec_frame`, a tool of the alignment tests, stays eager.
Each call is a `trunet.stream.call` of the port's recorder
(`utils/profiling.py`): its `adopt`, `stage`, `replay` and `copy_out` spans
(the first call also `trunet.graph.capture`) and, on a card, its device
interval from the staging copy to the output's clone.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tinyrecurrentunet_torch.config import Config
from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.models.phm import denoised_spec_from_output
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.signal.features import FeaturizerState
from tinyrecurrentunet_torch.signal.stft import frame_signal, overlap_add
from tinyrecurrentunet_torch.utils import graphs, profiling


class StreamState(NamedTuple):
    in_buffer: torch.Tensor  # (n_fft,) last n_fft input samples
    feat_state: FeaturizerState  # (F,) tensors, frame_count ()
    tgru_h: torch.Tensor  # (1, F_bottleneck, tgru_hidden)
    ola_buffer: torch.Tensor  # (n_fft,) overlap-add accumulator


class StreamCore:
    """The model, the featurizer, the state buffers and the step shared by
    the single- and the multi-stream denoiser; every tensor of a step has a
    leading stream axis of `num_streams`."""

    def __init__(self, cfg: Config, state_dict: dict, chunk_frames: int = 1, device="cuda", num_streams: int = 1):
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
        self.num_streams = num_streams
        n, dev = num_streams, self.device
        with torch.inference_mode():
            # in_buffer, the FeaturizerState's four tensors, tgru_h, ola_buffer
            self._buffers = (
                torch.zeros((n, self.n_fft), device=dev),
                *self.featurizer.init_state((n,), device=dev),
                self.model.init_tgru_state(n, fz_cfg.num_freqs, device=dev),
                torch.zeros((n, self.n_fft), device=dev),
            )
            self._in = torch.zeros((n, self.hop), device=dev)
            self._out = torch.zeros((n, self.hop), device=dev)
        on_card = dev.type == "cuda"
        self._pinned = torch.empty((n, self.hop), pin_memory=True) if on_card else None
        self._staged = torch.cuda.Event() if on_card else None  # the last copy out of _pinned
        self._graph = None
        self._graph_launches = None  # the kernels' launches one replay runs (cuda_gru.capture_tally)
        self._captures = 0

    def _input(self, samples) -> torch.Tensor:
        """numpy or tensor samples -> float32 on the denoiser's device."""
        return torch.as_tensor(samples, dtype=torch.float32, device=self.device)

    def _adopt(self, state):
        """Copies a state that is not the buffers into them: a fresh or a
        foreign state. The state the last call returned (`self._state`, the
        buffers as the public state holds them) is taken as it stands."""
        for mine, theirs in zip(_leaves(self._state), _leaves(state)):
            if theirs is mine:
                continue
            if theirs.shape != mine.shape:
                raise ValueError(f"state tensor of shape {tuple(theirs.shape)}, expected {tuple(mine.shape)}")
            mine.copy_(theirs)

    def _stage(self, blocks):
        """The samples (num_streams, hop) into the static input; on a card
        from host memory through the pinned buffer, without a sync."""
        shape = self._in.shape
        if isinstance(blocks, torch.Tensor) and blocks.device == self._in.device:
            if self._pinned is not None:
                profiling.device_begin()
            self._in.copy_(blocks.reshape(shape))
        elif self._pinned is None:
            self._in.copy_(torch.as_tensor(blocks, dtype=torch.float32).reshape(shape))
        else:
            self._staged.synchronize()  # the last call's copy has left the pinned buffer
            self._pinned.copy_(torch.as_tensor(blocks, dtype=torch.float32).reshape(shape))
            profiling.device_begin()
            self._in.copy_(self._pinned, non_blocking=True)
            self._staged.record()

    def _step_into(self):
        """The hop, in place: the staged samples and the state buffers in,
        the output buffer and the next state out. Every new value is a fresh
        tensor before it is copied back, so no write aliases a read."""
        in_buffer, prev_phase, unwrap_corr, pcen_m, frame_count, tgru_h, ola = self._buffers
        feat_state = FeaturizerState(prev_phase, unwrap_corr, pcen_m, frame_count)
        specs, next_in = self._spectra(in_buffer, self._in)
        out, next_feat, next_h, next_ola = self._advance(specs, feat_state, tgru_h, ola)
        self._out.copy_(out)
        for buf, new in zip(self._buffers, (next_in, *next_feat, next_h, next_ola)):
            buf.copy_(new)

    def _capture(self):
        """Warms the body up on a side stream (the state restored after),
        then captures one call of it into the denoiser's CUDA graph
        (`utils.graphs.capture`)."""
        saved = [b.clone() for b in self._buffers]

        def restore():
            for buf, b in zip(self._buffers, saved):
                buf.copy_(b)

        self._graph, self._graph_launches, _ = graphs.capture(self._step_into, restore)
        self._captures += 1

    @torch.inference_mode()
    def _process(self, state, blocks, replay: bool = True):
        """`process_block`'s work: the state adopted, the samples staged,
        the step run (on a card replayed from the graph, or with `replay`
        False as the uncaptured body, which the card tests and chip_smoke.py
        hold and time the graph against), the output copied out."""
        if tuple(np.shape(blocks)) != self._block_shape:
            raise ValueError(f"blocks of shape {tuple(np.shape(blocks))}, expected {self._block_shape}")
        on_card = self.device.type == "cuda"
        # the staging, the capture and the replay on the streams of the denoiser's card
        with profiling.span("trunet.stream.call"), \
                torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            with profiling.span("trunet.stream.adopt"):
                self._adopt(state)
            with profiling.span("trunet.stream.stage"):
                self._stage(blocks)
            if replay and on_card:
                if self._graph is None:
                    self._capture()
                with profiling.span("trunet.stream.replay"):
                    self._graph.replay()
                cuda_gru.add_launches(self._graph_launches)
            else:
                self._step_into()
            with profiling.span("trunet.stream.copy_out"):
                out = self._out.clone().reshape(self._block_shape)
                profiling.device_end()
            return out, self._state

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


def _leaves(state) -> tuple:
    """A StreamState's or MultiStreamState's tensors, in buffer order."""
    in_buffer, feat_state, tgru_h, ola_buffer = state
    return (in_buffer, *feat_state, tgru_h, ola_buffer)


def _batched(state: FeaturizerState) -> FeaturizerState:
    return FeaturizerState(*(t[None] for t in state))


def _unbatched(state: FeaturizerState) -> FeaturizerState:
    return FeaturizerState(*(t[0] for t in state))


class StreamingDenoiser(StreamCore):
    """One stream, `chunk_frames` hops a call.

    The state `process_block` returns is the denoiser's own buffers (views
    of them), and the next call advances them in place: pass it back as it
    is. Any other state (a fresh `init_state()`, one `process_spec_frame`
    returned, another denoiser's) is copied into the buffers first. As with
    the JAX package's donated state, a state an earlier call returned has
    been consumed once a later call has run: it reads as the latest state.
    """

    def __init__(self, cfg: Config, state_dict: dict, chunk_frames: int = 1, device="cuda"):
        super().__init__(cfg, state_dict, chunk_frames=chunk_frames, device=device)
        in_buffer, prev_phase, unwrap_corr, pcen_m, frame_count, tgru_h, ola = self._buffers
        self._state = StreamState(in_buffer[0], FeaturizerState(prev_phase[0], unwrap_corr[0], pcen_m[0],
                                                                frame_count[0]), tgru_h, ola[0])
        self._block_shape = (self.hop,)

    def init_state(self) -> StreamState:
        dev = self.device
        return StreamState(
            in_buffer=torch.zeros(self.n_fft, device=dev),
            feat_state=self.featurizer.init_state(device=dev),
            tgru_h=self.model.init_tgru_state(1, self.cfg.featurizer.num_freqs, device=dev),
            ola_buffer=torch.zeros(self.n_fft, device=dev),
        )

    def process_block(self, state: StreamState, block):
        """chunk_frames*hop samples in (numpy or tensor) -> (the same number
        of samples, delayed, as a tensor on the device; the new state, which
        is the denoiser's buffers)."""
        return self._process(state, block)

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
