"""Offline denoising: waveform -> STFT -> features -> TRUNet -> PHM -> iSTFT.

Counterpart of `tinyrecurrentunet_tpu/infer/denoise.py`. `Denoiser` runs on
`cuda` unless the caller asks for `cpu`; asked for `cuda` on a machine
without a card it raises. On the card every GRU recurrence of the model
(the FGRU's two directions and the TGRU) goes through the CUDA kernel, three
launches a call. The CLI denoises one WAV, or walks the testing subset and
writes `enhanced_<fileid>` files in the reference's directory layout.

A call is padded up to a length bucket, as the JAX denoiser's is, and runs
as the JAX package's jitted call runs, one program a bucket
(`jax.jit(run)` and its compile cache): each bucket has a slot holding a
static input and a static output, and on a card a CUDA graph of the whole
call (featurize, TRUNet, PHM, iSTFT). The first call of a bucket warms the
body up on a side stream (the kernels' build, cuFFT's plans, cuDNN's
choices) and captures one run of it; every later call stages the padded
clip into the static input through pinned host memory, replays the graph
and copies the output out. All of a denoiser's graphs share one memory
pool: their inputs and outputs live outside it, the replays run one at a
time on one stream, and each output is copied out before the next replay.
A capture or a replay that fails raises; nothing falls back to the eager
body. On the CPU a call runs the body on the same slots. `Denoiser.run` is
the body, eager and uncaptured. Each call is a `trunet.denoise.call` of the
port's recorder (`utils/profiling.py`): its `stage`, `replay` and `copy_out`
spans (a bucket's first call also `trunet.graph.capture`), its `samples` and
`padded_samples` counts (the clip, the bucket less the clip) and, on a card,
its device interval from the staging copy to the copy out.

Usage:
    python -m tinyrecurrentunet_torch.infer.denoise -c config/proc16k.json \
        [--ckpt_iter max|N|pretrained] [--subset testing] \
        [--input x.wav -o y.wav] [--random_init] [--device cpu]

Weights: `pretrained` reads `<train.log.directory>/<exp_path>/pretrained.npz`;
`max` (the latest) and an iteration read the port's checkpoints under
`<train.log.directory>/<exp_path>/checkpoint/`; `--random_init` draws them
from `train.optimization.seed`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import numpy as np
import torch

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav
from tinyrecurrentunet_torch.data.dataset import CleanNoisyPairDataset
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.models.blocks import init_parameters
from tinyrecurrentunet_torch.models.phm import denoise_output_to_audio
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
from tinyrecurrentunet_torch.utils import graphs, profiling
from tinyrecurrentunet_torch.weights import load_pretrained


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; raises for `cuda` on a machine without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass
class _Slot:
    """One length bucket: its static input and output (bucket,) float32 on
    the denoiser's device, and on a card the pinned staging buffer, the
    CUDA graph and the kernels' launches one replay runs
    (`cuda_gru.capture_tally`)."""

    input: torch.Tensor
    output: torch.Tensor
    pinned: torch.Tensor | None = None
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict | None = None


class Denoiser:
    """Full-clip denoiser."""

    def __init__(self, cfg: Config, state_dict: dict, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = TRUNet(cfg.network, device=self.device)
        self.model.load_state_dict(state_dict)
        self.model.eval()
        self.featurizer = Featurizer(cfg.featurizer)
        self._slots: dict[int, _Slot] = {}  # bucket -> slot
        on_card = self.device.type == "cuda"
        self._staged = torch.cuda.Event() if on_card else None  # the last copy out of a pinned buffer
        self._pool = torch.cuda.graph_pool_handle() if on_card else None  # all of its graphs' memory pool
        self._captures = 0

    @classmethod
    def from_pretrained(cls, cfg: Config, directory: str, device="cuda") -> "Denoiser":
        """Weights from `<directory>/pretrained.npz`, checked against `cfg`."""
        return cls(cfg, load_pretrained(directory, cfg), device=device)

    @classmethod
    def from_checkpoint(cls, cfg: Config, ckpt_iter: str | int | None = None, device="cuda"):
        """Weights under cfg.train.log.directory/exp_path by selector:
        'pretrained', 'max' (the latest checkpoint) or an iteration
        (default: cfg.train.log.ckpt_iter). Sets `ckpt_step`; raises
        FileNotFoundError when the selector names no checkpoint."""
        selector = ckpt_iter if ckpt_iter is not None else cfg.train.log.ckpt_iter
        log = cfg.train.log
        if selector == "pretrained":
            denoiser = cls.from_pretrained(cfg, os.path.join(log.directory, cfg.train.exp_path), device)
            denoiser.ckpt_step = "pretrained"
            return denoiser
        payload = CheckpointManager(log.directory, cfg.train.exp_path).load(selector)
        if payload is None:
            raise FileNotFoundError(
                f"no checkpoint for selector {selector!r} under {log.directory}/{cfg.train.exp_path}"
            )
        denoiser = cls(cfg, payload["model"], device=device)
        denoiser.ckpt_step = int(payload["iter"])
        return denoiser

    @torch.inference_mode()
    def run(self, audio: torch.Tensor) -> torch.Tensor:
        """Denoise (..., L) float32 audio on the denoiser's device."""
        spec = self.featurizer.spectrogram(audio)
        feats = self.featurizer.features_from_spec(spec)
        output, _ = self.model(feats)
        return denoise_output_to_audio(
            output, self.featurizer, self.cfg.network, length=audio.shape[-1], mixture_spec=spec
        )

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """Denoise one waveform (L,) -> (L,), float32.

        The length is padded up to a bucket as the JAX denoiser does; the
        padding changes the last frames' features, so it is part of the
        output.
        """
        return self._denoise(audio)

    def _denoise(self, audio: np.ndarray, replay: bool = True) -> np.ndarray:
        """`__call__`'s work: the clip staged into its bucket's slot, the
        body run (on a card replayed from the bucket's graph, captured at
        the bucket's first call, or with `replay` False uncaptured, which
        the card tests and chip_smoke.py hold and time the graph against),
        the output copied out."""
        audio = np.ascontiguousarray(audio, dtype=np.float32)
        length = len(audio)
        on_card = self.device.type == "cuda"
        # the staging, the capture and the replay on the streams of the denoiser's card
        with profiling.span("trunet.denoise.call"), \
                torch.cuda.device(self.device) if on_card else contextlib.nullcontext(), torch.inference_mode():
            bucket = self._bucket(length, self.cfg.featurizer.hop_length)
            profiling.count("samples", length)
            profiling.count("padded_samples", bucket - length)
            slot = self._slot(bucket)
            with profiling.span("trunet.denoise.stage"):
                self._stage(slot, audio)
            if replay and on_card:
                if slot.graph is None:
                    self._capture(slot)
                with profiling.span("trunet.denoise.replay"):
                    slot.graph.replay()
                cuda_gru.add_launches(slot.launches)
            else:
                self._run_into(slot)
            with profiling.span("trunet.denoise.copy_out"):
                out = slot.output[:length].to("cpu", copy=True).numpy()
                profiling.device_end()
            return out

    def _slot(self, bucket: int) -> _Slot:
        """The bucket's slot, made at its first call."""
        slot = self._slots.get(bucket)
        if slot is None:
            on_card = self.device.type == "cuda"
            slot = _Slot(torch.zeros(bucket, device=self.device), torch.zeros(bucket, device=self.device),
                         torch.empty(bucket, pin_memory=True) if on_card else None)
            self._slots[bucket] = slot
        return slot

    def _stage(self, slot: _Slot, audio: np.ndarray):
        """The clip and the zeros that pad it to the bucket into the static
        input (all of it: a shorter clip must not read a longer one's tail);
        on a card through the pinned buffer, without a sync."""
        length = len(audio)
        if slot.pinned is None:
            slot.input[:length].copy_(torch.from_numpy(audio))
            slot.input[length:].zero_()
            return
        self._staged.synchronize()  # the last call's copy has left its pinned buffer
        slot.pinned[:length].copy_(torch.from_numpy(audio))
        slot.pinned[length:].zero_()
        profiling.device_begin()
        slot.input.copy_(slot.pinned, non_blocking=True)
        self._staged.record()

    def _run_into(self, slot: _Slot):
        """The body on the slot: its static input denoised into its static output."""
        slot.output.copy_(self.run(slot.input))

    def _capture(self, slot: _Slot):
        """Warms the body up on a side stream, then captures one run of it
        into the slot's CUDA graph, in the denoiser's shared memory pool
        (`utils.graphs.capture`)."""
        slot.graph, slot.launches, _ = graphs.capture(lambda: self._run_into(slot), pool=self._pool)
        self._captures += 1

    @staticmethod
    def _bucket(length: int, hop: int) -> int:
        """Smallest hop-multiple >= length on a 1/8-step geometric ladder."""
        min_len = 8 * hop
        if length <= min_len:
            return min_len
        size = min_len
        while size < length:
            size += max(size // 8, hop)
        return ((size + hop - 1) // hop) * hop


def random_state_dict(cfg: Config) -> dict:
    """Initial weights of cfg.network drawn from train.optimization.seed
    (`models.blocks.init_parameters`), for smoke runs without a checkpoint."""
    model = TRUNet(cfg.network, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(cfg.train.optimization.seed))
    return model.state_dict()


def denoise_directory(cfg: Config, ckpt_iter=None, subset: str = "testing", dump: bool = True,
                      device="cuda"):
    """Denoise the testing subset; returns a list of (fileid, enhanced) and
    optionally writes <gen.output_directory>/<exp_path>/speech/<step>/enhanced_<fileid>."""
    denoiser = Denoiser.from_checkpoint(cfg, ckpt_iter, device=device)
    dataset = CleanNoisyPairDataset(cfg.trainset, subset=subset)
    out_dir = os.path.join(cfg.gen.output_directory, cfg.train.exp_path, "speech", str(denoiser.ckpt_step))
    if dump:
        os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    results = []
    for i in range(len(dataset)):
        _, noisy, fileid = dataset.get(i, rng)
        enhanced = denoiser(noisy)
        if dump:
            write_wav(os.path.join(out_dir, f"enhanced_{fileid}"), enhanced, cfg.trainset.sample_rate)
        results.append((fileid, enhanced))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--ckpt_iter", default=None, help="max | iteration | pretrained")
    parser.add_argument("--subset", default="testing")
    parser.add_argument("--input", default=None, help="denoise a single WAV")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--random_init", action="store_true",
                        help="weights drawn from the config's seed, no checkpoint (smoke runs)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    # the port works in float32: keep cuDNN convolutions out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if not args.input:
        results = denoise_directory(cfg, args.ckpt_iter, args.subset, device=args.device)
        print(f"denoised {len(results)} files")
        return
    if args.random_init:
        denoiser = Denoiser(cfg, random_state_dict(cfg), device=args.device)
    else:
        denoiser = Denoiser.from_checkpoint(cfg, args.ckpt_iter, device=args.device)
    audio, sr = read_wav(args.input)
    if audio.ndim > 1:
        audio = audio[0]
    if sr != cfg.trainset.sample_rate:
        raise ValueError(f"input is {sr} Hz but config expects {cfg.trainset.sample_rate} Hz")
    out = denoiser(audio)
    out_path = args.output or args.input.replace(".wav", "_enhanced.wav")
    write_wav(out_path, out, sr)
    print(f"wrote {out_path} ({len(out)} samples)")


if __name__ == "__main__":
    main()
