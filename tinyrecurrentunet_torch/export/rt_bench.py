"""Latency across engines, counterpart of `tinyrecurrentunet_tpu/export/rt_bench.py`
(the reference's rt.py, with every engine on the same clip and its units
labelled).

Every engine runs on the same seeded features of `onnx_config.time_step`
frames (0.3 N(0, 1), seed 0), on `device`. The port's model runs as the JAX
package's jitted programs do: each engine is one program on static tensors,
on a card captured into a CUDA graph after 3 warm-ups (`utils/graphs.py`)
and replayed at every call (`Engine`):

- graph: the port's model, the whole clip in one call (the JAX bench's
  `@jax.jit full`; on a card three `gru_fwd` launches a replay), and one
  frame a call with the TGRU carry (its `@jax.jit frame_step`, the streaming
  regime): each call copies frame t into a static frame input and replays a
  graph that writes the next carry into a static carry buffer in place, as
  the streaming step's donated carry (three `gru_fwd` at T = 1 a frame);
- int8: the full-clip program of the port's model on the int8 pack's
  dequantized parameters;
- torchscript: the TorchScript artifact of `onnx_export.export_torchscript`
  loaded onto `device`, the whole clip: what users would ship, whose GRU is
  cuDNN's on a card. It stands where the JAX package's TFLite engine stood,
  and runs as it is.

Keys: the JAX bench's with `jit_` renamed `graph_` and `tflite_` renamed
`torchscript_`: `clip_seconds`, `frames`, per engine `*_s` (seconds a call,
a frame for `graph_per_frame_s`) and `*_rtf` (seconds over the audio's
seconds); and `gru_fwd_per_call`, the `gru_fwd` launches a call of each
engine, as `cuda_gru.add_launches` counts a replay (on a card 3 for the
port's model, 0 for the artifact; 0 on the CPU, where the wrapper runs the
plain version). `run_bench(..., replay=False)` times the same engines'
bodies uncaptured, under the same keys. On the CPU every call runs the body.
Times come from `utils.profiling.throughput_seconds` (CUDA events on a
card, the host clock on the CPU).

Usage:
    python -m tinyrecurrentunet_torch.export.rt_bench -c config/proc16k.json \\
        [--pretrained artifacts/TRUNet-proc | --random_init] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.export import onnx_export
from tinyrecurrentunet_torch.export.quantize import int8_state_dict
from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.signal.features import from_reference_layout
from tinyrecurrentunet_torch.utils import graphs
from tinyrecurrentunet_torch.utils.profiling import throughput_seconds


class Engine:
    """`body()` on static tensors, returning its output. With `replay` on a
    card, captured at construction (warm-ups, then `restore()`) and replayed
    at every call; else the body runs at every call. A capture or a replay
    that fails raises."""

    def __init__(self, body, device: torch.device, replay: bool = True, restore=None):
        self.body = body
        self.graph = None
        if replay and device.type == "cuda":
            with torch.cuda.device(device), torch.inference_mode():
                self.graph, self.launches, self.output = graphs.capture(body, restore)

    @torch.inference_mode()
    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self.body()
        self.graph.replay()
        cuda_gru.add_launches(self.launches)
        return self.output


class FrameEngine(Engine):
    """The per-frame engine: each call copies frame t of `feats` (T, F, C)
    into the static frame input and steps the model one frame from the
    static TGRU carry, which it updates in place; t wraps around the clip.
    The carry starts from zeros (the warm-ups' carry is put back to them)."""

    def __init__(self, model, feats: torch.Tensor, num_freqs: int, replay: bool = True):
        with torch.inference_mode():
            self.feats = feats
            self.frame = torch.zeros_like(feats[:1])
            self.carry = model.init_tgru_state(1, num_freqs, device=feats.device)
        self.t = 0

        def body():
            y, h = model(self.frame, self.carry)
            self.carry.copy_(h)
            return y

        super().__init__(body, feats.device, replay, restore=self.carry.zero_)

    @torch.inference_mode()
    def __call__(self) -> torch.Tensor:
        t = self.t % self.feats.shape[0]
        self.frame.copy_(self.feats[t : t + 1])
        self.t += 1
        return super().__call__()


def engines(cfg: Config, state_dict: dict, feats: torch.Tensor, replay: bool = True) -> dict:
    """The bench's engines of the port's model on `feats` (T, F, C) on its
    device: {"graph_full_clip", "graph_per_frame", "int8_full_clip"}."""
    model = onnx_export.float32_model(cfg, state_dict, feats.device)
    int8 = onnx_export.float32_model(cfg, int8_state_dict(state_dict), feats.device)
    return {
        "graph_full_clip": Engine(lambda: model(feats)[0], feats.device, replay),
        "graph_per_frame": FrameEngine(model, feats, cfg.featurizer.num_freqs, replay),
        "int8_full_clip": Engine(lambda: int8(feats)[0], feats.device, replay),
    }


def _time(fn, reps_hi: int, reps_lo: int) -> tuple[float, float]:
    """(seconds a call, `gru_fwd` launches a call)."""
    calls = 0

    def call():
        nonlocal calls
        calls += 1
        return fn()

    before = cuda_gru.launches
    call()  # warm: cuDNN's algorithm choice, the kernels' build
    sec = throughput_seconds(call, lambda out: float(out.ravel()[0]), reps_hi, reps_lo)
    return sec, (cuda_gru.launches - before) / calls


def run_bench(cfg: Config, state_dict: dict, torchscript_path: str | None = None, device="cuda",
              reps_hi: int = 24, reps_lo: int = 6, frame_reps_hi: int = 200, frame_reps_lo: int = 40,
              replay: bool = True) -> dict:
    """Seconds a call and RTF of each engine; `torchscript_path` is exported
    into a temporary directory when not given. `replay` False times the
    port's engines uncaptured."""
    device = resolve_device(device)
    fz = cfg.featurizer
    frames = cfg.onnx_config.time_step
    clip_seconds = frames * fz.hop_length / fz.sample_rate
    hop_seconds = fz.hop_length / fz.sample_rate
    feats_tcf = onnx_export.export_features(cfg)
    feats = from_reference_layout(torch.from_numpy(feats_tcf)).to(device)
    results = {"clip_seconds": clip_seconds, "frames": frames, "gru_fwd_per_call": {}}
    port = engines(cfg, state_dict, feats, replay)
    for name, engine in port.items():
        per_frame = name.endswith("per_frame")
        hi, lo = (frame_reps_hi, frame_reps_lo) if per_frame else (reps_hi, reps_lo)
        sec, results["gru_fwd_per_call"][name] = _time(engine, hi, lo)
        if per_frame:
            results["graph_per_frame_s"] = sec
            results["graph_streaming_rtf"] = sec / hop_seconds
        else:
            results[f"{name}_s"] = sec
            results[f"{name}_rtf"] = sec / clip_seconds

    with tempfile.TemporaryDirectory() as tmp:
        path = torchscript_path or onnx_export.export_torchscript(cfg, state_dict, os.path.join(tmp, "trunet.ts.pt"))["path"]
        artifact = torch.jit.load(path, map_location=device).eval()
    x_tcf = torch.from_numpy(feats_tcf).to(device)

    def scripted():
        with torch.no_grad():  # a TorchScript module refuses inference tensors
            return artifact(x_tcf)

    sec, results["gru_fwd_per_call"]["torchscript_full_clip"] = _time(scripted, reps_hi, reps_lo)
    results["torchscript_full_clip_s"] = sec
    results["torchscript_full_clip_rtf"] = sec / clip_seconds
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--pretrained", default=None, help="dir with pretrained.npz")
    parser.add_argument("--ckpt_iter", default=None, help="checkpoint selector (default: the config's)")
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--torchscript", default=None, help="an exported trunet.ts.pt (default: export one)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    state_dict = onnx_export.export_weights(cfg, args.pretrained, args.random_init, args.ckpt_iter)
    results = run_bench(cfg, state_dict, args.torchscript, device=args.device)
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
