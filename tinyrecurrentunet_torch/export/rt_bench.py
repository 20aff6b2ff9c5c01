"""Latency across engines, counterpart of `tinyrecurrentunet_tpu/export/rt_bench.py`
(the reference's rt.py, with every engine on the same clip and its units
labelled).

Every engine runs on the same seeded features of `onnx_config.time_step`
frames (0.3 N(0, 1), seed 0), on `device`:

- eager: the port's model, the whole clip in one call (on a card three
  `gru_fwd` launches a call), and one frame a call with the TGRU carry, the
  streaming regime (three `gru_fwd` launches at T = 1 a frame);
- int8: the port's model on the int8 pack's dequantized parameters, the
  whole clip;
- torchscript: the TorchScript artifact of `onnx_export.export_torchscript`
  loaded onto `device`, the whole clip: what users would ship, whose GRU is
  cuDNN's on a card. It stands where the JAX package's TFLite engine stood.

Keys: `clip_seconds`, `frames`, per engine `*_s` (seconds a call, a frame
for `eager_per_frame_s`) and `*_rtf` (seconds over the audio's seconds),
and `gru_fwd_per_call`, the `gru_fwd` launches a call of each engine
(on a card 3 for the port's model, 0 for the artifact; 0 on the CPU, where
the wrapper runs the plain version). Times come from `utils.profiling.throughput_seconds` (CUDA events
on a card, the host clock on the CPU).

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
from tinyrecurrentunet_torch.utils.profiling import throughput_seconds


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
              reps_hi: int = 24, reps_lo: int = 6, frame_reps_hi: int = 200, frame_reps_lo: int = 40) -> dict:
    """Seconds a call and RTF of each engine; `torchscript_path` is exported
    into a temporary directory when not given."""
    device = resolve_device(device)
    fz = cfg.featurizer
    frames = cfg.onnx_config.time_step
    clip_seconds = frames * fz.hop_length / fz.sample_rate
    hop_seconds = fz.hop_length / fz.sample_rate
    feats_tcf = onnx_export.export_features(cfg)
    feats = from_reference_layout(torch.from_numpy(feats_tcf)).to(device)
    results = {"clip_seconds": clip_seconds, "frames": frames, "gru_fwd_per_call": {}}

    def full_clip(name: str, model):
        def call():
            with torch.inference_mode():
                return model(feats)[0]

        sec, results["gru_fwd_per_call"][f"{name}_full_clip"] = _time(call, reps_hi, reps_lo)
        results[f"{name}_full_clip_s"] = sec
        results[f"{name}_full_clip_rtf"] = sec / clip_seconds

    model = onnx_export.float32_model(cfg, state_dict, device)
    full_clip("eager", model)

    carry = {"h": model.init_tgru_state(1, fz.num_freqs, device=device), "t": 0}

    def one_frame():
        t = carry["t"] % frames
        with torch.inference_mode():
            y, carry["h"] = model(feats[t : t + 1], carry["h"])
        carry["t"] += 1
        return y

    per_frame, results["gru_fwd_per_call"]["eager_per_frame"] = _time(one_frame, frame_reps_hi, frame_reps_lo)
    results["eager_per_frame_s"] = per_frame
    results["eager_streaming_rtf"] = per_frame / hop_seconds

    full_clip("int8", onnx_export.float32_model(cfg, int8_state_dict(state_dict), device))

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
