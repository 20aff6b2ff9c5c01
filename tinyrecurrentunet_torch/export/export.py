"""Model export: saved programs of the forward and the streaming step, and
the export CLI.

Counterpart of `tinyrecurrentunet_tpu/export/export.py`. Where the JAX
package serialises StableHLO, the port saves `torch.export` programs
(`.pt2`) of `onnx_export.export_module` in the JAX graphs' channels-last
layout:

- the forward: features (time_step, F, C) in, stacked feature sets
  (time_step, F, 2C) out, at `onnx_config.time_step`, as the reference
  exports its network (`onnx.py:31-44`, `config/tiny.json:57-61`);
- the streaming step: a frame (1, F, C) and the TGRU carry (1, Fb, H) in,
  the frame's output and the carry after it out.

Both run their GRUs as `torch.nn.GRU` (see `onnx_export`): the programs are
deployment artifacts, not the port's serving path. The CLI also writes the
ONNX file, the TorchScript file and the int8 weight pack, and prints each
with its size and parity. An export that fails raises.

TFLite, the JAX package's edge format, is not ported: it is TensorFlow's
format, its converter takes a JAX function, and PyTorch deploys through
ONNX and TorchScript, which this module writes.

Usage:
    python -m tinyrecurrentunet_torch.export.export -c config/proc16k.json \\
        --out exp/export [--pretrained artifacts/TRUNet-proc | --random_init | --ckpt_iter max]
"""

from __future__ import annotations

import argparse
import os

import torch

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.export import onnx_export
from tinyrecurrentunet_torch.export.quantize import int8_state_dict, save_quantized
from tinyrecurrentunet_torch.weights import artifact_meta, variables_from_state_dict


def export_program(cfg: Config, state_dict: dict, out_dir: str) -> dict:
    """Save the forward and streaming-step programs under `out_dir`;
    returns {"forward": path, "streaming_step": path}."""
    module = onnx_export.export_module(cfg, state_dict, reference_layout=False)
    freqs = cfg.featurizer.num_freqs
    channels = cfg.network.input_size
    feats = torch.zeros(cfg.onnx_config.time_step, freqs, channels)
    frame = torch.zeros(1, freqs, channels)
    carry = module.model.init_tgru_state(1, freqs)
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "forward": os.path.join(out_dir, "trunet_forward.pt2"),
        "streaming_step": os.path.join(out_dir, "trunet_step.pt2"),
    }
    for name, args in (("forward", (feats,)), ("streaming_step", (frame, carry))):
        torch.export.save(torch.export.export(module, args), paths[name])
    return paths


def load_program(path: str):
    """A saved program as a callable module."""
    return torch.export.load(path).module()


def int8_parity(cfg: Config, state_dict: dict, feats: torch.Tensor) -> dict:
    """The model on the int8 pack's dequantized parameters against the model
    on `state_dict`, both on the CPU."""
    with torch.no_grad():
        ref, _ = onnx_export.float32_model(cfg, state_dict)(feats)
        got, _ = onnx_export.float32_model(cfg, int8_state_dict(state_dict))(feats)
    return onnx_export.parity(ref, got)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    onnx_export.add_weights_args(parser)
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    state_dict = onnx_export.export_weights(cfg, args.pretrained, args.random_init, args.ckpt_iter)

    paths = export_program(cfg, state_dict, args.out)
    module = onnx_export.export_module(cfg, state_dict, reference_layout=False)
    feats = torch.from_numpy(onnx_export.export_features(cfg)).transpose(-1, -2)
    carry = module.model.init_tgru_state(1, cfg.featurizer.num_freqs)
    with torch.no_grad():
        programs = {
            "forward": (load_program(paths["forward"])(feats), module(feats)),
            "streaming_step": (load_program(paths["streaming_step"])(feats[:1], carry)[0], module(feats[:1], carry)[0]),
        }
    for name, (got, ref) in programs.items():
        report = onnx_export.parity(ref, got)
        print(f"program {name}: {paths[name]} ({os.path.getsize(paths[name]) / 1024:.1f} KB), "
              f"parity vs the export module: max_abs={report['max_abs_err']:.2e}")

    reports = onnx_export.write_artifacts(cfg, state_dict, args.out, args.opset)
    variables = variables_from_state_dict(state_dict)
    qpath = os.path.join(args.out, "trunet_int8.trq")
    size = save_quantized(qpath, variables["params"], variables["batch_stats"], meta=artifact_meta(cfg))
    report = int8_parity(cfg, state_dict, feats)
    print(f"int8 param pack: {qpath} ({size / 1024:.1f} KB), its dequantized model vs float32: "
          f"max_abs={report['max_abs_err']:.2e} max_rel={report['max_rel_err']:.2e}")
    return {"programs": paths, **reports, "int8": qpath}


if __name__ == "__main__":
    main()
