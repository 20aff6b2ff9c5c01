"""ONNX and TorchScript artifacts of the port's model.

Counterpart of `tinyrecurrentunet_tpu/export/onnx_export.py`. The JAX
package rebuilds its network as a torch module with copied weights
(`build_torch_mirror`); here the module is the port's own model
(`export_module`): `models.TRUNet` in eval mode, BatchNorm on its running
statistics, behind edges in the reference's layout, features (T, C, F) in
and stacked feature sets (T, 2C, F) out (`config/tiny.json:57-61`). The one
difference from the serving model: its two GRU recurrences run as
`torch.nn.GRU` modules carrying the same weights (weight_ih = wi.T,
weight_hh = wh.T, the reverse direction in `*_reverse`), because the ctypes
kernels cannot be traced, the plain loop would unroll T steps into the
graph and pin T, and the ONNX file must hold `GRU` ops.

The artifacts are a deployment format: the model users ship. They are not
the port's serving path (`infer/`), and their GRU, cuDNN's on a card, is not
a port of any kernel. They compute in float32 whatever
`network.compute_dtype` says.

Without the `onnx` wheel, `torch.onnx.export` (its TorchScript exporter,
`dynamo=False`) still writes the ModelProto through its C++ writer, except
for one pass, `_add_onnxscript_fn`, that imports `onnx` and is the identity
for a graph with no custom onnxscript functions, as this one is.
`_patch_missing_onnx` replaces that pass with the identity when `onnx` is
absent. The ORT graph optimisation (`optimize_onnx`) needs onnxruntime and
raises ImportError without it.

Usage:
    python -m tinyrecurrentunet_torch.export.onnx_export -c config/proc16k.json \\
        --out exp/export [--pretrained artifacts/TRUNet-proc | --random_init] [--opset 13]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import os
import warnings

import numpy as np
import torch
from torch import nn

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.models.blocks import GRU
from tinyrecurrentunet_torch.ops import conv as conv_ops
from tinyrecurrentunet_torch.signal.features import from_reference_layout, to_reference_layout

# where torch keeps `_add_onnxscript_fn`, newest first
_ONNX_PROTO_UTILS = (
    "torch.onnx._internal.torchscript_exporter.onnx_proto_utils",
    "torch.onnx._internal.onnx_proto_utils",
)


def _patch_missing_onnx() -> bool:
    """Make torch.onnx.export work without the `onnx` wheel. Returns True if
    the patch was applied (`onnx` is missing)."""
    try:
        import onnx  # noqa: F401

        return False
    except ImportError:
        pass
    for name in _ONNX_PROTO_UTILS:
        try:
            module = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(module, "_add_onnxscript_fn"):
            # The real pass parses the proto, finds no custom function and
            # returns model_bytes unchanged.
            module._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
            return True
    raise ImportError(f"torch {torch.__version__} has none of {_ONNX_PROTO_UTILS}; install onnx")


class TorchGRU(nn.Module):
    """`blocks.GRU`'s contract, (outputs (B, L, H * directions), final h of
    the forward direction (B, H)), computed by a `torch.nn.GRU` with its
    weights."""

    def __init__(self, gru: GRU):
        super().__init__()
        wi = gru.wi_fwd
        self.gru = nn.GRU(wi.shape[0], gru.hidden, batch_first=True, bidirectional=gru.bidirectional,
                          device=wi.device)
        with torch.no_grad():
            for d, suffix in (("fwd", ""), ("bwd", "_reverse"))[: 2 if gru.bidirectional else 1]:
                getattr(self.gru, f"weight_ih_l0{suffix}").copy_(getattr(gru, f"wi_{d}").T)
                getattr(self.gru, f"weight_hh_l0{suffix}").copy_(getattr(gru, f"wh_{d}").T)
                getattr(self.gru, f"bias_ih_l0{suffix}").copy_(getattr(gru, f"bi_{d}"))
                getattr(self.gru, f"bias_hh_l0{suffix}").copy_(getattr(gru, f"bh_{d}"))

    def forward(self, x, h0=None):
        if h0 is None:
            # zeros made from x, so a trace keeps no device of its own
            h0 = torch.zeros_like(x[:, 0, :1]).expand(-1, self.gru.hidden_size)
        directions = 2 if self.gru.bidirectional else 1
        out, h_n = self.gru(x, h0[None].expand(directions, -1, -1).contiguous())
        return out, h_n[0]


class ExportModule(nn.Module):
    """The port's model with `TorchGRU` recurrences: in the reference's layout
    x (T, C, F) -> y (T, 2C, F), or channels last (the JAX export graphs'),
    x (T, F, C) -> y (T, F, 2C); given the TGRU carry (1, Fb, H), it also
    returns the carry after the last frame."""

    def __init__(self, model: TRUNet, reference_layout: bool = True):
        super().__init__()
        self.model = model
        self.reference_layout = reference_layout

    def forward(self, x, tgru_h0=None):
        if self.reference_layout:
            x = from_reference_layout(x)
        y, h = self.model(x, tgru_h0)
        if self.reference_layout:
            y = to_reference_layout(y)
        return y if tgru_h0 is None else (y, h)


def float32_model(cfg: Config, state_dict: dict, device="cpu") -> TRUNet:
    """The port's model of `cfg` in float32 and eval mode with `state_dict`."""
    model = TRUNet(dataclasses.replace(cfg.network, compute_dtype="float32"), device=device)
    model.load_state_dict(state_dict)
    return model.eval()


def export_module(cfg: Config, state_dict: dict, reference_layout: bool = True) -> ExportModule:
    """-> `ExportModule` on the CPU, eval mode, weights from `state_dict`."""
    model = float32_model(cfg, state_dict)
    for block in (model.GRUBlock_0, model.GRUBlock_1):
        block.GRU_0 = TorchGRU(block.GRU_0)
    return ExportModule(model, reference_layout).eval()


@contextlib.contextmanager
def _tracing():
    """Silences the tracer's warnings on `ops.conv.pad_or_crop`'s branches:
    they compare frequency lengths, which the config fixes. The time axis
    stays a traced size, so a trace runs at any number of frames."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=torch.jit.TracerWarning, module=conv_ops.__name__)
        yield


def export_features(cfg: Config, time_step: int | None = None, seed: int = 0) -> np.ndarray:
    """Seeded features (T, C, F) at the export shape, 0.3 N(0, 1)."""
    ex = cfg.onnx_config
    rng = np.random.default_rng(seed)
    shape = (time_step or ex.time_step, ex.channels, cfg.featurizer.num_freqs)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def parity(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """Max abs error, and it over the largest |ref|."""
    max_abs = float((ref.float() - got.float()).abs().max())
    return {"max_abs_err": max_abs, "max_rel_err": max_abs / (float(ref.abs().max()) + 1e-12)}


def onnx_parity_report(cfg: Config, state_dict: dict, feats_tcf: np.ndarray, module=None, device="cpu") -> dict:
    """`module` (default `export_module`) against the port's model on
    `device` (its GRU on the CUDA kernels on a card, the plain version on the
    CPU), both on (T, C, F) features."""
    module = module or export_module(cfg, state_dict)
    model = float32_model(cfg, state_dict, device)
    x = torch.from_numpy(feats_tcf)
    with torch.no_grad():  # a TorchScript module refuses inference tensors
        ref, _ = model(from_reference_layout(x).to(device))
        got = module(x.to(device))
    return parity(to_reference_layout(ref), got)


def export_onnx(cfg: Config, state_dict: dict, out_path: str, opset: int = 13) -> dict:
    """Write the ONNX file of `export_module` at the export shape; returns
    {path, size_bytes, opset, max_abs_err, max_rel_err} (module against the
    port's model on the CPU)."""
    _patch_missing_onnx()
    module = export_module(cfg, state_dict)
    dummy = torch.zeros(export_features(cfg).shape)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with _tracing():
        torch.onnx.export(
            module,
            (dummy,),
            out_path,
            opset_version=opset,
            input_names=["input"],
            output_names=["output"],
            do_constant_folding=True,
            dynamo=False,
        )
    report = onnx_parity_report(cfg, state_dict, export_features(cfg), module)
    return {"path": out_path, "size_bytes": os.path.getsize(out_path), "opset": opset, **report}


def export_torchscript(cfg: Config, state_dict: dict, out_path: str) -> dict:
    """Trace `export_module` at the export shape into a TorchScript file,
    reload it from disk and hold the artifact against the port's model on
    the CPU; returns {path, size_bytes, max_abs_err, max_rel_err}. The trace
    fixes the frequency axis (the config's) and leaves T free: the artifact
    runs at any number of frames."""
    module = export_module(cfg, state_dict)
    with torch.no_grad(), _tracing():
        traced = torch.jit.trace(module, torch.zeros(export_features(cfg).shape))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.jit.save(traced, out_path)
    report = onnx_parity_report(cfg, state_dict, export_features(cfg), torch.jit.load(out_path).eval())
    return {"path": out_path, "size_bytes": os.path.getsize(out_path), **report}


def optimize_onnx(path: str) -> str:
    """The reference's ORT graph optimisation (ORT_ENABLE_ALL) of an ONNX
    file; returns the optimised file's path. Raises ImportError naming
    onnxruntime where it is not installed."""
    try:
        import onnxruntime as ort
    except ImportError as e:
        raise ImportError(
            "onnxruntime is not installed; the ORT_ENABLE_ALL graph optimisation "
            "needs it. Install onnxruntime and call optimize_onnx again."
        ) from e
    opts = ort.SessionOptions()
    opts.graph_optimization_level = ort.GraphOptimizationLevel.ORT_ENABLE_ALL
    opts.optimized_model_filepath = path.replace(".onnx", "_optimized.onnx")
    ort.InferenceSession(path, opts)
    return opts.optimized_model_filepath


def export_weights(cfg: Config, pretrained: str | None, random_init: bool = False, ckpt_iter=None) -> dict:
    """The weights an export CLI writes: `<pretrained>/pretrained.npz`,
    seeded initial weights, or the checkpoint `ckpt_iter` selects."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser, random_state_dict
    from tinyrecurrentunet_torch.weights import load_pretrained

    if random_init:
        return random_state_dict(cfg)
    if pretrained:
        return load_pretrained(pretrained, cfg)
    return Denoiser.from_checkpoint(cfg, ckpt_iter, device="cpu").model.state_dict()


def add_weights_args(parser: argparse.ArgumentParser):
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--out", default="exp/export")
    parser.add_argument("--pretrained", default=None, help="dir with pretrained.npz")
    parser.add_argument("--ckpt_iter", default=None, help="checkpoint selector (default: the config's)")
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--opset", type=int, default=13, help="ONNX opset")


def write_artifacts(cfg: Config, state_dict: dict, out_dir: str, opset: int = 13) -> dict:
    """`trunet.onnx` and `trunet.ts.pt` under `out_dir`, each printed with
    its size and parity; then the ORT pass where onnxruntime is installed."""
    report = export_onnx(cfg, state_dict, os.path.join(out_dir, "trunet.onnx"), opset)
    print(f"onnx: {report['path']} ({report['size_bytes'] / 1024:.1f} KB, opset {report['opset']}), "
          f"parity vs the port's model: max_abs={report['max_abs_err']:.2e} max_rel={report['max_rel_err']:.2e}")
    ts = export_torchscript(cfg, state_dict, os.path.join(out_dir, "trunet.ts.pt"))
    print(f"torchscript: {ts['path']} ({ts['size_bytes'] / 1024:.1f} KB), parity vs the port's model: "
          f"max_abs={ts['max_abs_err']:.2e} max_rel={ts['max_rel_err']:.2e}")
    try:
        print(f"ORT-optimized: {optimize_onnx(report['path'])}")
    except ImportError as e:
        print(f"ORT optimization unavailable: {e}")
    return {"onnx": report, "torchscript": ts}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    add_weights_args(parser)
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    state_dict = export_weights(cfg, args.pretrained, args.random_init, args.ckpt_iter)
    return write_artifacts(cfg, state_dict, args.out, args.opset)


if __name__ == "__main__":
    main()
