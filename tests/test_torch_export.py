"""The port's export (`export/onnx_export.py`, `export/export.py`) against the
JAX package, on the CPU.

- The export module (the port's model with `torch.nn.GRU` recurrences, in
  the reference's (T, C, F) layout) against the JAX forward
  (`use_pallas_gru="never"`) at full width on (23, 4, 257) features, with
  the initial running statistics and with them moved by 0.1: max_abs and
  max_rel below 1e-4, the JAX tests' tolerance (two implementations of the
  same float32 math; measured ~1e-7).
- `trunet.onnx` at time_step 16: over 1 MB of float32 weights, holding GRU
  and Conv ops.
- The TorchScript artifact, traced at T = 16, saved and reloaded: within
  1e-4 of JAX at T = 16, and it runs at T = 8.
- The forward and streaming-step programs (`torch.export`) round-trip
  against the port's eager model (its plain GRU) within rtol 1e-5 and atol
  1e-6, the JAX StableHLO test's tolerance, with the TGRU carry too.
- `optimize_onnx` raises ImportError without onnxruntime.
- The export CLI on a tiny network writes every artifact.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.export import export as texport
from tinyrecurrentunet_torch.export import onnx_export as tonnx
from tinyrecurrentunet_torch.export.quantize import save_quantized
from tinyrecurrentunet_torch.weights import artifact_meta, state_dict_from_variables, variables_from_state_dict
from tinyrecurrentunet_tpu.config import Config, FeaturizerConfig
from tinyrecurrentunet_tpu.models import TRUNet as JaxTRUNet

torch.set_num_threads(2)

TOL = 1e-4


def _port_config(time_step=251, **network):
    return tconfig.Config(
        network=tconfig.NetworkConfig(**network),
        featurizer=tconfig.FeaturizerConfig(sample_rate=16000),
        onnx_config=tconfig.ExportConfig(time_step=time_step),
    )


@pytest.fixture(scope="module")
def full_width():
    """The JAX package's full-width initial variables (numpy leaves), as its
    ONNX tests make them, and the port's state_dict of them."""
    from tinyrecurrentunet_tpu.train.state import create_train_state

    state = create_train_state(dataclasses.replace(Config(), featurizer=FeaturizerConfig(sample_rate=16000)))
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             {"params": state.params, "batch_stats": state.batch_stats})
    return variables, state_dict_from_variables(variables)


def _jax_forward_tcf(variables, feats_tcf):
    model = JaxTRUNet(dataclasses.replace(Config().network, use_pallas_gru="never"))
    y, _ = model.apply(variables, jnp.asarray(np.swapaxes(feats_tcf, -1, -2)))
    return np.swapaxes(np.asarray(y), -1, -2)


def _errors(ref, got):
    max_abs = float(np.abs(ref - got).max())
    return max_abs, max_abs / (float(np.abs(ref).max()) + 1e-12)


@pytest.mark.parametrize("stats_shift", [0.0, 0.1], ids=["initial-stats", "stats+0.1"])
def test_export_module_matches_jax_forward(full_width, stats_shift):
    variables, _ = full_width
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree.map(lambda a: a + np.float32(stats_shift), variables["batch_stats"])}
    feats = (np.random.default_rng(int(stats_shift * 10)).standard_normal((23, 4, 257)) * 0.3).astype(np.float32)
    module = tonnx.export_module(_port_config(), state_dict_from_variables(variables))
    with torch.no_grad():
        got = module(torch.from_numpy(feats)).numpy()
    assert got.shape == (23, 8, 257)
    max_abs, max_rel = _errors(_jax_forward_tcf(variables, feats), got)
    assert max_abs < TOL and max_rel < TOL, (max_abs, max_rel)


def test_export_module_runs_torch_gru_with_the_weights(full_width):
    _, state = full_width
    module = tonnx.export_module(_port_config(), state)
    fgru = module.model.GRUBlock_0.GRU_0.gru
    assert isinstance(fgru, torch.nn.GRU) and fgru.bidirectional
    torch.testing.assert_close(fgru.weight_hh_l0_reverse, state["GRUBlock_0.GRU_0.wh_bwd"].T, rtol=0, atol=0)
    torch.testing.assert_close(module.model.GRUBlock_1.GRU_0.gru.weight_ih_l0, state["GRUBlock_1.GRU_0.wi_fwd"].T,
                               rtol=0, atol=0)
    assert not module.training


def test_onnx_file_holds_gru_and_conv(full_width, tmp_path):
    _, state = full_width
    path = str(tmp_path / "trunet.onnx")
    report = tonnx.export_onnx(_port_config(time_step=16), state, path)
    assert report["path"] == path and report["size_bytes"] == os.path.getsize(path) > 1_000_000
    with open(path, "rb") as f:
        blob = f.read()
    assert b"GRU" in blob and b"Conv" in blob
    assert report["max_abs_err"] < TOL and report["max_rel_err"] < TOL


def test_torchscript_artifact_round_trip(full_width, tmp_path):
    variables, state = full_width
    cfg = _port_config(time_step=16)
    path = str(tmp_path / "trunet.ts.pt")
    report = tonnx.export_torchscript(cfg, state, path)
    assert report["size_bytes"] == os.path.getsize(path) > 1_000_000
    assert report["max_abs_err"] < TOL and report["max_rel_err"] < TOL, report
    module = torch.jit.load(path).eval()
    feats = tonnx.export_features(cfg, seed=5)
    with torch.no_grad():
        got = module(torch.from_numpy(feats)).numpy()
    max_abs, max_rel = _errors(_jax_forward_tcf(variables, feats), got)
    assert max_abs < TOL and max_rel < TOL, (max_abs, max_rel)
    # the trace leaves T free
    with torch.no_grad():
        y = module(torch.randn(8, 4, 257))
    assert y.shape == (8, 8, 257)


def test_programs_round_trip(full_width, tmp_path):
    _, state = full_width
    cfg = _port_config(time_step=16)
    paths = texport.export_program(cfg, state, str(tmp_path))
    model = tonnx.float32_model(cfg, state)
    feats = torch.from_numpy((np.random.default_rng(0).standard_normal((16, 257, 4))).astype(np.float32))
    fwd = texport.load_program(paths["forward"])
    with torch.no_grad():
        ref, _ = model(feats)
        got = fwd(feats)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)

    step = texport.load_program(paths["streaming_step"])
    h = model.init_tgru_state(1, 257)
    with torch.no_grad():
        for t in range(3):  # the carry goes round
            y, h_next = step(feats[t : t + 1], h)
            ref_y, ref_h = model(feats[t : t + 1], h)
            np.testing.assert_allclose(y.numpy(), ref_y.numpy(), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(h_next.numpy(), ref_h.numpy(), rtol=1e-5, atol=1e-6)
            h = h_next
    assert float(h.abs().max()) > 0


def test_optimize_onnx_requires_onnxruntime(tmp_path):
    try:
        import onnxruntime  # noqa: F401

        pytest.skip("onnxruntime present; the pass would run")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="onnxruntime"):
        tonnx.optimize_onnx(str(tmp_path / "x.onnx"))


def test_export_cli_writes_every_artifact(tmp_path, capsys):
    """The CLI on a tiny network at 8 frames: two programs, the ONNX and
    TorchScript files and the int8 pack, each printed with its size."""
    import json

    from tinyrecurrentunet_torch.infer.denoise import random_state_dict

    net = dict(encoder=[[8, 5, 2], [16, 3, 1], [16, 5, 2], [16, 3, 2]], fgru_hidden=8, fgru_out=8,
               tgru_hidden=16, tgru_out=8, decoder=[[8, 3, 2], [8, 5, 2], [8, 3, 1], [8, 5, 2]])
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps({"network": net, "featurizer": {"sample_rate": 16000},
                                  "onnx_config": {"time_step": 8}}))
    out = tmp_path / "export"
    result = texport.main(["-c", str(config), "--out", str(out), "--random_init"])
    names = {"trunet_forward.pt2", "trunet_step.pt2", "trunet.onnx", "trunet.ts.pt", "trunet_int8.trq"}
    assert names <= set(os.listdir(out))
    printed = capsys.readouterr().out
    for name in names:
        assert name in printed
    assert result["onnx"]["max_abs_err"] < TOL and result["torchscript"]["max_abs_err"] < TOL
    cfg = tconfig.load_config(str(config))
    variables = variables_from_state_dict(random_state_dict(cfg))
    save_quantized(str(tmp_path / "want.trq"), variables["params"], variables["batch_stats"], meta=artifact_meta(cfg))
    assert filecmp.cmp(out / "trunet_int8.trq", tmp_path / "want.trq", shallow=False)
