"""`network.use_pallas_gru` in the port and the tools that read it: the
latency bench across engines (`export/rt_bench.py`), the GRU microbenchmark
(`ops/gru_bench.py`) and the kernel A/B of the scaling study
(`train/scaling.py run_kernel_ab`), on the CPU at a tiny size.

On the CPU "auto" and "always" run the plain versions through the kernels'
wrappers and "never" runs them directly, so the three give the same bits,
forward and backward. On a card, "never" launches none of the kernels
(tests/test_torch_cuda.py pins that by launch counts).
"""

import dataclasses
import functools
import inspect
import json
import re

import numpy as np
import pytest
import torch
from test_torch_train import _config

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.export import rt_bench
from tinyrecurrentunet_torch.infer.denoise import random_state_dict
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.models.blocks import GRU, init_parameters
from tinyrecurrentunet_torch.ops import cuda_gru, gru_bench
from tinyrecurrentunet_torch.train import scaling
from tinyrecurrentunet_tpu.export import rt_bench as jrt_bench
from tinyrecurrentunet_tpu.ops import gru_bench as jgru_bench

torch.set_num_threads(2)

JAX_FIELDS = {"batch", "dtype", "step_ms", "steps_per_sec", "audio_sec_per_sec", "mfu", "gflops_per_step"}


def _model(use_pallas_gru, train=True):
    cfg = dataclasses.replace(_config(tconfig).network, use_pallas_gru=use_pallas_gru)
    model = init_parameters(TRUNet(cfg), torch.Generator().manual_seed(0))
    return model.train(train)


def _outputs_and_grads(use_pallas_gru, train):
    model = _model(use_pallas_gru, train)
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((2, 9, 257, 4)) * 0.5).astype(np.float32))
    shape = model.init_tgru_state(2, 257).shape
    h0 = torch.from_numpy((np.random.default_rng(1).standard_normal(shape) * 0.1).astype(np.float32))
    h0.requires_grad_(True)
    y, h = model(x, h0)
    (y.square().sum() + h.sum()).backward()
    return [y.detach(), h.detach(), h0.grad] + [p.grad for p in model.parameters()]


@pytest.mark.parametrize("train", [True, False], ids=["train-mode", "eval-mode"])
@pytest.mark.parametrize("other", ["auto", "always"])
def test_never_and_the_kernel_values_give_the_same_bits_on_the_cpu(train, other):
    for a, b in zip(_outputs_and_grads("never", train), _outputs_and_grads(other, train)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_never_launches_no_kernel_wrapper(monkeypatch):
    """"never" runs `ops.gru` directly: the kernels' wrappers are not called,
    with or without a gradient."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called")

    for name in ("gru_recurrence", "gru_recurrence_train", "gru_recurrence_bwd"):
        monkeypatch.setattr(cuda_gru, name, refuse)
    model = _model("never")
    x = torch.randn(1, 5, 257, 4)
    model(x)[0].sum().backward()
    with torch.inference_mode():
        model.eval()(x)


@pytest.mark.parametrize("value", ["sometimes", "Never", ""])
def test_an_unknown_value_raises(value):
    with pytest.raises(ValueError, match="use_pallas_gru"):
        TRUNet(dataclasses.replace(tconfig.NetworkConfig(), use_pallas_gru=value))
    with pytest.raises(ValueError, match="use_pallas_gru"):
        GRU(4, 8, use_pallas_gru=value)


def test_the_config_value_reaches_both_grus():
    model = _model("never")
    assert model.GRUBlock_0.GRU_0.use_pallas_gru == model.GRUBlock_1.GRU_0.use_pallas_gru == "never"
    assert tconfig.NetworkConfig().use_pallas_gru == "auto"


def _rt_bench(replay=True):
    cfg = dataclasses.replace(_config(tconfig), onnx_config=tconfig.ExportConfig(time_step=12))
    return rt_bench.run_bench(cfg, random_state_dict(cfg), device="cpu", reps_hi=2, reps_lo=1,
                              frame_reps_hi=4, frame_reps_lo=1, replay=replay)


def _check_rt_bench_keys(results):
    # the JAX bench's keys, with its engines jit and tflite renamed graph and torchscript
    jax_keys = re.findall(r'results\["(\w+_(?:s|rtf))"\]', inspect.getsource(jrt_bench.run_bench))
    names = {k.replace("jit_", "graph_").replace("tflite_", "torchscript_") for k in jax_keys}
    assert set(results) == names | {"clip_seconds", "frames", "gru_fwd_per_call"}
    assert results["gru_fwd_per_call"] == {"graph_full_clip": 0, "graph_per_frame": 0, "int8_full_clip": 0,
                                           "torchscript_full_clip": 0}  # the plain version on the CPU
    assert len(names) == 8
    assert results["frames"] == 12 and results["clip_seconds"] == 12 * 128 / 16000
    for key in names:
        assert np.isfinite(results[key]) and results[key] > 0, key
    assert results["graph_streaming_rtf"] == pytest.approx(results["graph_per_frame_s"] / (128 / 16000))


def test_rt_bench_engines_report_the_jax_keys():
    _check_rt_bench_keys(_rt_bench())


def test_rt_bench_bodies_report_the_same_keys():
    """`replay=False` times the same engines' bodies under the same keys."""
    _check_rt_bench_keys(_rt_bench(replay=False))


def test_rt_bench_engines_compute_the_model_on_their_static_tensors():
    """The full-clip engines are the model (float32, int8-dequantized) on
    the clip; the per-frame engine steps the model one frame a call from a
    carry of zeros that it updates in place, wrapping around the clip: the
    bits of the eager loop it replaces."""
    from tinyrecurrentunet_torch.export import onnx_export
    from tinyrecurrentunet_torch.export.quantize import int8_state_dict

    cfg = dataclasses.replace(_config(tconfig), onnx_config=tconfig.ExportConfig(time_step=5))
    sd = random_state_dict(cfg)
    feats = torch.from_numpy((np.random.default_rng(0).standard_normal((5, 257, 4)) * 0.3).astype(np.float32))
    port = rt_bench.engines(cfg, sd, feats)
    model = onnx_export.float32_model(cfg, sd)
    with torch.no_grad():
        assert torch.equal(port["graph_full_clip"](), model(feats)[0])
        int8 = onnx_export.float32_model(cfg, int8_state_dict(sd))
        assert torch.equal(port["int8_full_clip"](), int8(feats)[0])
        h = model.init_tgru_state(1, 257)
        frame = port["graph_per_frame"]
        for t in (0, 1, 2, 3, 4, 0, 1):
            y, h = model(feats[t : t + 1], h)
            assert torch.equal(frame(), y), t
        assert torch.equal(frame.carry, h) and frame.t == 7


def test_gru_bench_rows():
    cases = ((3, 6, 5, 8, "tiny TGRU"), (7, 4, 6, 4, "tiny FGRU"))
    rows = gru_bench.run(reps=2, plain_reps=1, device="cpu", cases=cases)
    assert [r["case"] for r in rows] == ["tiny TGRU", "tiny FGRU"]
    for row, (r, t, _, _, _) in zip(rows, cases):
        assert (row["rows"], row["length"]) == (r, t) and row["device"] == "cpu"
        for key in ("plain_us", "cuda_us", "speedup"):
            assert np.isfinite(row[key]) and row[key] > 0
        assert row["max_abs_err"] == 0  # the wrapper runs the plain version on the CPU
    # the JAX bench's five cases
    source = inspect.getsource(jgru_bench.run)
    assert len(gru_bench.CASES) == 5
    for rows, length, d, h, label in gru_bench.CASES:
        assert f'({rows}, {length}, {d}, {h}, "{label}")' in source


def test_run_kernel_ab_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(scaling, "measure_train_step",
                        functools.partial(scaling.measure_train_step, reps_hi=2, reps_lo=1))
    out = tmp_path / "scaling.json"
    out.write_text(json.dumps({"scaling": [{"batch": 2}], "train_unroll_ab": []}))
    rows = scaling.run_kernel_ab(_config(tconfig), [2], str(out), device="cpu")
    assert [(r["batch"], r["dtype"], r["use_pallas_gru"]) for r in rows] == [(2, "float32", "never"),
                                                                             (2, "float32", "always")]
    for row in rows:
        assert JAX_FIELDS <= row.keys() and np.isfinite(row["step_ms"]) and row["step_ms"] > 0
        assert row["gru_kernel_gflops"] == 0  # no kernel on the CPU
    # the plain recurrence counted by FlopCounterMode either way
    assert rows[0]["gflops_per_step"] == rows[1]["gflops_per_step"]
    result = json.loads(out.read_text())
    assert result["scaling"] == [{"batch": 2}] and result["train_kernel_ab"] == rows


def test_kernel_ab_cli(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(scaling, "measure_train_step",
                        lambda cfg, batch, dtype, **kw: seen.append((batch, dtype, kw["use_pallas_gru"])) or
                        {"batch": batch, "dtype": dtype, "step_ms": 1.0})
    monkeypatch.setattr(scaling, "load_config", lambda path: _config(tconfig))
    out = tmp_path / "ab.json"
    rows = scaling.main(["-c", "x.json", "--kernel_ab_only", "--batches", "4,8", "--ab_dtypes", "float32,bfloat16",
                         "--out", str(out), "--device", "cpu"])
    assert seen == [(b, d, k) for b in (4, 8) for d in ("float32", "bfloat16") for k in ("never", "always")]
    assert json.loads(out.read_text())["train_kernel_ab"] == rows
    assert json.loads(out.read_text())["train_unroll_ab"] == []
