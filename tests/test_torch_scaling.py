"""The port's batch-scaling study (`train/scaling.py`) on the CPU, beside the
JAX package's: rows with the JAX row's field names from real measurements
at batches 2 and 4 (a few steps each; step times on the CPU, MFU None
without a card), an out-of-memory rung recorded as the JAX study records
it, and the GRU kernels' FLOPs equal to the work chip_smoke.py bounds them by.
"""

import functools
import json
import os

import pytest
import torch
from test_torch_train import _config

import chip_smoke
from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.train import scaling
from tinyrecurrentunet_tpu.train import scaling as jscaling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIELDS = {"batch", "dtype", "step_ms", "steps_per_sec", "audio_sec_per_sec", "mfu", "gflops_per_step"}


def test_run_study_rows_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(scaling, "measure_train_step",
                        functools.partial(scaling.measure_train_step, reps_hi=2, reps_lo=1))
    out = tmp_path / "scaling.json"
    result = scaling.run_study(_config(tconfig), [2, 4], str(out), device="cpu")
    assert json.loads(out.read_text()) == result
    rows = result["scaling"]
    assert [(r["batch"], r["dtype"]) for r in rows] == [(2, "float32"), (2, "bfloat16"), (4, "float32"),
                                                        (4, "bfloat16")]
    for row in rows:
        assert JAX_FIELDS <= row.keys()
        assert row["step_ms"] > 0 and row["mfu"] is None and row["device"] == "cpu"
        assert row["audio_sec_per_sec"] == pytest.approx(row["batch"] * 0.25 * row["steps_per_sec"])
        assert row["gflops_per_step"] > 0 and row["gru_kernel_gflops"] == 0
    # FLOPs grow with the batch and do not depend on the dtype
    assert rows[2]["gflops_per_step"] == pytest.approx(2 * rows[0]["gflops_per_step"], rel=0.05)
    assert rows[0]["gflops_per_step"] == rows[1]["gflops_per_step"]
    # the kernel A/B in float32 at the smallest and the largest batch that
    # fit; no lax.scan unroll A/B
    ab = result["train_kernel_ab"]
    assert [(r["batch"], r["dtype"], r["use_pallas_gru"]) for r in ab] == [
        (b, "float32", k) for b in (2, 4) for k in ("never", "always")]
    for row in ab:
        assert JAX_FIELDS <= row.keys() and row["step_ms"] > 0
    assert result["train_unroll_ab"] == [] and "lax.scan" in result["train_unroll_ab_note"]


def test_an_out_of_memory_rung_is_recorded_as_jax_records_it(monkeypatch):
    def fake(cfg, batch, dtype, **kw):
        if batch >= 8:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return {"batch": batch, "dtype": dtype, "step_ms": 1.0}

    def jfake(cfg, batch, dtype, **kw):
        if batch >= 8:
            raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory")
        return {"batch": batch, "dtype": dtype, "step_ms": 1.0}

    monkeypatch.setattr(scaling, "measure_train_step", fake)
    monkeypatch.setattr(jscaling, "measure_train_step", jfake)
    rows = scaling.run_study(_config(tconfig), [4, 8], None, device="cpu")["scaling"]
    assert rows[2:] == [{"batch": 8, "dtype": "float32", "oom": True}, {"batch": 8, "dtype": "bfloat16", "oom": True}]
    for dtype in ("float32", "bfloat16"):
        assert scaling.measure_or_oom(None, 8, dtype) == jscaling._measure_or_oom(None, 8, dtype)


def test_other_failures_raise(monkeypatch):
    def broken(*a, **kw):
        raise ValueError("not a memory problem")

    monkeypatch.setattr(scaling, "measure_train_step", broken)
    with pytest.raises(ValueError, match="memory problem"):
        scaling.measure_or_oom(None, 2, "float32")


@pytest.mark.parametrize("batch", [8, 64])
def test_gru_kernel_flops_are_chip_smokes_work(batch):
    """The flagship's three training launches, each kernel's FLOPs as
    chip_smoke.py's `train_kernel_work` counts them for the bound."""
    cfg = tconfig.load_config(os.path.join(REPO, "config", "proc16k.json"))
    frames = int(cfg.trainset.crop_length_sec * cfg.trainset.sample_rate) // cfg.featurizer.hop_length + 1
    fb = TRUNet(cfg.network, device="meta").bottleneck_freqs(cfg.featurizer.num_freqs)
    net, sms = cfg.network, 132
    want = 0
    for rows, steps, hidden in [(batch * frames, fb, net.fgru_hidden)] * 2 + [(batch * fb, frames, net.tgru_hidden)]:
        splits, _ = cuda_gru.dw_splits(rows * steps, hidden, sms)
        for kernel in ("gru_fwd_train", "gru_bwd", "gru_dw_partial", "gru_dw_sum"):
            want += chip_smoke.train_kernel_work(kernel, rows, steps, hidden, splits)[1]
    assert scaling.gru_kernel_flops(cfg, batch, sms) == want


def test_cli_needs_a_config():
    with pytest.raises(SystemExit):
        scaling.main([])
