"""The port's quality eval against the JAX package's, on the CPU: the copied
metrics, the procedural testset, the int8 pack reader and `run_quality_eval`
with the shipped flagship weights.

Tolerances (measured on the CPU):
- the metrics (SI-SDR, STOI, fwSegSNR, LLR, WSS, the PESQ estimate) and
  the materialized testset: bit-equal (the same numpy code on the same
  arrays; measured 0).
- the int8 pack: the dequantized parameters and the statistics bit-equal
  to JAX's (measured 0); the int8 Denoiser's waveform 1e-4 absolute, the
  bound of tests/test_torch_denoise.py.
- `run_quality_eval` on 2 files of 1 s, port against JAX, each metric of
  the enhanced set: 1e-3 relative, and SI-SDR 1e-3 dB (the waveforms are
  ~1e-5 apart, tests/test_torch_denoise.py; measured at most 3.9e-6
  relative, on WSS, and 4.6e-6 dB); the noisy baseline and the ideal-mask
  oracle report equal, the same keys, and the per-kind and per-band
  breakdowns over the same files.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import threadpoolctl
import torch

from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.data import procgen as tprocgen
from tinyrecurrentunet_torch.export import quantize as tquantize
from tinyrecurrentunet_torch.infer import evaluate as tevaluate
from tinyrecurrentunet_torch.infer import metrics as tmetrics
from tinyrecurrentunet_torch.infer import perceptual as tperceptual
from tinyrecurrentunet_torch.infer import pesq_est as tpesq_est
from tinyrecurrentunet_torch.infer import quality as tquality
from tinyrecurrentunet_torch.models import TRUNet as TTRUNet
from tinyrecurrentunet_torch.weights import variables_from_state_dict
from tinyrecurrentunet_tpu.config import load_config as jload_config
from tinyrecurrentunet_tpu.data import procgen as jprocgen
from tinyrecurrentunet_tpu.export import quantize as jquantize
from tinyrecurrentunet_tpu.infer import metrics as jmetrics
from tinyrecurrentunet_tpu.infer import perceptual as jperceptual
from tinyrecurrentunet_tpu.infer import pesq_est as jpesq_est
from tinyrecurrentunet_tpu.infer import quality as jquality

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "proc16k.json")
ARTIFACT = os.path.join(REPO, "artifacts", "TRUNet-proc")
TRQ = os.path.join(ARTIFACT, "model_int8.trq")
SR = 16000

@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """The metrics run many small numpy products. numpy's OpenBLAS starts a
    thread a core in every test worker, and beside the other workers those
    threads slowed this module twentyfold; one thread each keeps it at its
    serial time."""
    with threadpoolctl.threadpool_limits(limits=1, user_api="blas"):
        yield


METRICS = {
    "si_sdr": (lambda c, e: tmetrics.si_sdr(e, c), lambda c, e: jmetrics.si_sdr(e, c)),
    "stoi": (lambda c, e: tmetrics.stoi(c, e, SR), lambda c, e: jmetrics.stoi(c, e, SR)),
    "fwsegsnr": (lambda c, e: tperceptual.fwsegsnr(c, e, SR), lambda c, e: jperceptual.fwsegsnr(c, e, SR)),
    "llr": (lambda c, e: tperceptual.llr(c, e, SR), lambda c, e: jperceptual.llr(c, e, SR)),
    "wss": (lambda c, e: tperceptual.wss(c, e, SR), lambda c, e: jperceptual.wss(c, e, SR)),
    "pesq_estimate": (lambda c, e: tpesq_est.pesq_estimate(c, e, SR),
                      lambda c, e: jpesq_est.pesq_estimate(c, e, SR)),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_is_bit_equal_to_jax(name):
    """Seeded formant speech and the same speech with noise mixed in at 5 dB."""
    rng = np.random.default_rng(11)
    clean = tprocgen.synth_speech(rng, SR, SR)
    noisy = tprocgen.mix_at_snr(clean, tprocgen.synth_noise(rng, SR, SR, "babble"), 5.0)
    port, jax_fn = METRICS[name]
    got, want = port(clean, noisy), jax_fn(clean, noisy)
    assert np.isfinite(got) and got == want


@pytest.fixture(scope="module")
def testsets(tmp_path_factory):
    """The same 2 x 1 s testset materialized by each package."""
    root = tmp_path_factory.mktemp("testsets")
    kwargs = dict(num_files=2, length_sec=1.0, sample_rate=SR, seed=tquality.QUALITY_TESTSET_SEED)
    tprocgen.materialize_dns_testset(str(root / "port"), **kwargs)
    jprocgen.materialize_dns_testset(str(root / "jax"), **kwargs)
    return root


def test_testset_is_the_jax_testset(testsets):
    files = {}
    for pkg in ("port", "jax"):
        base = testsets / pkg
        files[pkg] = sorted(str(p.relative_to(base)) for p in base.rglob("*") if p.is_file())
    assert files["port"] == files["jax"] and len(files["port"]) == 5  # 2 clean, 2 noisy, the recipe
    for rel in files["port"]:
        assert (testsets / "port" / rel).read_bytes() == (testsets / "jax" / rel).read_bytes(), rel


def test_int8_pack_reads_as_jax_reads_it():
    """artifacts/TRUNet-proc/model_int8.trq: the quantized tensors, the
    dequantized parameters and the statistics bit-equal to JAX's."""
    assert tquantize.load_quantized_meta(TRQ) == jquantize.load_quantized_meta(TRQ) != {}
    quantized, stats = tquantize.load_quantized(TRQ)
    jquantized, jstats = jquantize.load_quantized(TRQ)
    assert quantized.keys() == jquantized.keys() and stats.keys() == jstats.keys()
    for name, (q, scale) in quantized.items():
        np.testing.assert_array_equal(q, jquantized[name][0])
        assert q.dtype == np.int8 and scale == jquantized[name][1]

    cfg = tload_config(CONFIG)
    target = variables_from_state_dict(TTRUNet(cfg.network).state_dict())
    params = tquantize.dequantize_params(quantized, target["params"])
    restored = tquantize.restore_batch_stats(stats, target["batch_stats"])
    jparams = jquantize.dequantize_params(jquantized, target["params"])
    jrestored = jquantize.restore_batch_stats(jstats, target["batch_stats"])
    for got, want in ((params, jparams), (restored, jrestored)):
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, a), (_, b) in zip(got_leaves, want_leaves):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))


def test_int8_denoiser_matches_jax():
    cfg, jcfg = tload_config(CONFIG), jload_config(CONFIG)
    noisy = tprocgen.mix_at_snr(tprocgen.synth_speech(np.random.default_rng(3), SR, SR),
                                tprocgen.synth_noise(np.random.default_rng(4), SR, SR, "pink"), 0.0)
    got = tquality.denoiser_from_int8(cfg, TRQ, device="cpu")
    assert got.ckpt_step == "int8"
    want = jquality.denoiser_from_int8(jcfg, TRQ)(noisy)
    np.testing.assert_allclose(got(noisy), np.asarray(want), rtol=0, atol=1e-4)


def test_run_quality_eval_matches_jax(testsets, tmp_path):
    """The flagship with its shipped weights on the 2-file testset, each
    package denoising and scoring on its own."""
    cfg, jcfg = tload_config(CONFIG), jload_config(CONFIG)
    kwargs = dict(testset_dir=str(testsets / "jax"), num_files=2, length_sec=1.0)
    got = tquality.run_quality_eval(cfg, tquality.denoiser_from_pretrained(cfg, ARTIFACT, device="cpu"),
                                    enhanced_dir=str(tmp_path / "port"), **kwargs)
    want = jquality.run_quality_eval(jcfg, jquality.denoiser_from_pretrained(jcfg, ARTIFACT),
                                     enhanced_dir=str(tmp_path / "jax"), **kwargs)
    assert got["testset"] == want["testset"]
    assert got.keys() == want.keys() >= {"oracle", "improvement"}
    assert got["oracle"] == want["oracle"]  # numpy on the same files: equal
    assert got["enhanced"].keys() == want["enhanced"].keys() >= {"si_sdr", "stoi", "pesq_wb_est", "wss"}
    for name, value in got["enhanced"].items():
        if name == "si_sdr":
            assert abs(value - want["enhanced"][name]) <= 1e-3
        else:
            np.testing.assert_allclose(value, want["enhanced"][name], rtol=1e-3, err_msg=name)
    assert got["noisy_baseline"] == want["noisy_baseline"]
    for section in ("per_noise_kind", "per_snr_bucket"):
        assert {k: v["n"] for k, v in got[section].items()} == {k: v["n"] for k, v in want[section].items()}
    assert got["improvement"]["si_sdr"] == pytest.approx(want["improvement"]["si_sdr"], abs=1e-3)


def test_quality_cli_scores_float32_and_int8(testsets, tmp_path, monkeypatch):
    """The CLI on the CPU with the int8 pack beside; enhanced files go under
    the config's output directory."""
    monkeypatch.chdir(tmp_path)
    result = tquality.main(["-c", CONFIG, "--pretrained", ARTIFACT, "--int8", TRQ, "--num_files", "2",
                            "--length_sec", "1.0", "--testset", str(testsets / "jax"), "--out",
                            str(tmp_path / "q.json"), "--device", "cpu"])
    assert os.path.isfile(tmp_path / "q.json")
    assert np.isfinite(result["enhanced"]["si_sdr"]) and np.isfinite(result["enhanced_int8"]["si_sdr"])
    assert result["testset"]["num_files"] == 2 and result["int8_pack_kb"] > 0
    assert os.path.isfile(tmp_path / "exp" / "TRUNet-proc" / "quality_int8" / "enhanced_fileid_0.wav")


def test_a_testset_of_another_recipe_raises(testsets, tmp_path):
    cfg = tload_config(CONFIG)
    with pytest.raises(ValueError, match="different recipe"):
        tquality.run_quality_eval(cfg, None, testset_dir=str(testsets / "jax"), num_files=2, length_sec=2.0,
                                  enhanced_dir=str(tmp_path))


def test_fileid_index_refuses_ambiguous_ids(tmp_path):
    for name in ("a_fileid_1.wav", "b_fileid_1.wav"):
        (tmp_path / name).write_bytes(b"")
    with pytest.raises(ValueError, match="ambiguous fileid"):
        tevaluate.build_fileid_index(str(tmp_path))


def test_bf16_config_serves_in_bf16():
    cfg = tload_config(CONFIG)
    bf16 = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, compute_dtype="bfloat16"))
    denoiser = tquality.denoiser_from_pretrained(bf16, ARTIFACT, device="cpu")
    assert denoiser.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in denoiser.model.parameters())
