"""The port's training datasets and loop flags against the JAX package, on the
CPU: the procedural corpus item by item, `train()` on the corpus on disk
(its default dataset) and on the procedural corpus with JAX's batches in
JAX's order and JAX's first loss, and the CLI flags of the JAX loop
(`--procedural`, `--babble_style`, `--kinds`, `--data_parallel`,
`--backend`, `--profile`). The tiny config of tests/test_torch_train.py.

Tolerances: items and batches bit-equal (the same numpy code on the same
generators); the first loss from the same weights and batch within 1e-5
relative (the loss is well conditioned: tests/test_torch_train.py holds
one step's loss terms within 1e-4 of JAX's; measured 0 here).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import CLIP_SEC, SR, _config, _NoCheckpoints, _record_batches

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.data import ProceduralSpeechDataset as TProcedural
from tinyrecurrentunet_torch.data.audio_io import write_wav
from tinyrecurrentunet_torch.train import loop as tloop
from tinyrecurrentunet_torch.train import step as tstep
from tinyrecurrentunet_torch.train.state import create_train_state
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter
from tinyrecurrentunet_torch.weights import variables_from_state_dict
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.data import ProceduralSpeechDataset as JProcedural
from tinyrecurrentunet_tpu.models import TRUNet as JTRUNet
from tinyrecurrentunet_tpu.train import loop as jloop
from tinyrecurrentunet_tpu.train.state import TrainState as JTrainState
from tinyrecurrentunet_tpu.train.state import make_optimizer as jmake_optimizer

torch.set_num_threads(2)


@pytest.mark.parametrize("babble_style,kinds", [("diverse", None), ("eval", None), ("diverse", ("reverb", "babble"))],
                         ids=["diverse", "eval", "kinds"])
def test_procedural_items_are_jax_items(babble_style, kinds):
    """Items 0-7 bit-equal to the JAX package's (clean target, noisy, id)."""
    kwargs = dict(num_items=8, length_sec=0.5, sample_rate=SR, babble_style=babble_style, kind_schedule=kinds)
    port, ref = TProcedural(**kwargs), JProcedural(**kwargs)
    for i in range(8):
        got, want = port.get(i), ref.get(i)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_device_corpus_is_the_dataset():
    """upload_corpus stacks dataset.get(i) in index order, bit for bit."""
    ds = TProcedural(num_items=4, length_sec=CLIP_SEC, sample_rate=SR)
    clean, noisy = tloop.upload_corpus(ds, 0, "cpu")
    for i in range(4):
        np.testing.assert_array_equal(clean[i].numpy(), ds.get(i)[0])
        np.testing.assert_array_equal(noisy[i].numpy(), ds.get(i)[1])


@pytest.fixture
def corpus(tmp_path):
    """A DNS-layout training corpus ("mix" mode): 5 clean files of 0.4-0.6 s
    and 3 noise files under <root>/clean and <root>/noise."""
    rng = np.random.default_rng(3)
    for sub, count, seconds in (("clean", 5, 0.5), ("noise", 3, 0.3)):
        os.makedirs(tmp_path / "corpus" / sub)
        for i in range(count):
            n = int(SR * seconds) + int(rng.integers(-1600, 1600))
            write_wav(str(tmp_path / "corpus" / sub / f"{sub}_fileid_{i}.wav"),
                      (0.3 * rng.standard_normal(n)).astype(np.float32), SR)
    return str(tmp_path / "corpus")


def _corpus_config(mod, tmp_path, root, **opt):
    cfg = _config(mod, tmp_path / "ckpt", **opt)
    return mod.Config(network=cfg.network, featurizer=cfg.featurizer, train=cfg.train,
                      trainset=mod.TrainsetConfig(root=root, sample_rate=SR, crop_length_sec=CLIP_SEC))


def test_train_reads_the_corpus_on_disk_like_jax(tmp_path, monkeypatch, corpus):
    """train(cfg) with no dataset reads cfg.trainset through the DataLoader:
    the clean and noisy batches of two epochs are the JAX loop's."""
    seen_t, seen_j = [], []
    _record_batches(monkeypatch, tloop, seen_t)
    _record_batches(monkeypatch, jloop, seen_j)
    monkeypatch.setattr(jloop, "create_train_state", lambda *a: JTrainState(
        step=0, apply_fn=None, params={"w": np.zeros(1)}, tx=None, opt_state=None))
    opt = dict(seed=7, n_iters=4)
    tloop.train(_corpus_config(tconfig, tmp_path, corpus, **opt), log_dir=str(tmp_path / "t"), device="cpu")
    jloop.train(_corpus_config(jconfig, tmp_path, corpus, **opt), log_dir=str(tmp_path / "j"))
    assert len(seen_t) == len(seen_j) == 4
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)


class _NoEval(tstep.EvalStep):
    """An eval step whose validation pass costs nothing: the slot's buffers,
    a loss of 0."""

    def __call__(self, state, clean, noisy, replay=True):
        return {"loss": torch.tensor(0.0)}


def test_procedural_cli_batches_are_jax_batches(tmp_path, monkeypatch):
    """`--procedural` (the device corpus path) against the JAX loop on the
    same procedural corpus: the same clips in the same order over two epochs."""
    seen_t, seen_j = [], []
    _record_batches(monkeypatch, tloop, seen_t)
    _record_batches(monkeypatch, jloop, seen_j)
    monkeypatch.setattr(tloop, "make_eval_step", _NoEval)
    monkeypatch.setattr(jloop, "create_train_state", lambda *a: JTrainState(
        step=0, apply_fn=None, params={"w": np.zeros(1)}, tx=None, opt_state=None))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(tconfig.config_to_dict(_config(tconfig, tmp_path / "ckpt", n_iters=6))))
    tloop.main(["-c", str(path), "--procedural", "--procedural_items", "6", "--device", "cpu"])
    jloop.train(_config(jconfig, tmp_path / "ckpt", n_iters=6), JProcedural(6, CLIP_SEC, SR),
                log_dir=str(tmp_path / "j"))
    assert len(seen_t) == len(seen_j) == 6
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)


def _jax_state_with(jcfg, state):
    """A JAX train state holding the port state's weights (JAX-owned copies:
    the JAX step donates its state)."""
    variables = jax.tree_util.tree_map(jnp.array, variables_from_state_dict(state.model.state_dict()))
    jmodel = JTRUNet(jcfg.network)
    return JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=jmake_optimizer(jcfg))


@pytest.mark.parametrize("source", ["corpus", "procedural"])
def test_first_loss_matches_jax(tmp_path, monkeypatch, corpus, source):
    """One real step of each loop from the same initial weights: the corpus
    on disk (the default dataset) or the procedural corpus."""
    monkeypatch.setattr(tloop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))
    monkeypatch.setattr(jloop, "CheckpointManager", _NoCheckpoints)
    tcfg, jcfg = _corpus_config(tconfig, tmp_path, corpus), _corpus_config(jconfig, tmp_path, corpus)
    monkeypatch.setattr(jloop, "create_train_state", lambda *a: _jax_state_with(
        jcfg, create_train_state(tcfg, device="cpu")))
    tdata = jdata = None
    if source == "procedural":
        tdata, jdata = TProcedural(4, CLIP_SEC, SR), JProcedural(4, CLIP_SEC, SR)
    _, metrics = tloop.train(tcfg, tdata, max_iters=1, log_dir=str(tmp_path / "t"), device="cpu")
    _, jmetrics = jloop.train(jcfg, jdata, max_iters=1, log_dir=str(tmp_path / "j"))
    np.testing.assert_allclose(metrics["loss"], float(jmetrics["loss"]), rtol=1e-5)


def _cli(tmp_path, *argv, **opt):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(tconfig.config_to_dict(_config(tconfig, tmp_path / "ckpt", **opt))))
    return tloop.main(["-c", str(path), "--device", "cpu", *argv])


def test_cli_trains_on_the_corpus_on_disk(tmp_path, monkeypatch, corpus):
    """Without --procedural or --synthetic the CLI reads trainset.root."""
    monkeypatch.setattr(tloop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))
    path = tmp_path / "corpus.json"
    path.write_text(json.dumps(tconfig.config_to_dict(_corpus_config(tconfig, tmp_path, corpus))))
    state, metrics = tloop.main(["-c", str(path), "--max_iters", "1", "--device", "cpu"])
    assert state.step == 1 and np.isfinite(metrics["loss"]) and "valid_loss" not in metrics


def test_cli_procedural_with_babble_style_and_kinds(tmp_path, monkeypatch):
    """--procedural with the round-5 knobs trains and validates on the
    32-item procedural validation set."""
    monkeypatch.setattr(tloop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))
    state, metrics = _cli(tmp_path, "--procedural", "--procedural_items", "4", "--babble_style", "eval",
                          "--kinds", "reverb,pink", "--max_iters", "1")
    assert state.step == 1 and np.isfinite(metrics["loss"]) and np.isfinite(metrics["valid_loss"])


def test_cli_data_parallel_in_one_process(tmp_path, monkeypatch):
    """--data_parallel without a launcher is a world of one: it trains as a
    single process does, on the gloo backend asked for."""
    monkeypatch.setattr(tloop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))
    state, metrics = _cli(tmp_path, "--synthetic", "--synthetic_items", "2", "--data_parallel",
                          "--backend", "gloo", "--max_iters", "1")
    assert state.step == 1 and np.isfinite(metrics["loss"])


def test_cli_profile_traces_steps_10_to_12(tmp_path, monkeypatch):
    """--profile DIR writes a torch.profiler trace of steps 10-12."""
    monkeypatch.setattr(tloop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))
    seen = []
    real_trace = tloop.trace

    def counting_trace(log_dir):
        seen.append(log_dir)
        return real_trace(log_dir)

    monkeypatch.setattr(tloop, "trace", counting_trace)
    state, _ = _cli(tmp_path, "--synthetic", "--synthetic_items", "2", "--max_iters", "14",
                    "--profile", str(tmp_path / "prof"))
    assert state.step == 14 and seen == [str(tmp_path / "prof")]
    with open(tmp_path / "prof" / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    # steps 10, 11 and 12: three optimizer updates in the window
    assert sum(e.get("name", "").startswith("Optimizer.step#AdamW.step") for e in events) == 3
