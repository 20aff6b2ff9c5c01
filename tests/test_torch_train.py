"""The port's training against the JAX package: schedule, train-mode
BatchNorm, initial weights, one train step from identical weights, the
training loop, its checkpoints and CLI. A narrow network, 0.25 s clips and
one STFT bank, as in tests/test_train.py.

Identical weights: the port draws them (`create_train_state`), the JAX step
gets them through `weights.variables_from_state_dict`, the exact inverse of
the loader's `state_dict_from_variables` (tested here as well).

Tolerances, float32 on both sides, stated at each test.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset as TSynthetic
from tinyrecurrentunet_torch.infer.denoise import Denoiser as TDenoiser
from tinyrecurrentunet_torch.models import TRUNet as TTRUNet
from tinyrecurrentunet_torch.models.blocks import BatchNorm as TBatchNorm
from tinyrecurrentunet_torch.models.blocks import init_parameters
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.signal.features import Float32Features
from tinyrecurrentunet_torch.train import loop as tloop
from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager, save_pretrained_params
from tinyrecurrentunet_torch.train.schedule import linear_warmup_cosine_decay as tschedule
from tinyrecurrentunet_torch.train.state import create_train_state
from tinyrecurrentunet_torch.train.step import make_train_step
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter
from tinyrecurrentunet_torch.weights import (
    artifact_meta,
    load_pretrained,
    read_npz,
    state_dict_from_variables,
    variables_from_state_dict,
)
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.data import SyntheticPairDataset as JSynthetic
from tinyrecurrentunet_tpu.infer.denoise import Denoiser as JDenoiser
from tinyrecurrentunet_tpu.models import TRUNet as JTRUNet
from tinyrecurrentunet_tpu.train import loop as jloop
from tinyrecurrentunet_tpu.train.checkpoint import load_pretrained_variables
from tinyrecurrentunet_tpu.train.schedule import linear_warmup_cosine_decay as jschedule
from tinyrecurrentunet_tpu.train.state import TrainState as JTrainState
from tinyrecurrentunet_tpu.train.state import make_optimizer as jmake_optimizer
from tinyrecurrentunet_tpu.train.step import make_train_step as jmake_train_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)
SR = 16000
CLIP_SEC = 0.25


def _config(mod, log_dir="ckpt", **opt):
    """The same small config in either package: the tiny network, the
    flagship's loss terms (L1, MR-STFT, noise-side MR-STFT 0.5) on one bank,
    batch 2 of 0.25 s clips."""
    opt = {"n_iters": 100, "learning_rate": 8e-4, "batch_size_per_device": 2,
           "grad_clip_norm": 1.0, **opt}
    return mod.Config(
        network=mod.NetworkConfig(**TINY),
        featurizer=mod.FeaturizerConfig(sample_rate=SR),
        train=mod.TrainConfig(
            log=mod.LogConfig(directory=str(log_dir), iters_per_ckpt=100, iters_per_valid=1),
            optimization=mod.OptimizationConfig(**opt),
            loss_config=mod.LossConfig(noise_stft_lambda=0.5, stft_config=mod.STFTLossConfig(
                fft_sizes=(512,), hop_sizes=(120,), win_lengths=(240,))),
        ),
        trainset=mod.TrainsetConfig(sample_rate=SR, crop_length_sec=CLIP_SEC),
    )


@pytest.fixture
def jsonl_metrics(monkeypatch):
    """The loop's metrics without TensorBoard, whose import pulls in
    TensorFlow here."""
    monkeypatch.setattr(tloop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))


def _tree_leaves(tree, prefix=()):
    for name, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _tree_leaves(value, prefix + (name,))
        else:
            yield "/".join(prefix + (name,)), np.asarray(value)


# ------------------------------------------------------------------ schedule


@pytest.mark.parametrize("n_iters", [100, 45000])
def test_schedule_matches_jax(n_iters):
    """float32 in both, operation for operation (1e-6 relative)."""
    counts = [0, 1, 2, 4, 5, 6, 50, 99, n_iters // 2, n_iters - 1, n_iters, 3 * n_iters]
    ts, js = tschedule(8e-4, n_iters, 25.0, 0.05), jschedule(8e-4, n_iters, 25.0, 0.05)
    for count in counts:
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6, err_msg=str(count))


# ----------------------------------------------------------------- BatchNorm


def test_train_mode_batchnorm_matches_flax():
    """Output, gradient and updated running statistics of one train-mode
    call against flax's BatchNorm (momentum 0.99, eps 1e-5, fast variance):
    1e-5 absolute on outputs and gradients, 1e-6 on the statistics (means
    over 420 values summed in another order)."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 70, 5)) * 2 + 1).astype(np.float32)
    upstream = rng.standard_normal(x.shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 2, 5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    mean0, var0 = rng.standard_normal(5).astype(np.float32), rng.uniform(0.5, 2, 5).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(xx):
        y, upd = bn.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(y * upstream), (y, upd["batch_stats"])

    gx, (y_ref, stats) = jax.jit(jax.grad(f, has_aux=True))(jnp.asarray(x))

    tbn = TBatchNorm(5)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean0))
        tbn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_()
    y = tbn.train()(xt)
    (y * torch.from_numpy(upstream)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(stats["var"]), rtol=0, atol=1e-6)
    # eval mode reads the running statistics and leaves them alone
    before = tbn.running_mean.clone()
    tbn.eval()(xt)
    torch.testing.assert_close(tbn.running_mean, before, rtol=0, atol=0)


# -------------------------------------------------------------- initial weights


def test_initial_weights_follow_flax_distributions():
    """The flagship network drawn by the port against flax's initializers.
    Each kernel is divided by the std its family should have (lecun_normal:
    sqrt(1/fan_in); the GRU's uniform: 1/sqrt(H)), and flax's initializers
    are drawn at one large shape and divided alike. Per kernel of 500+
    entries the std agrees with flax's within 10% (sampling noise of a few
    hundred to 50k draws); the truncated normals stay within 2/0.8796 (flax's
    truncation), the uniforms within 1; biases are 0, BatchNorm starts at
    identity, and a seed always gives the same weights."""
    import flax.linen as fnn

    key = jax.random.PRNGKey(0)
    ref_normal = np.asarray(fnn.initializers.lecun_normal()(key, (4096, 64))) * 64.0
    ref_uniform = np.asarray(jax.random.uniform(key, (4096, 64), minval=-1.0, maxval=1.0))
    cfg = tconfig.load_config(os.path.join(REPO, "config", "proc16k.json"))
    model = init_parameters(TTRUNet(cfg.network), torch.Generator().manual_seed(0))
    variables = variables_from_state_dict(model.state_dict())
    n_big = 0
    for name, value in _tree_leaves(variables["params"]):
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("kernel", "depthwise_kernel", "tr_kernel"):
            z, ref = value / np.sqrt(value.shape[-1] / value.size), ref_normal  # fan_in = size / out
            assert np.abs(z).max() <= 2 / 0.87962566103423978 * (1 + 1e-6), name
        elif leaf[:3] in ("wi_", "wh_", "bi_", "bh_"):
            z, ref = value * np.sqrt(value.shape[-1] // 3), ref_uniform
            assert np.abs(z).max() <= 1 + 1e-6, name
        else:
            expect = 1.0 if leaf == "scale" else 0.0
            np.testing.assert_array_equal(value, np.full_like(value, expect), err_msg=name)
            continue
        if value.size >= 500:
            n_big += 1
            assert abs(z.std() / ref.std() - 1) < 0.1, (name, z.std(), ref.std())
    assert n_big >= 20
    for name, value in _tree_leaves(variables["batch_stats"]):
        np.testing.assert_array_equal(value, np.full_like(value, name.endswith("var")), err_msg=name)
    again = init_parameters(TTRUNet(cfg.network), torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------- the train step


def _batch(batch=2, seed=3):
    ds = TSynthetic(num_items=batch, length_sec=CLIP_SEC, sample_rate=SR, seed=seed)
    items = [ds.get(i) for i in range(batch)]
    return np.stack([c for c, _, _ in items]), np.stack([n for _, n, _ in items])


def _flat(tree):
    """(leaf names, all leaves as one float64 vector) of a params tree."""
    leaves = list(_tree_leaves(tree))
    return [n for n, _ in leaves], np.concatenate([v.ravel() for _, v in leaves]).astype(np.float64)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# Entries whose gradient is at least this large take the first Adam step
# g / (|g| + eps), eps 1e-8, within 1e-3 of sign(g).
ADAM_SIGN_TAU = 1e-5


@pytest.mark.parametrize("with_carry", [False, True], ids=["whole_clip", "tbptt_carry"])
def test_one_train_step_matches_jax(with_carry):
    """One step from identical weights on one batch. The float32 gradient of
    this network is ill-conditioned (train-mode BatchNorm divides by batch
    standard deviations of a few values, the log-magnitude loss by bin
    magnitudes), so the gradients are also held against the same step of the
    port in float64 on the same input features (tests/torch_step_conditioning.py).
    Tolerances:
    - loss terms: 1e-4 relative (the loss itself is well conditioned);
    - grad_norm: 2e-3 relative;
    - gradients after clipping (the clip acts: grad_norm > 1.0), against
      jax.grad of the JAX loss clipped as optax does: the port's float32
      gradients at most as far (relative L2 over all parameters) from the
      float64 ones as JAX's, and within 5e-3 of JAX's. Per parameter it would
      be meaningless: the biases that feed a BatchNorm have an exact gradient
      of 0 and carry rounding only;
    - parameters after the AdamW update, where both gradients are at least
      ADAM_SIGN_TAU and of one sign: 1e-6 absolute (both updates are then
      lr(0) sign(g) to 1e-3 lr(0), plus the same weight decay; measured
      1.2e-7, the float32 rounding of the weights). Elsewhere, at most 10% of
      the entries (measured 7.8-8.3%: mostly entries with no gradient, such
      as transposed-conv taps that reach no output), the first Adam step of
      a near-zero gradient is +-lr(0) with either sign: 2 lr(0);
    - BatchNorm running statistics and the TBPTT carry: 1e-5 absolute."""
    from tinyrecurrentunet_tpu.losses import loss_fn as jloss_fn
    from tinyrecurrentunet_tpu.signal import Featurizer as JFeaturizer

    jcfg, tcfg = _config(jconfig), _config(tconfig)
    clean, noisy = _batch()
    state = create_train_state(tcfg, device="cpu")
    model = state.model
    # JAX-owned copies (jnp.array): jnp.asarray may alias a numpy array's
    # memory, and the JAX step donates its state and carry
    variables = jax.tree_util.tree_map(jnp.array, variables_from_state_dict(model.state_dict()))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    jmodel = JTRUNet(jcfg.network)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                batch_stats=variables["batch_stats"], tx=jmake_optimizer(jcfg))

    fb = model.bottleneck_freqs(tcfg.featurizer.num_freqs)
    h0 = (0.3 * np.random.default_rng(4).standard_normal((2, fb, 16))).astype(np.float32)
    extra_t = (torch.from_numpy(h0),) if with_carry else ()

    def jloss(params):
        return jloss_fn(jmodel.apply, params, variables["batch_stats"], jnp.array(clean),
                        jnp.array(noisy), JFeaturizer(jcfg.featurizer), jcfg.network,
                        jcfg.train.loss_config, train=True,
                        tgru_h0=jnp.array(h0) if with_carry else None)[0]

    jgrads = jax.block_until_ready(jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.array, variables["params"])))
    out = make_train_step(tcfg, with_carry=with_carry)(
        state, torch.from_numpy(clean), torch.from_numpy(noisy), *extra_t)
    jout = jmake_train_step(jcfg, jmodel, with_carry=with_carry)(
        jstate, jnp.array(clean), jnp.array(noisy), *((jnp.array(h0),) if with_carry else ()))
    metrics, jmetrics = out[1], jout[1]

    assert sorted(metrics) == sorted(jmetrics)
    for name in metrics:
        rtol = 2e-3 if name == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=rtol, err_msg=name)
    assert float(metrics["grad_norm"]) > tcfg.train.optimization.grad_clip_norm  # the clip acts
    assert state.step == int(jout[0].step) == 1

    # the gradients, clipped as optax does
    names, got = _flat(variables_from_state_dict({n: p.grad for n, p in model.named_parameters()})["params"])
    jnames, want = _flat(jgrads)
    want *= tcfg.train.optimization.grad_clip_norm / float(jmetrics["grad_norm"])
    assert names == jnames
    assert _rel_l2(got, want) <= 5e-3
    if not with_carry:
        ref_state = create_train_state(tcfg, device="cpu")
        ref_model = ref_state.model.double()
        ref_model.load_state_dict(initial)  # the float32 weights the other two start from
        make_train_step(tcfg, featurizer=Float32Features(Featurizer(tcfg.featurizer)))(
            ref_state, torch.from_numpy(clean).double(), torch.from_numpy(noisy).double())
        ref_names, ref = _flat(variables_from_state_dict(
            {n: p.grad for n, p in ref_model.named_parameters()})["params"])
        assert ref_names == names
        assert _rel_l2(got, ref) <= _rel_l2(want, ref), (_rel_l2(got, ref), _rel_l2(want, ref))

    lr0 = tschedule(8e-4, 100)(0)
    _, new = _flat(variables_from_state_dict(model.state_dict())["params"])
    _, jnew = _flat(jout[0].params)
    exact = (np.minimum(np.abs(want), np.abs(got)) >= ADAM_SIGN_TAU) & (np.sign(want) == np.sign(got))
    assert exact.mean() >= 0.9, exact.mean()
    np.testing.assert_allclose(new[exact], jnew[exact], rtol=0, atol=1e-6)
    np.testing.assert_allclose(new, jnew, rtol=0, atol=2 * lr0 + 1e-6)
    for (name, got_stat), (_, want_stat) in zip(_tree_leaves(variables_from_state_dict(model.state_dict())["batch_stats"]),
                                                _tree_leaves(jout[0].batch_stats)):
        np.testing.assert_allclose(got_stat, want_stat, rtol=0, atol=1e-5, err_msg=name)
    if with_carry:
        np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]), rtol=0, atol=1e-5)
        assert not out[2].requires_grad


# ------------------------------------------------------------- loop and weights


def test_state_dict_round_trip_is_exact():
    variables, _ = read_npz(os.path.join(REPO, "artifacts", "TRUNet-proc", "pretrained.npz"))
    back = variables_from_state_dict(state_dict_from_variables(variables))
    for section in ("params", "batch_stats"):
        a, b = dict(_tree_leaves(back[section])), dict(_tree_leaves(variables[section]))
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_train_loop_writes_weights_the_jax_denoiser_loads(tmp_path, jsonl_metrics):
    """train() for 2 iterations on synthetic data; its pretrained.npz loads in
    the JAX package, whose Denoiser agrees with the port's on those weights
    within 1e-4 (the waveform tolerance of tests/test_torch_denoise.py)."""
    tcfg, jcfg = _config(tconfig, tmp_path / "ckpt"), _config(jconfig, tmp_path / "ckpt")
    ds = TSynthetic(num_items=4, length_sec=CLIP_SEC, sample_rate=SR)
    valid = TSynthetic(num_items=2, length_sec=CLIP_SEC, sample_rate=SR, seed=9)
    state, metrics = tloop.train(tcfg, ds, max_iters=2, log_dir=str(tmp_path / "logs"),
                                 valid_dataset=valid, device="cpu")
    assert state.step == 2 and np.isfinite(metrics["loss"]) and np.isfinite(metrics["valid_loss"])
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), tcfg.train.exp_path)
    assert ckpt.all_steps() == [1]  # the last iteration, as the JAX loop saves it

    out_dir = str(tmp_path / "artifact")
    save_pretrained_params(out_dir, state.model, artifact_meta(tcfg))
    target = variables_from_state_dict(TTRUNet(tcfg.network).state_dict())
    params, stats = load_pretrained_variables(out_dir, target["params"], target["batch_stats"],
                                              cfg=jcfg)
    clip = _batch(1, seed=5)[1][0]
    want = JDenoiser(jcfg, {"params": params, "batch_stats": stats})(clip)
    got = TDenoiser(tcfg, load_pretrained(out_dir, tcfg), device="cpu")(clip)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_train_loop_resumes_from_the_latest_checkpoint(tmp_path, jsonl_metrics):
    cfg = _config(tconfig, tmp_path / "ckpt", batch_size_per_device=1)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log=dataclasses.replace(cfg.train.log, iters_per_ckpt=1, iters_per_valid=100)))
    ds = TSynthetic(num_items=2, length_sec=CLIP_SEC, sample_rate=SR)
    state, _ = tloop.train(cfg, ds, max_iters=2, log_dir=str(tmp_path / "logs"), device="cpu")
    assert CheckpointManager(str(tmp_path / "ckpt"), "TRUNet").all_steps() == [1]
    resumed, _ = tloop.train(cfg, ds, max_iters=3, log_dir=str(tmp_path / "logs"), device="cpu")
    assert resumed.step == 3
    fresh = create_train_state(cfg, device="cpu")
    step1, it, _ = CheckpointManager(str(tmp_path / "ckpt"), "TRUNet").restore(fresh, 1)
    assert it == 1 and step1.step == 2


def test_train_loop_with_tbptt_segments(tmp_path, jsonl_metrics):
    """tbptt_segment_sec 0.125 cuts each 0.25 s clip into two segments: one
    update each, the TGRU carry passed from the first to the second."""
    cfg = _config(tconfig, tmp_path / "ckpt", tbptt_segment_sec=0.125)
    state, metrics = tloop.train(cfg, TSynthetic(2, CLIP_SEC, SR), max_iters=1,
                                 log_dir=str(tmp_path / "logs"), device="cpu")
    assert state.step == 2 and np.isfinite(metrics["loss"])


def _jax_loader_batches(dataset, epochs, **kwargs):
    """The JAX DataLoader's batches, built from its synchronous parts (the
    per-epoch shuffle and the per-item generator) without its prefetch
    thread: (clean, noisy, ids) per batch, drop_last."""
    from tinyrecurrentunet_tpu.data import DataLoader as JLoader

    loader = JLoader(dataset, **kwargs)
    batches = []
    for epoch in range(epochs):
        loader._epoch = epoch
        indices = loader._epoch_indices()
        for i in range(0, len(indices) - loader.batch_size + 1, loader.batch_size):
            items = [loader._get_item(j) for j in indices[i : i + loader.batch_size]]
            batches.append(tuple(np.stack([x[k] for x in items]) for k in (0, 1))
                           + ([x[2] for x in items],))
    return batches


class _NotCacheable:
    """A dataset the loop reads through its DataLoader, not the on-device
    corpus."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def get(self, index, rng):
        return self.dataset.get(index, rng)


class _NoCheckpoints:
    def __init__(self, *args, **kwargs):
        pass

    def restore(self, state, selector):
        return state, -1, 0

    def save(self, *args):
        pass

    def close(self):
        pass


def _record_batches(monkeypatch, loop, seen):
    """Replace the loop's step by a recorder of the clean batches."""
    def recorder(state, clean, noisy, *rest):
        seen.append(np.asarray(clean).copy())
        return state, {"loss": 0.0, "grad_norm": 0.0}

    monkeypatch.setattr(loop, "make_train_step", lambda *a, **k: recorder)
    monkeypatch.setattr(loop, "CheckpointManager", _NoCheckpoints)
    monkeypatch.setattr(loop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))


def test_batch_order_matches_the_jax_loop(tmp_path, monkeypatch):
    """Both loops' on-device corpus paths with their steps replaced by
    recorders: the same clips in the same order over three epochs."""
    seen_t, seen_j = [], []
    _record_batches(monkeypatch, tloop, seen_t)
    _record_batches(monkeypatch, jloop, seen_j)
    monkeypatch.setattr(jloop, "create_train_state", lambda *a: JTrainState(
        step=0, apply_fn=None, params={"w": np.zeros(1)}, tx=None, opt_state=None))
    seed_cfg = dict(seed=7, n_iters=6)
    tloop.train(_config(tconfig, tmp_path, **seed_cfg), TSynthetic(6, CLIP_SEC, SR),
                log_dir=str(tmp_path / "t"), device="cpu")
    jloop.train(_config(jconfig, tmp_path, **seed_cfg), JSynthetic(6, CLIP_SEC, SR),
                log_dir=str(tmp_path / "j"))
    assert len(seen_t) == len(seen_j) == 6
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)


def test_loop_reads_other_datasets_through_the_loader_like_jax(tmp_path, monkeypatch):
    """A dataset that is not device_cacheable goes through the DataLoader:
    the loop's batches over three epochs are the JAX DataLoader's."""
    seen = []
    _record_batches(monkeypatch, tloop, seen)
    tloop.train(_config(tconfig, tmp_path, seed=7, n_iters=6), _NotCacheable(TSynthetic(5, CLIP_SEC, SR)),
                log_dir=str(tmp_path / "t"), device="cpu")
    want = _jax_loader_batches(JSynthetic(5, CLIP_SEC, SR), 3, batch_size=2, shuffle=True,
                               drop_last=True, seed=7)
    assert len(seen) == 6 == len(want)
    for got, (clean, _, _) in zip(seen, want):
        np.testing.assert_array_equal(got, clean)


@pytest.mark.parametrize("shuffle,shards", [(True, 1), (False, 1), (True, 3)])
def test_data_loader_matches_jax(shuffle, shards):
    """The same batches, ids and order as the JAX DataLoader over two epochs,
    per shard."""
    from tinyrecurrentunet_torch.data.loader import DataLoader as TLoader

    for shard in range(shards):
        kwargs = dict(batch_size=2, shuffle=shuffle, drop_last=True, seed=5, num_shards=shards,
                      shard_index=shard)
        loader = TLoader(TSynthetic(9, 0.01, SR), **kwargs)
        got = list(loader) + list(loader)
        want = _jax_loader_batches(JSynthetic(9, 0.01, SR), 2, **kwargs)
        assert len(got) == len(want) == 2 * len(loader)
        for (tc, tn, tid), (jc, jn, jid) in zip(got, want):
            assert tid == jid
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tn, jn)


# ------------------------------------------------------------------------ CLI


def _cli_config(tmp_path, **opt):
    raw = tconfig.config_to_dict(_config(tconfig, tmp_path / "ckpt", **opt))
    path = tmp_path / "tiny_train.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_trains_on_cpu(tmp_path, jsonl_metrics):
    path = _cli_config(tmp_path)
    state, metrics = tloop.main(["-c", path, "--synthetic", "--synthetic_items", "2",
                                 "--max_iters", "1", "--device", "cpu"])
    assert state.step == 1 and np.isfinite(metrics["loss"]) and "valid_loss" in metrics
    assert CheckpointManager(str(tmp_path / "ckpt"), "TRUNet").all_steps() == [0]


def test_cli_cuda_request_without_a_card_raises(tmp_path):
    path = _cli_config(tmp_path)
    if torch.cuda.is_available():
        return  # on a card the request is honoured (chip_smoke.py trains there)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.main(["-c", path, "--synthetic", "--max_iters", "1", "--device", "cuda"])


@pytest.mark.parametrize("argv,match", [
    (["--procedural"], "later slice"),
    (["--data_parallel"], "later slice"),
    (["--profile", "p"], "later slice"),
])
def test_cli_options_of_later_slices_raise(tmp_path, argv, match):
    with pytest.raises(NotImplementedError, match=match):
        tloop.main(["-c", _cli_config(tmp_path), "--synthetic", *argv])


def test_bf16_training_raises(tmp_path):
    cfg = _config(tconfig, tmp_path, train_compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="bf16 training is a later slice"):
        tloop.train(cfg, TSynthetic(2, CLIP_SEC, SR), max_iters=1, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tloop.train(_config(tconfig, tmp_path), None, device="cpu")
