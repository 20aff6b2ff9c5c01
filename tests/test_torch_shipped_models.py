"""The two other shipped models through the port on the CPU, against the
JAX package: large16k (config/large16k.json, artifacts/TRUNet-large, 4.4M
parameters, FGRU H 256, TGRU H 512) and proc48k (config/proc48k.json,
artifacts/TRUNet-proc48, 48 kHz). Each with its committed weights: the
offline Denoiser, the StreamingDenoiser and `run_quality_eval`; for
large16k also one float32 train step at batch 2 x 0.25 s.

Tolerances (measured on the CPU):
- Denoiser and StreamingDenoiser, 0.5 s at the config's rate: 1e-4
  absolute, the flagship's bound (tests/test_torch_denoise.py,
  tests/test_torch_streaming.py): the FFT's and atan2's last bit carried by
  the ~1e3 rad unwrapped phase into the demod features. Measured: offline
  2.7e-6 (large16k, peak 0.25) and 9.6e-6 (proc48k, peak 0.33).
- `run_quality_eval` on 2 files of 1 s, each package denoising and scoring
  on its own: each metric of the enhanced set 1e-3 relative, SI-SDR 1e-3
  dB; the noisy baseline and the oracle equal
  (tests/test_torch_quality.py).
- large16k's train step: the measure and bounds of
  tests/test_torch_train.py::test_one_train_step_matches_jax, stated there.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.data import procgen as tprocgen
from tinyrecurrentunet_torch.infer import StreamingDenoiser
from tinyrecurrentunet_torch.infer import quality as tquality
from tinyrecurrentunet_torch.infer.denoise import Denoiser
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.signal.features import Float32Features
from tinyrecurrentunet_torch.train.schedule import linear_warmup_cosine_decay
from tinyrecurrentunet_torch.train.state import create_train_state
from tinyrecurrentunet_torch.train.step import make_train_step
from tinyrecurrentunet_torch.weights import load_pretrained, variables_from_state_dict
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.infer import quality as jquality
from tinyrecurrentunet_tpu.infer.denoise import Denoiser as JDenoiser
from tinyrecurrentunet_tpu.infer.streaming import StreamingDenoiser as JStreaming
from tinyrecurrentunet_tpu.models import TRUNet as JTRUNet
from tinyrecurrentunet_tpu.train.checkpoint import load_pretrained_variables
from tinyrecurrentunet_tpu.train.state import TrainState as JTrainState
from tinyrecurrentunet_tpu.train.state import make_optimizer as jmake_optimizer
from tinyrecurrentunet_tpu.train.step import make_train_step as jmake_train_step

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = [("large16k", "TRUNet-large"), ("proc48k", "TRUNet-proc48")]
ATOL = 1e-4
# Entries whose gradient is at least this large take the first Adam step
# g / (|g| + eps), eps 1e-8, within 1e-3 of sign(g).
ADAM_SIGN_TAU = 1e-5
# large16k's clipped train-step gradient, float32 against JAX and against
# float64 (test_large16k_train_step_matches_jax)
GRAD_RTOL = 5e-2


def _clip(seconds, sample_rate, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
    return (x + 0.1 * np.sin(2 * np.pi * 1500 * t) + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One OpenBLAS thread in each test worker for the metrics' many small
    products (tests/test_torch_quality.py)."""
    with threadpoolctl.threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module", params=MODELS, ids=[name for name, _ in MODELS])
def shipped(request):
    """(name, artifact directory, port config, JAX config, the JAX package's
    Denoiser with the committed weights, the port's on the CPU)."""
    name, directory = request.param
    path = os.path.join(REPO, "config", f"{name}.json")
    artifact = os.path.join(REPO, "artifacts", directory)
    tcfg, jcfg = tconfig.load_config(path), jconfig.load_config(path)
    # the target trees' shapes only: the artifact holds every parameter and statistic
    init = jax.eval_shape(JTRUNet(jcfg.network).init, jax.random.PRNGKey(0), jnp.zeros((2, 257, 4)))
    params, stats = load_pretrained_variables(artifact, init["params"], init["batch_stats"], cfg=jcfg)
    return (name, artifact, tcfg, jcfg, JDenoiser(jcfg, {"params": params, "batch_stats": stats}),
            Denoiser.from_pretrained(tcfg, artifact, device="cpu"))


def test_denoise_matches_jax(shipped):
    _, _, tcfg, _, jax_den, torch_den = shipped
    clip = _clip(0.5, tcfg.featurizer.sample_rate)
    got, want = torch_den(clip), np.asarray(jax_den(clip))
    assert got.dtype == np.float32 and got.shape == clip.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # the model passes speech-band energy
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_streaming_matches_jax(shipped):
    _, artifact, tcfg, jcfg, jax_den, _ = shipped
    clip = _clip(0.5, tcfg.featurizer.sample_rate, seed=2)
    want, _ = JStreaming(jcfg, jax_den.variables).process(clip)
    got, state = StreamingDenoiser(tcfg, load_pretrained(artifact, tcfg), device="cpu").process(clip)
    assert got.shape == clip.shape and np.isfinite(got).all()
    assert int(state.feat_state.frame_count) == len(clip) // tcfg.featurizer.hop_length + 1
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_run_quality_eval_matches_jax(shipped, tmp_path):
    """2 files of 1 s at the config's rate, materialized by the JAX package;
    each package denoises and scores them on its own."""
    _, _, tcfg, jcfg, jax_den, torch_den = shipped
    sr = tcfg.trainset.sample_rate
    kwargs = dict(testset_dir=str(tmp_path / "testset"), num_files=2, length_sec=1.0)
    want = jquality.run_quality_eval(jcfg, jax_den, enhanced_dir=str(tmp_path / "jax"), **kwargs)
    got = tquality.run_quality_eval(tcfg, torch_den, enhanced_dir=str(tmp_path / "port"), **kwargs)
    assert got["testset"] == want["testset"] and got["testset"]["sample_rate"] == sr
    assert got.keys() == want.keys() >= {"oracle", "improvement"}
    assert got["oracle"] == want["oracle"]
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
    # the same files written by the port's generator
    tprocgen.materialize_dns_testset(str(tmp_path / "port_testset"), num_files=2, length_sec=1.0, sample_rate=sr,
                                     seed=tquality.QUALITY_TESTSET_SEED)
    files = sorted(str(p.relative_to(tmp_path / "testset")) for p in (tmp_path / "testset").rglob("*.wav"))
    assert len(files) == 4
    for rel in files:
        assert (tmp_path / "port_testset" / rel).read_bytes() == (tmp_path / "testset" / rel).read_bytes(), rel


def _float32_step_config(mod, path):
    """large16k as shipped but for the step's size: float32 (train_compute_dtype
    cleared), batch 2 of 0.25 s clips."""
    cfg = mod.load_config(path)
    opt = dataclasses.replace(cfg.train.optimization, batch_size_per_device=2, train_compute_dtype="")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt),
                               trainset=dataclasses.replace(cfg.trainset, crop_length_sec=0.25))


def _flat(tree, prefix=()):
    """(leaf names, all leaves as one float64 vector) of a params tree, keys sorted."""
    names, leaves = [], []
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            sub_names, sub = _flat(value, prefix + (key,))
            names += sub_names
            leaves.append(sub)
        else:
            names.append("/".join(prefix + (key,)))
            leaves.append(np.asarray(value, np.float64).ravel())
    return names, np.concatenate(leaves) if leaves else np.zeros(0)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_large16k_train_step_matches_jax():
    """One float32 step of the full-width large16k from identical initial
    weights on one batch of 2 synthetic 0.25 s clips, by the measure of
    tests/test_torch_train.py::test_one_train_step_matches_jax: loss terms
    1e-4 relative, grad_norm 2e-3; parameters after AdamW within 1e-6 where
    both gradients are at least ADAM_SIGN_TAU and of one sign (on at least
    90% of the entries), 2 lr(0) elsewhere; BatchNorm running statistics
    1e-5. The clipped gradients (relative L2 over all parameters) are held
    within GRAD_RTOL of JAX's and, each of the two, of a float64 step of the
    port on the port's float32 input features. At this width and batch the
    gradient is far worse conditioned than at the tiny width, where the
    bound is 5e-3: the float64 step itself moved 1.7e-3 and 1.7e-2 under two
    random 1e-7 relative perturbations of the noisy input, so float32
    rounding anywhere in the step lands about that far. Measured: port vs
    JAX 1.8e-2, port vs float64 1.7e-2, JAX vs float64 5.8e-3 (at batch 4 x
    0.5 s the port's float32 step is 1.1e-3 from its float64 reference)."""
    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset
    from tinyrecurrentunet_tpu.losses import loss_fn as jloss_fn
    from tinyrecurrentunet_tpu.signal import Featurizer as JFeaturizer

    path = os.path.join(REPO, "config", "large16k.json")
    tcfg, jcfg = _float32_step_config(tconfig, path), _float32_step_config(jconfig, path)
    ds = SyntheticPairDataset(num_items=2, length_sec=0.25, sample_rate=tcfg.trainset.sample_rate, seed=3)
    items = [ds.get(i) for i in range(2)]
    clean, noisy = (np.stack([x[k] for x in items]) for k in (0, 1))

    state = create_train_state(tcfg, device="cpu")
    model = state.model
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    # JAX-owned copies: the JAX step donates its state
    variables = jax.tree_util.tree_map(jnp.array, variables_from_state_dict(model.state_dict()))
    jmodel = JTRUNet(jcfg.network)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                batch_stats=variables["batch_stats"], tx=jmake_optimizer(jcfg))

    def jloss(params):
        return jloss_fn(jmodel.apply, params, variables["batch_stats"], jnp.array(clean), jnp.array(noisy),
                        JFeaturizer(jcfg.featurizer), jcfg.network, jcfg.train.loss_config, train=True)[0]

    jgrads = jax.block_until_ready(jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.array, variables["params"])))
    _, metrics = make_train_step(tcfg)(state, torch.from_numpy(clean), torch.from_numpy(noisy))
    jout = jmake_train_step(jcfg, jmodel)(jstate, jnp.array(clean), jnp.array(noisy))
    jmetrics = jout[1]
    assert sorted(metrics) == sorted(jmetrics)
    for name in metrics:
        rtol = 2e-3 if name == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=rtol, err_msg=name)

    names, got = _flat(variables_from_state_dict({n: p.grad for n, p in model.named_parameters()})["params"])
    jnames, want = _flat(jgrads)
    want *= min(1.0, tcfg.train.optimization.grad_clip_norm / float(jmetrics["grad_norm"]))  # optax's clip
    assert names == jnames
    ref_state = create_train_state(tcfg, device="cpu")
    ref_model = ref_state.model.double()
    ref_model.load_state_dict(initial)
    make_train_step(tcfg, featurizer=Float32Features(Featurizer(tcfg.featurizer)))(
        ref_state, torch.from_numpy(clean).double(), torch.from_numpy(noisy).double())
    _, ref = _flat(variables_from_state_dict({n: p.grad for n, p in ref_model.named_parameters()})["params"])
    for name, err in (("port vs JAX", _rel_l2(got, want)), ("port vs float64", _rel_l2(got, ref)),
                      ("JAX vs float64", _rel_l2(want, ref))):
        assert err <= GRAD_RTOL, (name, err)

    opt = tcfg.train.optimization
    lr0 = linear_warmup_cosine_decay(opt.learning_rate, opt.n_iters, opt.lr_divider, opt.warmup_proportion)(0)
    _, new = _flat(variables_from_state_dict(model.state_dict())["params"])
    _, jnew = _flat(jout[0].params)
    exact = (np.minimum(np.abs(want), np.abs(got)) >= ADAM_SIGN_TAU) & (np.sign(want) == np.sign(got))
    assert exact.mean() >= 0.9, exact.mean()
    np.testing.assert_allclose(new[exact], jnew[exact], rtol=0, atol=1e-6)
    np.testing.assert_allclose(new, jnew, rtol=0, atol=2 * lr0 + 1e-6)
    _, stats = _flat(variables_from_state_dict(model.state_dict())["batch_stats"])
    _, jstats = _flat(jax.tree_util.tree_map(np.asarray, jout[0].batch_stats))
    np.testing.assert_allclose(stats, jstats, rtol=0, atol=1e-5)


def _launch_shapes(cfg):
    """(rows, T, H) of the model's three recurrences (FGRU forward, FGRU
    reverse, TGRU) on a 4 s clip (the bucket ladder's frames) and in a
    training step (its batch of its crops)."""
    fb = TRUNet(cfg.network, device="meta").bottleneck_freqs(cfg.featurizer.num_freqs)
    hop = cfg.featurizer.hop_length
    serve = Denoiser._bucket(int(4 * cfg.featurizer.sample_rate), hop) // hop + 1
    crop = int(cfg.trainset.crop_length_sec * cfg.trainset.sample_rate) // hop + 1
    batch = cfg.train.optimization.batch_size_per_device
    fh, th = cfg.network.fgru_hidden, cfg.network.tgru_hidden
    return {"serve": [(serve, fb, fh)] * 2 + [(fb, serve, th)],
            "train": [(batch * crop, fb, fh)] * 2 + [(batch * fb, crop, th)]}


@pytest.mark.parametrize("name,serve,train", [
    # (path, rows per tile) of gru_fwd a denoise call; (gru_fwd_train, gru_bwd,
    # tensor cores?) of a training step, on an H100's 132 SMs
    ("large16k", [("cluster", 8), ("cluster", 8), ("cluster", 2)],
     [(("cluster", 4), ("cluster", 8), True)] * 2 + [(("cluster", 4), ("cluster", 8), True)]),
    ("proc48k", [("registers", 4), ("registers", 4), ("registers", 1)],
     [(("registers", 8), ("registers", 2), True)] * 2 + [(("registers", 2), ("registers", 2), True)]),
], ids=["large16k", "proc48k"])
def test_launch_plans_of_the_shipped_models(name, serve, train):
    """The plans the wrappers take at each shipped model's launch shapes:
    4 s served (large16k 556 x 16 x 256 and 16 x 556 x 512, proc48k 1,602 x
    16 x 64 and 16 x 1,602 x 128) and a training step at batch 16 of 2 s
    (large16k 4,016 x 16 x 256 and 256 x 251 x 512, proc48k 12,016 x 16 x 64
    and 256 x 751 x 128); large16k's BPTT takes the cluster kernel at 8 rows
    a tile and its weight gradient the tensor cores."""
    shapes = _launch_shapes(tconfig.load_config(os.path.join(REPO, "config", f"{name}.json")))
    assert [tuple(cuda_gru.fwd_plan(r, t, h, 132)) for r, t, h in shapes["serve"]] == serve
    got = [(tuple(cuda_gru.fwd_train_plan(r, t, h, 132)), tuple(cuda_gru.bwd_plan(r, t, h, 132)),
            h in cuda_gru._DW_MMA_HIDDEN) for r, t, h in shapes["train"]]
    assert got == train
    for r, t, h in shapes["train"]:
        splits, per_split = cuda_gru.dw_splits(r * t, h, 132)
        assert splits * per_split >= r * t > (splits - 1) * per_split
