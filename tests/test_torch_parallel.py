"""The port's data parallelism against the JAX package's mesh step, on the CPU.

Two gloo processes (`scripts/torch_dp_step.py`, one rank each) take one
`train()` step at the tiny config of tests/test_torch_train.py, 2 clips a
rank, on the synthetic set. Their step is held against

- the JAX step over a 2-device mesh (`make_mesh(2)` of conftest's 8 virtual
  CPU devices) on the same global batch, the ranks' batches stacked
  rank-major, from the same initial weights;
- the port's single-process step on that global batch;

with `test_one_train_step_matches_jax`'s measure: loss terms within 1e-5
relative; grad_norm within 1e-4 of the port's single-process step
(measured 9.6e-6) and within 2e-3 of the JAX step, the bound
test_one_train_step_matches_jax holds the two packages' single-device steps
to (the port's single-process step is itself 3.4e-4 from JAX's here, the
data-parallel step 3.5e-4); parameters after the AdamW step within 1e-6
where both gradients are at least ADAM_SIGN_TAU and of one sign, which at
least 90% of the entries are, and everywhere within 2 lr(0) (the first
Adam step of a near-zero gradient takes either sign). The two ranks'
parameters, buffers, gradients and metrics are bit-equal.

A gloo group of one process takes the same data-parallel path (its
collectives run, over one rank) on the step's slots, by the body: its step
equals the step without a group by the same measure (measured: loss terms
4.4e-7, grad_norm 3.1e-7; the sums divided by the count where the means
were taken).

Negative controls, the same step with BatchNorm on rank-local statistics
and with the summed gradients not divided by the world size, fail that
comparison. The global-batch reductions (train-mode BatchNorm, spectral
convergence, per-item weights) at world size 2 equal their full-batch values.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import ADAM_SIGN_TAU, CLIP_SEC, SR, _config, _flat, _jax_loader_batches

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch import parallel
from tinyrecurrentunet_torch.losses.composite import per_item_weights
from tinyrecurrentunet_torch.losses.mrstft import spectral_convergence_loss
from tinyrecurrentunet_torch.models.blocks import BatchNorm
from tinyrecurrentunet_torch.train import loop as tloop
from tinyrecurrentunet_torch.train.schedule import linear_warmup_cosine_decay as tschedule
from tinyrecurrentunet_torch.train.state import create_train_state
from tinyrecurrentunet_torch.train.step import make_train_step
from tinyrecurrentunet_torch.weights import variables_from_state_dict
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.data import SyntheticPairDataset as JSynthetic
from tinyrecurrentunet_tpu.models import TRUNet as JTRUNet
from tinyrecurrentunet_tpu.parallel.mesh import make_mesh, shard_batch
from tinyrecurrentunet_tpu.train.state import TrainState as JTrainState
from tinyrecurrentunet_tpu.train.state import make_optimizer as jmake_optimizer
from tinyrecurrentunet_tpu.train.step import make_train_step as jmake_train_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_dp_step.py")
WORLD = 2
ITEMS = 8  # the synthetic set: 4 items a rank, one batch of 2 each
LOSS_RTOL = 1e-5
NORM_RTOL = {"single_step": 1e-4, "jax_mesh_step": 2e-3}
PARAM_ATOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' npz and JSON of one data-parallel step, with the controls."""
    root = tmp_path_factory.mktemp("dp")
    cfg_path = root / "tiny.json"
    cfg_path.write_text(json.dumps(tconfig.config_to_dict(_config(tconfig, root / "ckpt"))))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, WORKER, "-c", str(cfg_path), "--out", str(root / "out"),
                          "--items", str(ITEMS), "--device", "cpu", "--backend", "gloo", "--controls"],
                         env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=str(root),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    runs = []
    for r in range(WORLD):
        with open(root / "out" / f"rank{r}.json") as f:
            report = json.load(f)
        runs.append({**report, "arrays": dict(np.load(root / "out" / f"rank{r}.npz"))})
    return runs


def _global_batch(ranks):
    return [np.concatenate([run["arrays"][k] for run in ranks]) for k in ("clean", "noisy")]


def _named(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _as_jax_vector(named):
    """Port parameter or gradient arrays by name -> the flat vector of the
    JAX params tree in its (sorted) order."""
    return _flat(variables_from_state_dict({k: torch.from_numpy(v) for k, v in named.items()})["params"])[1]


def _check_step(got, want, norm_rtol):
    """test_one_train_step_matches_jax's measure on two steps, each a dict of
    metrics and flat vectors (params, clipped grads) in the JAX tree's order."""
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for name, value in got["metrics"].items():
        rtol = norm_rtol if name == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(value, want["metrics"][name], rtol=rtol, err_msg=name)
    lr0 = tschedule(8e-4, 100)(0)
    g, wg = got["grads"], want["grads"]
    exact = (np.minimum(np.abs(g), np.abs(wg)) >= ADAM_SIGN_TAU) & (np.sign(g) == np.sign(wg))
    assert exact.mean() >= 0.9, exact.mean()
    np.testing.assert_allclose(got["params"][exact], want["params"][exact], rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(got["params"], want["params"], rtol=0, atol=2 * lr0 + PARAM_ATOL)


def _port_step(metrics, named_params, named_grads, named_buffers) -> dict:
    as_torch = {k: torch.from_numpy(np.asarray(v)) for k, v in {**named_params, **named_buffers}.items()}
    return {"metrics": metrics, "params": _as_jax_vector(named_params), "grads": _as_jax_vector(named_grads),
            "stats": _flat(variables_from_state_dict(as_torch)["batch_stats"])[1]}


@pytest.fixture(scope="module")
def single_step(ranks):
    """The port's single-process step on the global batch."""
    cfg = _config(tconfig)
    state = create_train_state(cfg, device="cpu")
    clean, noisy = (torch.from_numpy(a) for a in _global_batch(ranks))
    state, metrics = make_train_step(cfg)(state, clean, noisy)
    model = state.model
    return _port_step({k: float(v) for k, v in metrics.items()},
                      {n: p.detach().numpy() for n, p in model.named_parameters()},
                      {n: p.grad.numpy() for n, p in model.named_parameters()},
                      {n: b.numpy() for n, b in model.named_buffers()})


@pytest.fixture(scope="module")
def jax_mesh_step(ranks):
    """The JAX step over a 2-device mesh on the global batch, from the
    port's initial weights (those the ranks start from), and jax.grad of the
    same loss on the same mesh, clipped as optax clips it."""
    return jax_mesh_step_on(tuple(_global_batch(ranks)))


def jax_mesh_step_on(global_batch) -> dict:
    """`jax_mesh_step` on a global batch (clean, noisy) of numpy arrays."""
    from tinyrecurrentunet_tpu.losses import loss_fn
    from tinyrecurrentunet_tpu.parallel.mesh import batch_sharding, replicated_sharding
    from tinyrecurrentunet_tpu.signal import Featurizer

    jcfg = _config(jconfig)
    initial = variables_from_state_dict(create_train_state(_config(tconfig), device="cpu").model.state_dict())
    # JAX-owned copies (jnp.array) for each use: the step donates its state
    fresh = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731
    jmodel = JTRUNet(jcfg.network)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=fresh(initial["params"]),
                                batch_stats=fresh(initial["batch_stats"]), tx=jmake_optimizer(jcfg))
    mesh = make_mesh(WORLD)
    clean, noisy = shard_batch(mesh, global_batch)
    new_state, metrics = jmake_train_step(jcfg, jmodel, mesh)(jstate, clean, noisy)

    def loss(params, batch_stats, c, n):
        return loss_fn(jmodel.apply, params, batch_stats, c, n, Featurizer(jcfg.featurizer), jcfg.network,
                       jcfg.train.loss_config, train=True)[0]

    repl, data = replicated_sharding(mesh), batch_sharding(mesh)
    grads = jax.jit(jax.grad(loss), in_shardings=(repl, repl, data, data), out_shardings=repl)(
        fresh(initial["params"]), fresh(initial["batch_stats"]), clean, noisy)
    jmetrics = {k: float(v) for k, v in metrics.items()}
    clip = jcfg.train.optimization.grad_clip_norm
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"metrics": jmetrics, "params": _flat(to_np(new_state.params))[1],
            "grads": _flat(to_np(grads))[1] * (clip / max(jmetrics["grad_norm"], clip)),
            "stats": _flat(to_np(new_state.batch_stats))[1]}


def _rank_step(run, prefix=""):
    """A rank's step, or one of its controls (prefix "local_bn/", "grads_x_w/")."""
    arrays = run["arrays"]
    metrics = run["controls"][prefix.rstrip("/")] if prefix else run["metrics"]
    return _port_step(metrics, _named(arrays, f"{prefix}param/"), _named(arrays, f"{prefix}grad/"),
                      _named(arrays, f"{prefix}buffer/"))


def test_rank_batches_are_the_jax_loader_shards(ranks):
    """Rank r's batch is the JAX loader's shard r (items perm[r::2]), so the
    global batch is the multi-process JAX global batch."""
    for r, run in enumerate(ranks):
        want = _jax_loader_batches(JSynthetic(ITEMS, CLIP_SEC, SR), 1, batch_size=2, shuffle=True,
                                   drop_last=True, seed=0, num_shards=WORLD, shard_index=r)[0]
        np.testing.assert_array_equal(run["arrays"]["clean"], want[0])
        np.testing.assert_array_equal(run["arrays"]["noisy"], want[1])


def test_replicas_are_bit_equal(ranks):
    a, b = ranks
    assert a["world"] == b["world"] == WORLD and a["rank"] == 0 and b["rank"] == 1
    assert a["metrics"] == b["metrics"]
    for key in ("param/", "buffer/", "grad/"):
        named_a, named_b = _named(a["arrays"], key), _named(b["arrays"], key)
        assert named_a.keys() == named_b.keys() and named_a
        for name in named_a:
            np.testing.assert_array_equal(named_a[name], named_b[name], err_msg=key + name)


@pytest.mark.parametrize("reference", ["single_step", "jax_mesh_step"])
def test_step_matches(ranks, reference, request):
    _check_step(_rank_step(ranks[0]), request.getfixturevalue(reference), NORM_RTOL[reference])


@pytest.mark.parametrize("reference", ["single_step", "jax_mesh_step"])
def test_running_statistics_match(ranks, reference, request):
    """The BatchNorm running statistics after the step, updated from the
    global batch's statistics: 1e-5 absolute, as in
    test_one_train_step_matches_jax."""
    got, want = _rank_step(ranks[0])["stats"], request.getfixturevalue(reference)["stats"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("reference", ["single_step", "jax_mesh_step"])
@pytest.mark.parametrize("control", ["local_bn", "grads_x_w"])
def test_negative_controls_fail_the_comparison(ranks, control, reference, request):
    """BatchNorm on rank-local statistics (DistributedDataParallel's
    semantics) and gradients W times too large both fail the measure."""
    want = request.getfixturevalue(reference)
    _check_step(_rank_step(ranks[0]), want, NORM_RTOL[reference])  # the real step passes
    with pytest.raises(AssertionError):
        _check_step(_rank_step(ranks[0], f"{control}/"), want, NORM_RTOL[reference])


def _reduce_inputs():
    """The seeded global arrays scripts/torch_dp_step.py shards."""
    rng = np.random.default_rng(21)
    n = 3 * WORLD
    x = (rng.standard_normal((n, 7, 5)) * 2 + 1).astype(np.float32)
    upstream = rng.standard_normal(x.shape).astype(np.float32)
    mags = rng.uniform(0.1, 2.0, (2, n, 9, 11)).astype(np.float32)
    audio = rng.standard_normal((2, n, 400)).astype(np.float32)
    audio[1] *= rng.uniform(0.1, 3.0, (n, 1)).astype(np.float32)
    return x, upstream, mags, audio


def _full_batchnorm():
    x, upstream, _, _ = _reduce_inputs()
    bn = BatchNorm(5).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(upstream)).sum().backward()
    return {"bn_out": y.detach().numpy(), "bn_grad": xt.grad.numpy(),
            "bn_running_mean": bn.running_mean.numpy(), "bn_running_var": bn.running_var.numpy()}


@pytest.mark.parametrize("quantity", ["bn_out", "bn_grad", "bn_running_mean", "bn_running_var"])
def test_global_batchnorm_equals_the_full_batch(ranks, quantity):
    """A train-mode BatchNorm on each rank's 3 of 6 items: its output shard,
    its input gradient (of the global sum, which the ranks' sum-backward
    all-reduce returns W times over) and its running statistics equal the
    full batch's within 1e-6 (sums in another order)."""
    full = _full_batchnorm()[quantity]
    for r, run in enumerate(ranks):
        got = run["arrays"][f"reduce/{quantity}"]
        if quantity == "bn_grad":
            got = got / WORLD
        want = full if quantity.startswith("bn_running") else full[3 * r : 3 * (r + 1)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_global_spectral_convergence_equals_the_full_batch(ranks):
    _, _, mags, _ = _reduce_inputs()
    want = float(spectral_convergence_loss(torch.from_numpy(mags[0]), torch.from_numpy(mags[1])))
    for run in ranks:
        np.testing.assert_allclose(float(run["arrays"]["reduce/spectral_convergence"]), want, rtol=1e-6)


def test_global_per_item_weights_equal_the_full_batch(ranks):
    _, _, _, audio = _reduce_inputs()
    want = per_item_weights(torch.from_numpy(audio[0]), torch.from_numpy(audio[0] + audio[1])).numpy()
    assert np.ptp(want) > 0.5  # the weights differ across items
    for r, run in enumerate(ranks):
        np.testing.assert_allclose(run["arrays"]["reduce/per_item_weights"], want[3 * r : 3 * (r + 1)], rtol=1e-6)


def test_a_group_of_one_takes_the_data_parallel_path_on_slots(monkeypatch):
    """One process in a gloo group of one rank: BatchNorm's, the loss's and
    the gradients' all-reduces run (each call counted; one of them is
    `sum_gradients_`'s over every parameter), on the step's slot, by the
    body (gloo's collectives are not captured, `replayed` False); the step
    equals the step without a group on the same batch by
    test_step_matches's measure against the single-process step."""
    import torch.distributed as dist

    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset as TSynthetic

    cfg = _config(tconfig)
    items = [TSynthetic(2, CLIP_SEC, SR, seed=3).get(i) for i in range(2)]
    clean, noisy = (torch.from_numpy(np.stack([x[k] for x in items])) for k in (0, 1))

    def one_step():
        state = create_train_state(cfg, device="cpu")
        step = make_train_step(cfg)
        state, metrics = step(state, clean, noisy)
        model = state.model
        return step, _port_step({k: float(v) for k, v in metrics.items()},
                                {n: p.detach().numpy() for n, p in model.named_parameters()},
                                {n: p.grad.numpy() for n, p in model.named_parameters()},
                                {n: b.numpy() for n, b in model.named_buffers()})

    _, want = one_step()
    sizes = []
    all_reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: sizes.append(t.numel()) or all_reduce(t, *a, **k))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        assert parallel.is_distributed() and parallel.world_size() == 1 and not parallel.capturable_collectives()
        step, got = one_step()
    finally:
        dist.destroy_process_group()
    n_params = sum(p.numel() for p in create_train_state(cfg, device="cpu").model.parameters())
    assert step.replayed is False and len(step._slots) == 1
    assert len(sizes) > 10 and sizes.count(n_params) == 1
    _check_step(got, want, NORM_RTOL["single_step"])
    np.testing.assert_allclose(got["stats"], want["stats"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bf16"])
def test_train_mode_batchnorm_takes_one_path_with_or_without_a_group(dtype):
    """A train-mode BatchNorm alone and in a gloo group of one rank runs the
    same arithmetic: output, input gradient and both running statistics are
    bit-equal."""
    import torch.distributed as dist

    x, upstream, _, _ = _reduce_inputs()

    def one_call():
        bn = BatchNorm(5, dtype=dtype).train()
        xt = torch.from_numpy(x).to(dtype or torch.float32).requires_grad_()
        y = bn(xt)
        (y.float() * torch.from_numpy(upstream)).sum().backward()
        return y.detach(), xt.grad, bn.running_mean.clone(), bn.running_var.clone()

    want = one_call()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        assert parallel.is_distributed()
        got = one_call()
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_several_processes_need_data_parallel(monkeypatch, tmp_path):
    """A world of several processes trains one model only under
    data_parallel: without it, train() refuses before any work."""
    monkeypatch.setattr(tloop.parallel, "initialize_distributed", lambda cfg, backend, data_parallel=False: 2)
    with pytest.raises(ValueError, match="data_parallel"):
        tloop.train(_config(tconfig, tmp_path), object(), device="cpu")


def test_local_device_and_backend(monkeypatch):
    """A bare cuda under torchrun is cuda:LOCAL_RANK; an explicit device is
    honoured; the default backend is nccl on a card, gloo on the CPU; one
    process without a launcher joins no group."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert parallel.local_device("cpu") == torch.device("cpu")
    assert parallel.local_device("cuda:0") == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        assert parallel.local_device("cuda") == torch.device("cuda", 1)
    assert parallel.default_backend(torch.device("cuda", 0)) == "nccl"
    assert parallel.default_backend("cpu") == "gloo"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.initialize_distributed(tconfig.DistConfig(), "gloo") == 1
    assert parallel.world_size() == 1 and parallel.rank() == 0
    assert parallel.loader_shard() == {"num_shards": 1, "shard_index": 0}
    with pytest.raises(ValueError, match="backend"):
        parallel.initialize_distributed(tconfig.DistConfig(), "mpi")
