"""The train step as one program a batch shape (`train/step.py` slots), on
the CPU: against the JAX package's jitted, donated step, and against the
eager step it replaces, bit for bit where the arithmetic is the same. A
narrow network, 0.25 s clips and one STFT bank, as in
tests/test_torch_train.py. On a card the same slots hold a CUDA graph; its
tests are in tests/test_torch_cuda.py.

The eval step (`EvalStep`, one program a validation batch shape) the same
way: against the JAX package's jitted eval step, every loss term within
1e-5 relative from identical weights after one train step (measured <= 2e-7:
the same float32 arithmetic summed in another order); against the eager
eval call it replaces, bit for bit.

Tolerances: against JAX those of
tests/test_torch_train.py::test_one_train_step_matches_jax (loss terms 1e-4
relative, grad_norm 2e-3, BatchNorm statistics and the carry 1e-5
absolute); against the eager step none (torch.equal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset as TSynthetic
from tinyrecurrentunet_torch.losses import MultiResolutionSTFTLoss, loss_fn
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.signal import stft as tstft
from tinyrecurrentunet_torch.train import loop as tloop
from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
from tinyrecurrentunet_torch.train.state import (
    create_train_state,
    load_optimizer_state,
    make_schedule,
)
from tinyrecurrentunet_torch.train.step import (
    _snapshot,
    clip_by_global_norm_,
    global_norm,
    make_eval_step,
    make_train_step,
)
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter
from tinyrecurrentunet_torch.weights import state_dict_from_variables, variables_from_state_dict
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.models import TRUNet as JTRUNet
from tinyrecurrentunet_tpu.train.state import TrainState as JTrainState
from tinyrecurrentunet_tpu.train.state import make_optimizer as jmake_optimizer
from tinyrecurrentunet_tpu.train.step import make_eval_step as jmake_eval_step
from tinyrecurrentunet_tpu.train.step import make_train_step as jmake_train_step

torch.set_num_threads(2)

TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)
SR = 16000
CLIP_SEC = 0.25
CARRY = [False, True]
CARRY_IDS = ["whole_clip", "tbptt_carry"]


def _config(mod, log_dir="ckpt", **opt):
    """tests/test_torch_train.py's config: the tiny network, L1, MR-STFT and
    noise-side MR-STFT on one bank, batch 2 of 0.25 s clips."""
    opt = {"n_iters": 100, "learning_rate": 8e-4, "batch_size_per_device": 2, "grad_clip_norm": 1.0, **opt}
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


def _batch(batch=2, seed=3):
    ds = TSynthetic(num_items=batch, length_sec=CLIP_SEC, sample_rate=SR, seed=seed)
    items = [ds.get(i) for i in range(batch)]
    return np.stack([c for c, _, _ in items]), np.stack([n for _, n, _ in items])


def _carry(state, batch=2, seed=4):
    fb = state.model.bottleneck_freqs(_config(tconfig).featurizer.num_freqs)
    return (0.3 * np.random.default_rng(seed).standard_normal((batch, fb, 16))).astype(np.float32)


def _tensors(state) -> dict:
    """Every tensor a step reads or writes: parameters, gradients, buffers,
    the optimizer's state."""
    model, opt = state.model, state.optimizer
    out = {f"param/{n}": p for n, p in model.named_parameters()}
    out.update({f"grad/{n}": p.grad for n, p in model.named_parameters()})
    out.update({f"buffer/{n}": b for n, b in model.named_buffers()})
    for i, p in enumerate(model.parameters()):
        out.update({f"opt/{i}/{k}": v for k, v in opt.state.get(p, {}).items()})
    return out


def _assert_equal_states(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name
    assert a.step == b.step


def _assert_equal_metrics(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _eager_step(cfg, state, clean, noisy, tgru_h0=None):
    """The step as the port ran it launch by launch before it had slots:
    gradients set to None, loss, backward, global norm, clip, the rate
    assigned, AdamW."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, loss_dict, tgru_h = loss_fn(model, clean, noisy, Featurizer(cfg.featurizer), cfg.network,
                                      cfg.train.loss_config, tgru_h0=tgru_h0)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics["grad_norm"] = global_norm(grads)
    clip_by_global_norm_(grads, cfg.train.optimization.grad_clip_norm, metrics["grad_norm"])
    for group in state.optimizer.param_groups:
        group["lr"] = make_schedule(cfg)(state.step)
    state.optimizer.step()
    state.step += 1
    return metrics, (tgru_h.detach() if tgru_h0 is not None else None)


# ------------------------------------------------------------------ against JAX


@pytest.mark.parametrize("with_carry", CARRY, ids=CARRY_IDS)
def test_two_calls_of_a_slot_match_the_jitted_donated_step(with_carry):
    """Two calls of one slot (the second on another batch, its carry the one
    the first returned, passed back) against two calls of the JAX step, its
    state and carry donated. Before the second call the port's model takes
    the JAX step's weights and statistics in place (the slot's addresses
    stay), so that each call is held as one step from identical weights:
    loss terms 1e-4 relative and grad_norm 2e-3, BatchNorm statistics and
    the carry 1e-5 after each. (Across two AdamW steps the first step's
    +-lr(0) on near-zero gradients moves grad_norm by ~2e-3.)"""
    jcfg, tcfg = _config(jconfig), _config(tconfig)
    state = create_train_state(tcfg, device="cpu")
    variables = jax.tree_util.tree_map(jnp.array, variables_from_state_dict(state.model.state_dict()))
    jmodel = JTRUNet(jcfg.network)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                batch_stats=variables["batch_stats"], tx=jmake_optimizer(jcfg))
    step = make_train_step(tcfg, with_carry=with_carry)
    jstep = jmake_train_step(jcfg, jmodel, with_carry=with_carry)
    h0 = _carry(state)
    carry, jcarry = torch.from_numpy(h0), jnp.array(h0)
    for seed in (3, 5):
        if seed == 5:
            jvars = {"params": jstate.params, "batch_stats": jstate.batch_stats}
            state.model.load_state_dict(state_dict_from_variables(jax.tree_util.tree_map(np.asarray, jvars)))
        clean, noisy = _batch(seed=seed)
        out = step(state, torch.from_numpy(clean), torch.from_numpy(noisy), *((carry,) if with_carry else ()))
        jout = jstep(jstate, jnp.array(clean), jnp.array(noisy), *((jcarry,) if with_carry else ()))
        jstate = jout[0]
        metrics, jmetrics = out[1], jout[1]
        assert sorted(metrics) == sorted(jmetrics)
        for name in metrics:
            rtol = 2e-3 if name == "grad_norm" else 1e-4
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=rtol,
                                       err_msg=f"{name}, step {state.step}")
        stats = variables_from_state_dict(state.model.state_dict())["batch_stats"]
        for got, want in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(jstate.batch_stats)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5)
        if with_carry:
            carry, jcarry = out[2], jout[2]
            assert carry is step._slots[next(iter(step._slots))].carry  # the slot's buffer, donated back
            np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), rtol=0, atol=1e-5)
    assert state.step == int(jstate.step) == 2 and len(step._slots) == 1


# ------------------------------------------------------- against the eager step


@pytest.mark.parametrize("with_carry", CARRY, ids=CARRY_IDS)
def test_three_calls_of_a_slot_are_bit_equal_to_three_eager_steps(with_carry):
    """The slot's body zeroes the gradients in place and backward adds into
    them, where the eager step set them to None and backward filled them:
    the same bits, step after step."""
    cfg = _config(tconfig)
    a, b = create_train_state(cfg, device="cpu"), create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, with_carry=with_carry)
    h0 = torch.from_numpy(_carry(a))
    carry_a, carry_b = h0, h0.clone()
    for seed in (3, 5, 7):
        clean, noisy = (torch.from_numpy(x) for x in _batch(seed=seed))
        out = step(a, clean, noisy, *((carry_a,) if with_carry else ()))
        metrics_b, carry_b = _eager_step(cfg, b, clean, noisy, carry_b if with_carry else None)
        _assert_equal_metrics(out[1], metrics_b)
        _assert_equal_states(a, b)
        if with_carry:
            carry_a = out[2]
            assert torch.equal(carry_a, carry_b)


@pytest.mark.parametrize("resumed", [False, True], ids=["no_optimizer_state", "resumed"])
@pytest.mark.parametrize("with_carry", CARRY, ids=CARRY_IDS)
def test_warm_up_then_restore_is_bit_equal_to_a_fresh_step(tmp_path, resumed, with_carry):
    """What a slot's first call on a card does before its capture: snapshot
    the state, 3 steps of the body, restore in place. One step after it
    equals one step from the state as it was, whether the optimizer had no
    state yet (it is made by the warm-up and goes back to zeros and step 0)
    or had one from a checkpoint."""
    cfg = _config(tconfig, tmp_path / "ckpt")
    clean, noisy = (torch.from_numpy(x) for x in _batch())
    a, b = create_train_state(cfg, device="cpu"), create_train_state(cfg, device="cpu")
    if resumed:
        first = create_train_state(cfg, device="cpu")
        make_train_step(cfg, with_carry=with_carry)(first, clean, noisy,
                                                   *((torch.from_numpy(_carry(first)),) if with_carry else ()))
        ckpt = CheckpointManager(str(tmp_path / "ckpt"), "TRUNet")
        ckpt.save(0, first)
        for state in (a, b):
            ckpt.restore(state, 0)
        assert a.optimizer.state and a.step == 1
    step = make_train_step(cfg, with_carry=with_carry)
    h0 = torch.from_numpy(_carry(a, seed=9))
    slot = step.buffers(a, tuple(clean.shape), clean.dtype)
    for buf, x in ((slot.clean, clean), (slot.noisy, noisy), (slot.carry, h0)):
        if buf is not None:
            buf.copy_(x)
    restore = _snapshot(a, slot)
    for seed in (11, 12, 13):  # the warm-up, on other batches
        slot.clean.copy_(clean * (seed / 10))
        step._body(a, slot)
    restore()
    slot.clean.copy_(clean)
    assert a.optimizer.state  # made by the warm-up where there was none, now AdamW's initial values
    out = step(a, clean, noisy, *((slot.carry,) if with_carry else ()))
    ref = make_train_step(cfg, with_carry=with_carry)(b, clean, noisy, *((h0,) if with_carry else ()))
    _assert_equal_metrics(out[1], ref[1])
    _assert_equal_states(a, b)
    if with_carry:
        assert torch.equal(out[2], ref[2])


# -------------------------------------------------------------------- the slots


def test_each_batch_shape_has_its_own_slot_and_shapes_in_turns_do_not_cross():
    cfg = _config(tconfig)
    a, b = create_train_state(cfg, device="cpu"), create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    batches = [_batch(2, seed=3), _batch(3, seed=4), _batch(2, seed=5), _batch(3, seed=6)]
    for clean, noisy in batches:
        clean, noisy = torch.from_numpy(clean), torch.from_numpy(noisy)
        _, got = step(a, clean, noisy)
        want, _ = _eager_step(cfg, b, clean, noisy)
        _assert_equal_metrics(got, want)
        _assert_equal_states(a, b)
    assert sorted(shape for _, _, shape, _ in step._slots) == [(2, 4000), (3, 4000)]


def test_a_returned_carry_passed_back_equals_a_clone_and_a_foreign_carry_is_copied_in():
    cfg = _config(tconfig)
    a, b = create_train_state(cfg, device="cpu"), create_train_state(cfg, device="cpu")
    step_a, step_b = make_train_step(cfg, with_carry=True), make_train_step(cfg, with_carry=True)
    h0 = torch.from_numpy(_carry(a))
    (c1, n1), (c2, n2) = (tuple(torch.from_numpy(x) for x in _batch(seed=s)) for s in (3, 5))
    _, _, carry_a = step_a(a, c1, n1, h0)
    _, _, carry_b = step_b(b, c1, n1, h0)
    slot = next(iter(step_a._slots.values()))
    assert carry_a is slot.carry and carry_a is not h0 and torch.equal(carry_b, carry_a)
    kept = h0.clone()
    _, m_a, carry_a = step_a(a, c2, n2, carry_a)  # the slot's own buffer, read where it lies
    _, m_b, carry_b = step_b(b, c2, n2, carry_b.clone())  # a foreign carry, copied in
    assert torch.equal(h0, kept)  # a foreign carry is never written
    _assert_equal_metrics(m_a, m_b)
    _assert_equal_states(a, b)
    assert torch.equal(carry_a, carry_b)


def test_returned_metrics_are_not_overwritten_by_the_next_call():
    cfg = _config(tconfig)
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    clean, noisy = (torch.from_numpy(x) for x in _batch())
    _, first = step(state, clean, noisy)
    kept = {k: v.clone() for k, v in first.items()}
    _, second = step(state, clean, noisy)
    _assert_equal_metrics(first, kept)
    assert not torch.equal(first["loss"], second["loss"])


def test_a_reloaded_optimizer_gets_a_new_slot(tmp_path):
    """Loading the optimizer's state again moves its tensors: the next call
    builds the slot anew (on a card: captures anew) and the step stays the
    eager step's."""
    cfg = _config(tconfig, tmp_path / "ckpt")
    a, b = create_train_state(cfg, device="cpu"), create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    clean, noisy = (torch.from_numpy(x) for x in _batch())
    step(a, clean, noisy)
    _eager_step(cfg, b, clean, noisy)
    (key, slot), = step._slots.items()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), "TRUNet")
    ckpt.save(0, a)
    ckpt.restore(a, 0)
    assert step.buffers(a, tuple(clean.shape), clean.dtype) is not slot
    _, got = step(a, clean, noisy)
    want, _ = _eager_step(cfg, b, clean, noisy)
    _assert_equal_metrics(got, want)
    _assert_equal_states(a, b)
    assert step._slots[key] is not slot and step._slots[key].addresses is not None


def test_a_checkpoint_of_the_card_optimizer_restores_on_the_cpu_and_back(tmp_path):
    """A checkpoint as the card's capturable AdamW writes it (its rate a
    tensor, its flags set, its step counts float32 tensors) restores into
    the CPU's optimizer, which keeps its own form and steps on bit-equal to
    the run that wrote it; a CPU checkpoint restores into the capturable
    form, whose rate tensor stays the one a graph would hold."""
    cfg = _config(tconfig, tmp_path / "ckpt")
    clean, noisy = (torch.from_numpy(x) for x in _batch())
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    step(state, clean, noisy)
    card_form = state.optimizer.state_dict()
    card_form["param_groups"] = [{**g, "lr": torch.tensor(g["lr"], dtype=torch.float32), "capturable": True,
                                  "foreach": True} for g in card_form["param_groups"]]
    path = os.path.join(str(tmp_path), "card.pt")
    torch.save({"model": state.model.state_dict(), "optimizer": card_form, "updates": 1, "iter": 0,
                "training_time_seconds": 0}, path)
    resumed = create_train_state(cfg, device="cpu")
    payload = torch.load(path, weights_only=True)
    resumed.model.load_state_dict(payload["model"])
    load_optimizer_state(resumed.optimizer, payload["optimizer"])
    resumed.step = 1
    group = resumed.optimizer.param_groups[0]
    assert isinstance(group["lr"], float) and not group["capturable"] and not group["foreach"]
    steps = [s["step"] for s in resumed.optimizer.state.values()]
    assert all(s.device.type == "cpu" and s.dtype == torch.float32 and float(s) == 1 for s in steps)
    make_train_step(cfg)(resumed, clean, noisy)
    step(state, clean, noisy)
    _assert_equal_states(resumed, state)

    lr = torch.tensor(0.5)
    capturable = torch.optim.AdamW(resumed.model.parameters(), lr=lr, capturable=True, foreach=True)
    load_optimizer_state(capturable, resumed.optimizer.state_dict())
    group = capturable.param_groups[0]
    assert group["lr"] is lr and group["capturable"] and group["foreach"]
    for p, s in capturable.state.items():
        assert s["step"].dtype == torch.float32 and s["step"].device == p.device and float(s["step"]) == 2
        assert torch.equal(s["exp_avg"], resumed.optimizer.state[p]["exp_avg"])


# --------------------------------------------------------------------- the loop


class _Watched:
    """A train step that records, at each call, whether its inputs were the
    slot's own buffers and the carry it was given."""

    def __init__(self, step):
        self.step, self.calls = step, []

    def buffers(self, *args):
        return self.step.buffers(*args)

    def close(self):
        self.step.close()

    def __call__(self, state, clean, noisy, *carry):
        slot = self.step.buffers(state, tuple(clean.shape), clean.dtype)
        self.calls.append({"static": clean is slot.clean and noisy is slot.noisy,
                           "carry": carry[0].clone() if carry else None,
                           "own_carry": bool(carry) and carry[0] is slot.carry})
        return self.step(state, clean, noisy, *carry)


@pytest.mark.parametrize("segment_sec", [0.0, 0.125], ids=["whole_clip", "tbptt"])
def test_the_loop_feeds_the_slot(tmp_path, monkeypatch, segment_sec):
    """train() on the device corpus: a whole-clip batch is gathered into the
    slot's static inputs; a TBPTT batch starts its first segment from a
    carry of zeros in the slot's own buffer and passes that buffer on."""
    watched = []
    make = tloop.make_train_step
    monkeypatch.setattr(tloop, "make_train_step", lambda *a, **k: watched.append(_Watched(make(*a, **k)))
                        or watched[-1])
    monkeypatch.setattr(tloop, "MetricsWriter", lambda *a, **k: MetricsWriter(*a, use_tensorboard=False, **k))
    cfg = _config(tconfig, tmp_path / "ckpt", tbptt_segment_sec=segment_sec)
    state, metrics = tloop.train(cfg, TSynthetic(4, CLIP_SEC, SR), max_iters=3, log_dir=str(tmp_path / "logs"),
                                 device="cpu")
    calls = watched[0].calls
    assert np.isfinite(metrics["loss"])
    if not segment_sec:
        assert len(calls) == 3 and all(c["static"] for c in calls)
        return
    assert len(calls) == 6 and state.step == 6 and all(c["own_carry"] for c in calls)
    for first, second in zip(calls[::2], calls[1::2]):
        assert not first["carry"].any() and second["carry"].abs().max() > 0


# --------------------------------------------------------------- the eval step

EVAL_RTOL = 1e-5  # each loss term, port against JAX (measured <= 2e-7)


def _eager_eval(cfg, state, clean, noisy) -> dict:
    """The eval call as the port ran it before it had slots."""
    state.model.eval()
    with torch.no_grad():
        _, loss_dict, _ = loss_fn(state.model, clean, noisy, Featurizer(cfg.featurizer), cfg.network,
                                  cfg.train.loss_config)
    return loss_dict


def _trained_state(cfg):
    """A state after one train step: its running statistics are not the
    initial ones."""
    state = create_train_state(cfg, device="cpu")
    make_train_step(cfg)(state, *(torch.from_numpy(x) for x in _batch(seed=3)))
    return state


def test_eval_step_matches_the_jitted_jax_eval_step():
    jcfg, tcfg = _config(jconfig), _config(tconfig)
    state = _trained_state(tcfg)
    variables = jax.tree_util.tree_map(jnp.array, variables_from_state_dict(state.model.state_dict()))
    jmodel = JTRUNet(jcfg.network)
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                batch_stats=variables["batch_stats"], tx=jmake_optimizer(jcfg))
    clean, noisy = _batch(3, seed=8)
    got = make_eval_step(tcfg)(state, torch.from_numpy(clean), torch.from_numpy(noisy))
    want = jmake_eval_step(jcfg, jmodel)(jstate, jnp.array(clean), jnp.array(noisy))
    assert sorted(got) == sorted(want) and "loss" in got
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=EVAL_RTOL, err_msg=name)
    assert not state.model.training


def test_each_validation_shape_has_its_own_eval_slot_and_shapes_in_turns_do_not_cross():
    cfg = _config(tconfig)
    state = _trained_state(cfg)
    evaluate = make_eval_step(cfg)
    for batch, seed in ((2, 3), (3, 4), (2, 5), (3, 6)):
        clean, noisy = (torch.from_numpy(x) for x in _batch(batch, seed=seed))
        _assert_equal_metrics(evaluate(state, clean, noisy), _eager_eval(cfg, state, clean, noisy))
    assert sorted(shape for _, shape, _ in evaluate._slots) == [(2, 4000), (3, 4000)]


def test_an_eval_slot_reads_the_running_statistics_the_train_steps_left():
    """The eval slot's call after train steps on the same state reads the
    weights and statistics where they lie: the eager eval call's bits on
    the updated state, in the slot it had."""
    cfg = _config(tconfig)
    state = create_train_state(cfg, device="cpu")
    train, evaluate = make_train_step(cfg), make_eval_step(cfg)
    clean, noisy = (torch.from_numpy(x) for x in _batch(seed=8))
    before = evaluate(state, clean, noisy)
    slot = evaluate.buffers(state, tuple(clean.shape), clean.dtype)
    stats = [b.clone() for b in state.model.buffers()]
    for seed in (3, 5):
        train(state, *(torch.from_numpy(x) for x in _batch(seed=seed)))
    assert not all(torch.equal(a, b) for a, b in zip(stats, state.model.buffers()))
    after = evaluate(state, slot.clean, slot.noisy)
    _assert_equal_metrics(after, _eager_eval(cfg, state, clean, noisy))
    assert not torch.equal(after["loss"], before["loss"])
    assert list(evaluate._slots.values()) == [slot]


def test_a_reloaded_model_gets_a_new_eval_slot():
    """Weights loaded by assignment move every parameter and buffer: the
    next call builds the slot anew (on a card: captures anew) and gives the
    eager eval call's bits on the new weights."""
    cfg = _config(tconfig)
    state, other = create_train_state(cfg, device="cpu"), _trained_state(cfg)
    evaluate = make_eval_step(cfg)
    clean, noisy = (torch.from_numpy(x) for x in _batch(seed=8))
    evaluate(state, clean, noisy)
    (key, slot), = evaluate._slots.items()
    state.model.load_state_dict({k: v.clone() for k, v in other.model.state_dict().items()}, assign=True)
    assert evaluate.buffers(state, tuple(clean.shape), clean.dtype) is not slot
    _assert_equal_metrics(evaluate(state, clean, noisy), _eager_eval(cfg, other, clean, noisy))
    assert evaluate._slots[key] is not slot and evaluate._slots[key].addresses is not None


class _WatchedEval:
    """An eval step that records, at each call, whether its inputs were the
    slot's own buffers."""

    def __init__(self, evaluate):
        self.evaluate, self.calls = evaluate, []

    def buffers(self, *args):
        return self.evaluate.buffers(*args)

    def close(self):
        """The eval step's slots as train() left them, then the step closed."""
        self.slots = dict(self.evaluate._slots)
        self.evaluate.close()

    def __call__(self, state, clean, noisy):
        slot = self.evaluate.buffers(state, tuple(clean.shape), clean.dtype)
        self.calls.append(clean is slot.clean and noisy is slot.noisy)
        return self.evaluate(state, clean, noisy)


def test_the_loop_validates_through_the_eval_slot(tmp_path, monkeypatch):
    """train() makes the validation batch once, in the eval slot's static
    inputs, and passes those at every validation pass: the logged
    validation loss is the eager eval call's on that batch."""
    watched = []
    make = tloop.make_eval_step
    monkeypatch.setattr(tloop, "make_eval_step", lambda cfg: watched.append(_WatchedEval(make(cfg))) or watched[-1])
    monkeypatch.setattr(tloop, "MetricsWriter", lambda *a, **k: MetricsWriter(*a, use_tensorboard=False, **k))
    cfg = _config(tconfig, tmp_path / "ckpt")
    valid = TSynthetic(3, CLIP_SEC, SR, seed=999)
    state, metrics = tloop.train(cfg, TSynthetic(4, CLIP_SEC, SR), max_iters=2, log_dir=str(tmp_path / "logs"),
                                 valid_dataset=valid, device="cpu")
    (evaluate,) = watched
    assert evaluate.calls == [True, True] and len(evaluate.slots) == 1
    assert evaluate.evaluate.closed and not evaluate.evaluate._slots  # train() closed it at its end
    slot = next(iter(evaluate.slots.values()))
    assert slot.clean.shape == (2, 4000)  # batch_size_per_device items of the 3
    assert metrics["valid_loss"] == float(_eager_eval(cfg, state, slot.clean, slot.noisy)["loss"])


# ------------------------------------------------------------ the Hann window


def test_hann_window_is_built_once_per_length_and_device_and_bit_equal_to_the_formula():
    n = np.arange(240)
    want = torch.tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * n / 240), dtype=torch.float32)
    win = tstft.hann_window(240)
    assert torch.equal(win, want) and win.dtype == torch.float32
    assert tstft.hann_window(240, device="cpu") is win and tstft.hann_window(240, torch.device("cpu")) is win
    assert tstft.hann_window(241) is not win
    built = tstft._hann_window.cache_info().currsize
    tstft.hann_window(240)
    tstft.hann_window(241)
    assert tstft._hann_window.cache_info().currsize == built


def test_hann_window_made_in_inference_mode_serves_the_loss_outside_it():
    """A window first asked for under inference mode (as a denoiser would)
    is an ordinary tensor: the MR-STFT loss saves it for backward."""
    cfg = _config(tconfig).train.loss_config.stft_config
    cfg = dataclasses.replace(cfg, win_lengths=(236,))
    with torch.inference_mode():
        tstft.hann_window(236)
    assert not tstft.hann_window(236).is_inference()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32)).requires_grad_()
    y = torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32))
    sc, mag = MultiResolutionSTFTLoss(cfg)(x, y)
    (sc + mag).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
