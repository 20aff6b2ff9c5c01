"""`correct` as a run decides it: a sound run passes the cell's limits, and
the run comes out not correct with the timed path broken underneath (each
fault the cell can have) or with the control in the program's place. On
the CPU at the tiny size (the data-parallel cell in four processes over
gloo); the serving cells' control (TF32) needs a card."""

from __future__ import annotations

import pytest
import torch

from trubench import harness
from trubench.tests import tiny

CELLS = {"train": "proc16k-train-bf16", "stream": "proc16k-stream-256", "denoise": "large16k-denoise-mixed",
         "train_dp": "proc16k-train-dp4"}


def limits(traffic: str) -> dict:
    return harness.load_json("workloads", CELLS[traffic])["limits"]


def correct(outcome) -> bool:
    return all(c.ok for c in outcome.checks) and outcome.failed == 0


def _train_unchanged(step_fn):
    """The step computes its loss and gradients and leaves the state as it was."""
    run = step_fn._run

    def body(state, clean, noisy, h0):
        update, state.optimizer.step = state.optimizer.step, lambda *a, **k: None
        try:
            return run(state, clean, noisy, h0)
        finally:
            state.optimizer.step = update

    step_fn._run = body


def _train_half_batch(step_fn):
    """The step's loss, gradients and update from half of the batch."""
    run = step_fn._run
    step_fn._run = lambda state, clean, noisy, h0: run(state, clean[: len(clean) // 2], noisy[: len(noisy) // 2], h0)


def _dp_no_exchange(step_fn):
    """Each rank steps on its own gradients: the exchange between cards left out."""
    from tinyrecurrentunet_torch import parallel

    parallel.sum_gradients_ = lambda grads: None


def _dp_loads_jax(step_fn):
    """Rank 2 of 4 loads a module named `jax` before its window."""
    import sys
    import types

    import torch.distributed as dist

    if dist.get_rank() == 2:
        sys.modules["jax"] = types.ModuleType("jax")


def _stream_fault(kind):
    def apply(denoiser):
        step = denoiser._step_into

        def body():
            saved = [b.clone() for b in denoiser._buffers]
            step()
            if kind == "state_unchanged":
                for buf, old in zip(denoiser._buffers, saved):
                    buf.copy_(old)
            elif kind == "half_batch":
                denoiser._out[denoiser.num_streams // 2:] = 0
            else:  # an answer altered where it is produced
                denoiser._out[:, :16] *= -1

        denoiser._step_into = body
    return apply


def _denoise_altered(denoiser):
    run_into = denoiser._run_into

    def body(slot):
        run_into(slot)
        slot.output[: len(slot.output) // 8] *= -1

    denoiser._run_into = body


FAULTS = [
    ("train", "state_unchanged", _train_unchanged),
    ("train", "half_batch", _train_half_batch),
    ("stream", "state_unchanged", _stream_fault("state_unchanged")),
    ("stream", "half_batch", _stream_fault("half_batch")),
    ("stream", "answer_altered", _stream_fault("answer_altered")),
    ("denoise", "answer_altered", _denoise_altered),
    ("train_dp", "no_exchange", _dp_no_exchange),
    ("train_dp", "half_batch", _train_half_batch),
]


@pytest.mark.parametrize("traffic", ["train", "stream", "denoise", "train_dp"])
def test_sound_run_is_correct(traffic):
    assert correct(tiny.run(traffic, limits=limits(traffic)))


@pytest.mark.parametrize("traffic,fault", [(t, f) for t, f, _ in FAULTS])
def test_fault_is_not_correct(traffic, fault):
    apply = next(a for t, f, a in FAULTS if (t, f) == (traffic, fault))
    outcome = tiny.run(traffic, limits=limits(traffic), fault=apply)
    assert not correct(outcome), [(c.name, c.value, c.limit) for c in outcome.checks]


def test_train_control_reads_above_the_program():
    """The reference in float8 in the program's (bfloat16's) place reads at
    least three times the program's gap on one of the numbers compared."""
    outcome = tiny.run("train", calibrate=True)
    program = {c.name: c.value for c in outcome.checks}
    control = outcome.facts["control"]
    assert any(control[name] >= 3 * program[name] for name in program), (program, control)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_train_control_is_not_correct(seed):
    """The reference in float8 in the program's place, held to the cell's
    limits by the same checks, is not correct where the program is."""
    outcome = tiny.run("train", seed=seed, limits=limits("train"), calibrate=True)
    assert correct(outcome), [(c.name, c.value, c.limit) for c in outcome.checks]
    control = outcome.facts["control_checks"]
    assert [c.name for c in control] == [c.name for c in outcome.checks]
    assert not all(c.ok for c in control), [(c.name, c.value, c.limit) for c in control]


def test_a_rank_that_loads_jax_prints_no_result(monkeypatch, capsys):
    """The data-parallel cell's ranks, which alone import the timed path,
    are held to the check on JAX too: a run in which one rank loaded `jax`
    ends with an error naming it and prints no result line."""
    from trubench import run

    ctx = tiny.context("train_dp", limits=limits("train_dp"), fault=_dp_loads_jax)
    monkeypatch.setattr(run, "_caches", lambda: None)
    monkeypatch.setattr(run, "check_card", lambda chips: None)
    monkeypatch.setattr(run, "context", lambda *args: ctx)
    with pytest.raises(RuntimeError, match=r"\{2: \['jax'\]\}"):
        run.main(["--workload", CELLS["train_dp"], "--seed", "11", "--seconds", "0.3"])
    assert "correct" not in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["stream", "denoise"])
def test_serving_control_reads_above_the_limit(traffic):
    """The reference with TF32 on in the program's place fails the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("TF32, the control of a float32 configuration, exists only on a card")
    ctx = tiny.context(traffic, limits=limits(traffic), calibrate=True)
    ctx.device = "cuda"
    outcome = harness.load_module("traffic", traffic).run(ctx)
    assert correct(outcome)
    assert not all(c.ok for c in outcome.facts["control_checks"])
