"""Training: the program's `TrainStep` called step after step on batches
gathered on the card from a corpus made in set-up, as the training loop
feeds its device corpus (train/loop.py:241-253), closed loop with at most
`inflight` steps queued ahead of the card.

Parameters (the cell's `params`): `corpus` (clean, noisy) pairs of the
configuration's crop, each with its own noise kind and SNR, made from the
seed and uploaded once; each step gathers the configuration's batch of
distinct rows, in a fresh seeded permutation of the corpus each pass,
straight into the step's static inputs; `slice_steps` steps are profiled
in a traced run.

Set-up builds the train state as the port does (`create_train_state`, TF32
off) and loads into it weights drawn on the card from the seed
(`reference/weights.py`), makes the corpus, and runs the first
`check_steps` steps through the window's own call and feed (the first
captures the step's graph); the window goes on with the same state.

End to end: `train_audio_s_per_s`, the clips times the crop's seconds of
every step in the window, over the window, which ends at the synchronize
after its last step.

Checked, against the reference's steps from the same weights on the same
rows (`reference/train.py`, float32), over the leaves whose reference
gradient is at least a thousandth of the median leaf's (the others are
round-off: biases a BatchNorm cancels): `loss_gap`, the largest relative
gap of the first steps' losses; `change_gap`, the median leaf's gap
between the norms of its change over those steps as the program and the
reference have it, over the larger of the reference leaf's norm and the
median leaf's (a step that leaves its state unchanged reads 1);
`grad_dir_gap`, the median leaf's 1 - cos of the angle between the first
step's clipped gradient as the program has it (AdamW's first moment after
one step) and the reference's. The gap of the gradient's norms, median and
worst leaf, and the worst leaf's change are kept beside them
(`facts["program"]`). The control is the reference computed in float8
(e4m3, scaled per tensor) where the configuration computes in bfloat16;
with `ctx.calibrate` it is read beside the program, and held to the same
limits (`facts["control_checks"]`), as is the reference on half of each
batch in the program's place.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from trubench import harness
from trubench.inputs import procgen
from trubench.reference import net, signal, weights
from trubench.reference import train as reference
from trubench.work import gru

B1 = reference.B1
CHECKED = ("loss_gap", "change_gap", "grad_dir_gap")


def corpus(seed: int, items: int, length: int, sr: int):
    rng = np.random.default_rng(seed)
    kinds = procgen.ADDITIVE_KINDS
    pairs = [procgen.noisy_pair(rng, length, sr, kinds[i % len(kinds)]) for i in range(items)]
    return np.stack([c for c, _ in pairs]), np.stack([x for _, x in pairs])


def batches(seed: int, items: int, batch: int, steps: int) -> np.ndarray:
    """(steps, batch) rows: a fresh seeded permutation of the corpus each pass."""
    rng = np.random.default_rng((seed, 1))
    per_pass = items // batch
    perms = [rng.permutation(items)[:per_pass * batch].reshape(per_pass, batch) for _ in range(-(-steps // per_pass))]
    return np.concatenate(perms)[:steps]


def leaf_gaps(program: dict, ref: dict, keys) -> dict:
    """Each leaf's |‖program‖ - ‖reference‖| over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in keys}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(program[k].norm()) - norms[k]) / max(norms[k], median) for k in keys}


def direction_gap(program: dict, ref: dict, keys) -> float:
    """The median leaf's 1 - cos of the angle between the program's and the
    reference's tensors."""
    return float(np.median([1.0 - float((program[k] * ref[k]).sum() / (program[k].norm() * ref[k].norm()))
                            for k in keys]))


def worst(gaps: dict) -> tuple[str, float]:
    leaf = max(gaps, key=gaps.get)
    return leaf, gaps[leaf]


class Feed:
    """The program's train state and step on `device`, with weights drawn
    from the run's seed, and a corpus and an order of rows drawn from
    `seed`: `step()` gathers the next batch into the step's static inputs
    and runs one step (the training loop's feed, train/loop.py:241-253)."""

    def __init__(self, ctx: harness.Context, device, seed: int):
        from tinyrecurrentunet_torch.train.state import create_train_state
        from tinyrecurrentunet_torch.train.step import make_train_step

        p, fz = ctx.params, ctx.config["featurizer"]
        self.length = int(ctx.config["crop_length_sec"] * fz["sample_rate"])
        self.batch = ctx.config["optimization"]["batch_size_per_device"]
        cfg = ctx.program_config()
        self.state = create_train_state(cfg, device=device)
        self.initial = weights.seeded(self.state.model.state_dict(), ctx.seed, device)
        self.state.model.load_state_dict(self.initial)
        self.clean_np, self.noisy_np = corpus(seed, p["corpus"], self.length, fz["sample_rate"])
        self.clean, self.noisy = (torch.from_numpy(x).to(device) for x in (self.clean_np, self.noisy_np))
        self.rows = batches(seed, p["corpus"], self.batch, p["max_steps"])
        self._rows = torch.from_numpy(self.rows).to(device)
        self.step_fn = make_train_step(cfg)
        if ctx.fault is not None:
            ctx.fault(self.step_fn)
        self.done = 0

    def step(self, spans: bool = False):
        """One step on the next rows; returns its loss (on the device)."""
        with harness.span("gather", spans):
            slot = self.step_fn.buffers(self.state, (self.batch, self.length), torch.float32)
            torch.index_select(self.clean, 0, self._rows[self.done], out=slot.clean)
            torch.index_select(self.noisy, 0, self._rows[self.done], out=slot.noisy)
        with harness.span("step", spans):
            self.state, metrics = self.step_fn(self.state, slot.clean, slot.noisy)
        self.done += 1
        return metrics["loss"]

    def first_steps(self, count: int) -> tuple[list, dict, dict]:
        """`count` steps: (their losses, the first step's clipped gradient as
        AdamW's first moment holds it (a step that moved nothing left none,
        read as zeros), the parameters after them)."""
        losses, first_grad = [], None
        for _ in range(count):
            losses.append(self.step())
            if first_grad is None:
                first_grad = {n: self.state.optimizer.state.get(q, {}).get("exp_avg", torch.zeros_like(q)).detach()
                              / (1 - B1) for n, q in self.state.model.named_parameters()}
        after = {n: q.detach().clone() for n, q in self.state.model.named_parameters()}
        return [float(x) for x in losses], first_grad, after

    def check_batches(self, count: int) -> list:
        """The (clean, noisy) rows of the first `count` steps."""
        return [(self.clean_np[self.rows[k]], self.noisy_np[self.rows[k]]) for k in range(count)]

    def gru_bound_s(self, ctx: harness.Context, steps: int) -> float:
        """The least time of `steps` steps' three trainable recurrences."""
        fz, net_cfg = ctx.config["featurizer"], ctx.config["network"]
        frames, fb = 1 + self.length // fz["hop_length"], net.bottleneck_freqs(net_cfg, fz["n_fft"] // 2 + 1)
        return steps * (2 * gru.train_bound_s(self.batch * frames, fb, net_cfg["fgru_hidden"])
                        + gru.train_bound_s(self.batch * fb, frames, net_cfg["tgru_hidden"]))

    def close(self):
        """The step's graphs and the state dropped, their memory freed."""
        self.step_fn.close()
        self.state = self.step_fn = self.clean = self.noisy = self._rows = None
        harness.free_program()


def run(ctx: harness.Context) -> harness.Outcome:
    from tinyrecurrentunet_torch.ops import cuda_gru

    p = ctx.params
    feed = Feed(ctx, ctx.device, ctx.seed)
    program = feed.first_steps(p["check_steps"])
    harness.settle(ctx.device)

    on_card = ctx.device == "cuda"
    queued, window_losses = collections.deque(), []
    setup_s = ctx.setup_s()
    start = time.perf_counter()
    while True:
        window_losses.append(feed.step())
        if on_card:
            event = torch.cuda.Event()
            event.record()
            queued.append(event)
            if len(queued) > p["inflight"]:
                queued.popleft().synchronize()
        if time.perf_counter() - start >= ctx.seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    window = time.perf_counter() - start
    steps = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    peak = harness.memory_peak(ctx.device)
    frames = 1 + feed.length // ctx.config["featurizer"]["hop_length"]
    facts = {"window_s": window, "forward_frames": 3 * steps * feed.batch * frames, "dtype": ctx.config["train_dtype"]}

    slice_ = None
    if ctx.trace:
        from trubench import trace

        slice_ = trace.traced(lambda: feed.step(True), p["slice_steps"], p["named_steps"],
                              lambda: sum(cuda_gru.launch_counts().values()))
        facts["slice_gru_bound_s"] = feed.gru_bound_s(ctx, p["slice_steps"])
    feed.close()
    checks = compare(ctx, facts, feed.initial, program, feed.check_batches(p["check_steps"]))
    e2e = {"train_audio_s_per_s": steps * feed.batch * ctx.config["crop_length_sec"] / window, "setup_s": setup_s}
    return harness.Outcome(e2e, steps, failed, checks, peak, facts, slice_)


def follow(config: dict, initial: dict, batches_: list, device, q=net.FLOAT32, half: bool = False,
           recompute_rows: int = 0):
    """(losses, first clipped gradient, change) of the reference's steps
    from `initial` over `batches_`, a (clean, noisy) numpy pair a step; with
    `half`, on the first half of each batch."""
    fz = config["featurizer"]
    batch = len(batches_[0][0])
    trainer = reference.Trainer(initial, config, device, q=q, rows=slice(0, batch // 2) if half else None,
                                recompute_rows=recompute_rows)
    got, grad = [], None
    for clean, noisy in batches_:
        spec = signal.offline_spectra(noisy, fz["n_fft"], fz["hop_length"])
        feats = torch.from_numpy(signal.features(spec, fz, streaming=False)).to(device)
        value, grads = trainer.step(torch.from_numpy(clean).to(device), torch.from_numpy(noisy).to(device), feats,
                                    torch.from_numpy(spec).to(device))
        got.append(value)
        grad = grads if grad is None else grad
    change = {n: trainer.params[n].detach() - initial[n].to(device) for n in trainer.trained}
    return got, grad, change


def numbers(side, ref, leaves: dict | None = None) -> dict:
    """The numbers compared, and those kept beside them, of `side` (losses,
    first gradient, change) against the reference's; `leaves` receives the
    worst leaves."""
    ref_losses, ref_grad, ref_change = ref
    s_losses, s_grad, s_change = side
    median = float(np.median([float(ref_grad[k].norm()) for k in ref_grad]))
    moved = [k for k in ref_grad if float(ref_grad[k].norm()) >= 1e-3 * median]
    grad_gaps = leaf_gaps(s_grad, ref_grad, moved)
    change_gaps = leaf_gaps(s_change, ref_change, moved)
    if leaves is not None:
        leaves.update(grad_worst=worst(grad_gaps), change_worst=worst(change_gaps))
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(s_losses, ref_losses)]
    return {"loss_gap": max(step_gaps), "change_gap": float(np.median(list(change_gaps.values()))),
            "grad_dir_gap": direction_gap(s_grad, ref_grad, moved),
            "grad_gap": float(np.median(list(grad_gaps.values()))), "grad_worst_leaf_gap": worst(grad_gaps)[1],
            "change_worst_leaf_gap": worst(change_gaps)[1], "step_loss_gaps": step_gaps}


def compare(ctx: harness.Context, facts: dict, initial: dict, program: tuple, batches_: list,
            recompute_rows: int = 0) -> list:
    """The checks of the program's first steps (losses, first clipped
    gradient, parameters after them) against the reference's on the same
    `batches_` (`recompute_rows`: `reference.train.loss`'s); with
    `ctx.calibrate` the control's and the faults' numbers go into `facts`."""
    device = harness.reference_device(ctx.device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ref = follow(ctx.config, initial, batches_, device, recompute_rows=recompute_rows)
    facts["reference_peak_bytes"] = harness.memory_peak(device)
    losses, first_grad, changed = program
    side = (losses, {n: g.to(device) for n, g in first_grad.items()},
            {n: changed[n].to(device) - initial[n].to(device) for n in changed})
    facts["worst_leaves"] = {}
    facts["program"] = got = numbers(side, ref, facts["worst_leaves"])
    if ctx.calibrate:
        fp8 = net.Rounding(torch.float8_e4m3fn)
        facts["control"] = numbers(follow(ctx.config, initial, batches_, device, fp8, False, recompute_rows), ref)
        facts["half_batch"] = numbers(follow(ctx.config, initial, batches_, device, net.FLOAT32, True, recompute_rows),
                                      ref)
        facts["unmoved"] = numbers((side[0], side[1], {k: torch.zeros_like(v) for k, v in side[2].items()}), ref)
        median = float(np.median([float(ref[1][k].norm()) for k in ref[1]]))
        facts["excluded_leaves"] = [k for k in ref[1] if float(ref[1][k].norm()) < 1e-3 * median]
        facts["control_checks"] = harness.checks(facts["control"], ctx, CHECKED)
    return harness.checks(got, ctx, CHECKED)
