"""The train and eval steps, counterparts of `tinyrecurrentunet_tpu/train/step.py`.

`make_train_step(cfg, with_carry)` returns

    step(state, clean, noisy) -> (state, metrics)                      with_carry False
    step(state, clean, noisy, tgru_h0) -> (state, metrics, tgru_h)     with_carry True

clean/noisy are (B, L) waveforms. One step: the loss in training mode
(BatchNorm on batch statistics, updating the running ones), backward, the
global gradient norm taken before clipping, clipping, then the AdamW update
at schedule(state.step). The TBPTT variant threads the TGRU carry through
and returns it detached, so gradients stop at segment boundaries. Unlike the
JAX step the model is not an argument: the state holds it. metrics are 0-dim
tensors on the model's device (the loss terms and "grad_norm"), read by the
caller only when it logs.

The step runs as the JAX package's jitted, donated step runs
(`jax.jit(fn, donate_argnums=(0,))`; with the carry `donate_argnums=(0, 3)`),
one program a batch shape over the train state in place. A call works on a
slot, one a (state, batch shape, dtype): static `clean` and `noisy` buffers,
with the carry a static TGRU carry, and on a card the CUDA graph of the
whole step (featurize, forward, loss, backward, global norm, clip, AdamW)
and its static metrics. The batch is copied into the slot's buffers (a
batch already in them, as the loop's device corpus gathers it, is not); the
learning rate is written into the optimizer's rate tensor
(`train.state.set_learning_rate`); the graph is replayed; `state.step` is
counted on the host. The metrics are returned as copies of the static ones.
Each call is a `trunet.train.step` of the port's recorder
(`utils/profiling.py`), with its `copy_in` (the slot's address check
included), `replay` and `metrics` spans (a slot's first call on a card also
`trunet.graph.capture`).

- A slot's first call on a card snapshots the state (the model's parameters
  and buffers, the optimizer's state, "none yet" included, and the carry),
  warms the step up 3 times on a side stream (the kernels' build, cuFFT's
  plans, cuDNN's choices, AdamW's state), restores the state in place
  (optimizer state the warm-up made goes back to AdamW's zeros and step 0),
  empties the allocator's cache so the warm-up's blocks do not sit beside
  the graph's pool, captures one step (`utils.graphs.capture`) into a pool
  all of the step's slots share, and replays it: the call is one step from
  the state it was given. It counts 3 x (3 + 1) launches of each training
  kernel, a replayed call 3.
- The gradients are tensors of the model that every slot writes: they are
  made (zeros) before a step that finds none, the step zeroes them in place
  and backward accumulates into them, inside the graph as outside it.
- The carry is donated: the step ends by writing h_T into the slot's carry
  buffer and returns that buffer; passed back, it is read where it lies; any
  other carry is copied in.
- A slot never replays over stale addresses: it records the address of
  every parameter, gradient, model buffer, optimizer state tensor and rate
  tensor at its first call, and a call that finds one moved (an optimizer
  whose state was loaded again, gradients set to None) drops the slot and
  builds it anew.
- `step(..., replay=False)` runs the step's body uncaptured on the slot
  (the card tests and chip_smoke.py hold and time the graph against it). On
  the CPU every call runs the body on the slot. A capture or a replay that
  fails raises: nothing falls back to the body. `step.replayed` says which
  of the two the last call ran.
- `step.close()` drops the slots, their graphs, static buffers and the pool
  handle, so that no graph holding collectives outlives the process group
  (`train.loop.train` closes its steps before it destroys the group); a
  closed step raises when it is called or asked for a slot.
- Under data parallelism (an initialized process group, a group of one rank
  included, `parallel/mesh.py`) the step uses its slots alike, each rank
  copying its shard of the global batch into the slot's static inputs, and
  is the global batch's step, as the JAX step over a mesh: the loss and its
  terms are the global batch's on every rank, the gradients are summed
  across ranks, then the global norm, the clip and AdamW run on every rank
  alike, so the replicas stay bit-equal. Over NCCL on a card the graph
  holds the whole rank step with its collectives (BatchNorm's and the
  loss's all-reduces, the sum-backward all-reduces, `sum_gradients_`);
  every rank captures at the same call, after warm-ups that also make the
  communicator, so the collectives stay matched. Over gloo, whose
  collectives pass through the host, every call runs the body on the slot:
  a choice made by the backend (`parallel.capturable_collectives`), not by
  a failure.

`make_eval_step(cfg)` returns the counterpart of the JAX package's jitted
eval step, `EvalStep`: (state, clean, noisy) -> loss_dict with the model in
eval mode (BatchNorm on its running statistics, nothing updated, no
gradient), one program a validation batch shape. Its slots, one a (model,
batch shape, dtype), hold static `clean` and `noisy` and on a card the CUDA
graph of the whole eval call (featurize, TRUNet with its three `gru_fwd`,
PHM, iSTFT, the loss terms) in the eval step's own memory pool, captured at
the slot's first call after 3 warm-ups and replayed after. The graph reads
the parameters and the running statistics where they lie, so a replay after
train steps sees their latest values; a slot records their addresses and is
built anew where one has moved. It returns copies of its static metrics;
`replay=False` runs the body on the slot; on the CPU every call does.
`close()` drops its slots as the train step's does.
"""

from __future__ import annotations

import dataclasses

import torch

from tinyrecurrentunet_torch import parallel
from tinyrecurrentunet_torch.config import Config
from tinyrecurrentunet_torch.losses import loss_fn
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.train.state import TrainState, make_schedule, set_learning_rate
from tinyrecurrentunet_torch.utils import graphs, profiling


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(tensors, max_norm: float, norm: torch.Tensor):
    """optax.clip_by_global_norm in place: t / norm * max_norm where
    norm >= max_norm, untouched otherwise (no epsilon)."""
    keep = norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, t / norm * max_norm))


@dataclasses.dataclass
class _Slot:
    """One (state, batch shape, dtype): the static inputs, on a card the
    graph, the kernels' launches a replay runs (`cuda_gru.capture_tally`)
    and the graph's static metrics; the addresses the slot was built on."""

    model: torch.nn.Module  # held, so that the key's ids stay theirs
    optimizer: torch.optim.Optimizer
    clean: torch.Tensor
    noisy: torch.Tensor
    carry: torch.Tensor | None
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict | None = None
    metrics: dict | None = None
    addresses: tuple | None = None
    memory: dict | None = None  # the card's reserved bytes around the capture


def _ensure_grads(model: torch.nn.Module):
    """Zero gradients for the parameters that have none."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _optimizer_tensors(optimizer: torch.optim.Optimizer):
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            yield group["lr"]
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            yield from (state[k] for k in sorted(state) if isinstance(state[k], torch.Tensor))


def _model_addresses(model: torch.nn.Module) -> tuple:
    """The address of every parameter and buffer of `model`: what a captured
    eval call reads."""
    return tuple(t.data_ptr() for t in (*model.parameters(), *model.buffers()))


def _addresses(state: TrainState) -> tuple:
    """The address of every tensor a captured step reads or writes in place."""
    tensors = (*(p.grad for p in state.model.parameters()), *_optimizer_tensors(state.optimizer))
    return _model_addresses(state.model) + tuple(t.data_ptr() for t in tensors)


def _snapshot(state: TrainState, slot: _Slot):
    """A restore() that puts the model's parameters and buffers, the
    optimizer's state and the slot's carry back as they are now; optimizer
    state made after the snapshot goes back to AdamW's initial zeros."""
    model, optimizer = state.model, state.optimizer
    tensors = [*model.parameters(), *model.buffers(), *([slot.carry] if slot.carry is not None else [])]
    saved = [t.detach().clone() for t in tensors]
    saved_opt = {p: {k: v.clone() for k, v in st.items()} for p, st in optimizer.state.items()}

    @torch.no_grad()
    def restore():
        for t, s in zip(tensors, saved):
            t.copy_(s)
        for p, st in optimizer.state.items():
            for k, v in st.items():
                if p in saved_opt:
                    v.copy_(saved_opt[p][k])
                else:
                    v.zero_()

    return restore


def _check_open(step):
    if step.closed:
        raise RuntimeError(f"{type(step).__name__} was closed: its graphs are freed")


def _close(step):
    step._slots.clear()
    step._pool = None
    step.closed = True


def _copy_in(pairs):
    """Each given tensor into its static buffer, unless it is that buffer."""
    for buf, given in pairs:
        if given is not None and given is not buf:
            if given.shape != buf.shape:
                raise ValueError(f"input of shape {tuple(given.shape)}, expected {tuple(buf.shape)}")
            buf.copy_(given)


class TrainStep:
    """The train step of `make_train_step`: a callable holding its slots."""

    def __init__(self, cfg: Config, with_carry: bool = False, featurizer=None):
        self.cfg = cfg
        self.with_carry = with_carry
        self.featurizer = featurizer or Featurizer(cfg.featurizer)
        self.schedule = make_schedule(cfg)
        self._slots: dict[tuple, _Slot] = {}
        self._pool = None  # the graph memory pool of all the slots, made at the first capture
        self.captures = 0
        self.replayed = None  # whether the last call replayed a graph (else it ran the body)
        self.closed = False

    def __call__(self, state: TrainState, clean, noisy, tgru_h0=None, replay: bool = True):
        if self.with_carry != (tgru_h0 is not None):
            raise TypeError("a TGRU carry is passed exactly when the step was made with_carry")
        with profiling.span("trunet.train.step"):
            _ensure_grads(state.model)
            with profiling.span("trunet.train.copy_in"):
                slot = self.buffers(state, tuple(clean.shape), clean.dtype)
                _copy_in(((slot.clean, clean), (slot.noisy, noisy), (slot.carry, tgru_h0)))
            set_learning_rate(state.optimizer, self.schedule(state.step))
            self.replayed = replay and slot.clean.device.type == "cuda" and parallel.capturable_collectives()
            if self.replayed:
                with torch.cuda.device(slot.clean.device):
                    if slot.graph is None:
                        self._capture(state, slot)
                    state.model.train()
                    with profiling.span("trunet.train.replay"):
                        slot.graph.replay()
                cuda_gru.add_launches(slot.launches)
                with profiling.span("trunet.train.metrics"):
                    metrics = {k: v.clone() for k, v in slot.metrics.items()}
            else:
                metrics = self._body(state, slot)
            if slot.addresses is None:
                slot.addresses = _addresses(state)
            state.step += 1
        return (state, metrics, slot.carry) if self.with_carry else (state, metrics)

    def buffers(self, state: TrainState, batch_shape: tuple, dtype=torch.float32) -> _Slot:
        """The slot of `state` and (B, L) batches of `dtype`: its static
        `clean`, `noisy` and (with the carry) `carry` buffers, on the model's
        device, made at its first use; built anew where a tensor it was
        built on has moved."""
        _check_open(self)
        model = state.model
        key = (id(model), id(state.optimizer), tuple(batch_shape), dtype)
        slot = self._slots.get(key)
        if slot is not None and slot.addresses is not None and slot.addresses != _addresses(state):
            slot = None
        if slot is None:
            device = next(model.parameters()).device
            carry = None
            if self.with_carry:
                carry = model.init_tgru_state(batch_shape[0], self.cfg.featurizer.num_freqs, device)
            slot = _Slot(model, state.optimizer, torch.zeros(batch_shape, dtype=dtype, device=device),
                         torch.zeros(batch_shape, dtype=dtype, device=device), carry)
            self._slots[key] = slot
        return slot

    def close(self):
        """Drop every slot: its graph, static buffers and metrics, and the
        pool handle. A later call raises."""
        _close(self)

    def _run(self, state: TrainState, clean, noisy, tgru_h0):
        """The step's arithmetic on the given tensors: (metrics, tgru_h)."""
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=False)
        loss, loss_dict, tgru_h = loss_fn(
            model, clean, noisy, self.featurizer, self.cfg.network, self.cfg.train.loss_config,
            tgru_h0=tgru_h0, across_ranks=parallel.is_distributed(),
        )
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        parallel.sum_gradients_(grads)
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = global_norm(grads)
        clip_by_global_norm_(grads, self.cfg.train.optimization.grad_clip_norm, metrics["grad_norm"])
        state.optimizer.step()
        return metrics, tgru_h

    def _body(self, state: TrainState, slot: _Slot) -> dict:
        """The step on the slot's buffers, h_T written into its carry."""
        metrics, tgru_h = self._run(state, slot.clean, slot.noisy, slot.carry)
        if slot.carry is not None:
            slot.carry.copy_(tgru_h.detach())
        return metrics

    def _capture(self, state: TrainState, slot: _Slot):
        """The slot's graph: 3 warm-up steps, the state restored in place,
        the allocator's cache emptied, one step captured."""
        restore_state = _snapshot(state, slot)

        def restore():
            restore_state()
            warm = torch.cuda.memory_reserved()
            torch.cuda.empty_cache()
            slot.memory = {"reserved_after_warmup": warm, "reserved_before_capture": torch.cuda.memory_reserved()}

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        slot.graph, slot.launches, slot.metrics = graphs.capture(
            lambda: self._body(state, slot), restore, self._pool)
        slot.memory["reserved_after_capture"] = torch.cuda.memory_reserved()
        self.captures += 1


def make_train_step(cfg: Config, with_carry: bool = False, featurizer=None) -> TrainStep:
    """`featurizer` makes the noisy input's features (default
    `Featurizer(cfg.featurizer)`)."""
    return TrainStep(cfg, with_carry, featurizer)


@dataclasses.dataclass
class _EvalSlot:
    """One (model, batch shape, dtype) of the eval step: the static inputs,
    on a card the graph, its launches and static metrics; the addresses of
    the parameters and buffers the slot was built on."""

    model: torch.nn.Module  # held, so that the key's id stays its
    clean: torch.Tensor
    noisy: torch.Tensor
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict | None = None
    metrics: dict | None = None
    addresses: tuple | None = None


class EvalStep:
    """The eval step of `make_eval_step`: a callable holding its slots."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.featurizer = Featurizer(cfg.featurizer)
        self._slots: dict[tuple, _EvalSlot] = {}
        self._pool = None  # the graph memory pool of all the slots, made at the first capture
        self.captures = 0
        self.closed = False

    def __call__(self, state: TrainState, clean, noisy, replay: bool = True) -> dict:
        slot = self.buffers(state, tuple(clean.shape), clean.dtype)
        _copy_in(((slot.clean, clean), (slot.noisy, noisy)))
        if replay and slot.clean.device.type == "cuda":
            with torch.cuda.device(slot.clean.device):
                if slot.graph is None:
                    self._capture(slot)
                state.model.eval()
                slot.graph.replay()
            cuda_gru.add_launches(slot.launches)
            metrics = {k: v.clone() for k, v in slot.metrics.items()}
        else:
            metrics = self._body(slot)
        if slot.addresses is None:
            slot.addresses = _model_addresses(state.model)
        return metrics

    def buffers(self, state: TrainState, batch_shape: tuple, dtype=torch.float32) -> _EvalSlot:
        """The slot of `state`'s model and (B, L) batches of `dtype`: its
        static `clean` and `noisy` on the model's device, made at its first
        use; built anew where a parameter or buffer has moved."""
        _check_open(self)
        model = state.model
        key = (id(model), tuple(batch_shape), dtype)
        slot = self._slots.get(key)
        if slot is not None and slot.addresses is not None and slot.addresses != _model_addresses(model):
            slot = None
        if slot is None:
            device = next(model.parameters()).device
            slot = _EvalSlot(model, torch.zeros(batch_shape, dtype=dtype, device=device),
                             torch.zeros(batch_shape, dtype=dtype, device=device))
            self._slots[key] = slot
        return slot

    def close(self):
        """Drop every slot and the pool handle, as TrainStep.close."""
        _close(self)

    @torch.no_grad()
    def _body(self, slot: _EvalSlot) -> dict:
        """The eval call on the slot's inputs."""
        slot.model.eval()
        _, loss_dict, _ = loss_fn(slot.model, slot.clean, slot.noisy, self.featurizer, self.cfg.network,
                                  self.cfg.train.loss_config)
        return loss_dict

    def _capture(self, slot: _EvalSlot):
        """The slot's graph: 3 warm-up calls (they update nothing), one
        captured, in the eval step's pool."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        slot.graph, slot.launches, slot.metrics = graphs.capture(lambda: self._body(slot), pool=self._pool)
        self.captures += 1


def make_eval_step(cfg: Config) -> EvalStep:
    """(state, clean, noisy) -> loss_dict, with the model in eval mode
    (BatchNorm on its running statistics, nothing updated): `EvalStep`."""
    return EvalStep(cfg)


def current_learning_rate(cfg: Config, step_count: int) -> float:
    """The rate of update `step_count`, for the log."""
    return make_schedule(cfg)(step_count)
