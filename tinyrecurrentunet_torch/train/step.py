"""The train and eval steps, counterparts of `tinyrecurrentunet_tpu/train/step.py`.

`make_train_step(cfg, with_carry)` returns

    step(state, clean, noisy) -> (state, metrics)                      with_carry False
    step(state, clean, noisy, tgru_h0) -> (state, metrics, tgru_h)     with_carry True

clean/noisy are (B, L) waveforms on the model's device. One step: the
loss in training mode (BatchNorm on batch statistics, updating the running
ones), backward, the global gradient norm taken before clipping, clipping,
then the AdamW update at schedule(state.step). The TBPTT variant threads the
TGRU carry through and returns it detached, so gradients stop at segment
boundaries. Unlike the JAX step the model is not an argument: the state
holds it. metrics are 0-dim tensors on the device (the loss terms and
"grad_norm"), read by the caller only when it logs.
"""

from __future__ import annotations

import torch

from tinyrecurrentunet_torch.config import Config
from tinyrecurrentunet_torch.losses import loss_fn
from tinyrecurrentunet_torch.signal import Featurizer
from tinyrecurrentunet_torch.train.state import TrainState, make_schedule


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


def make_train_step(cfg: Config, with_carry: bool = False, featurizer=None):
    """`featurizer` makes the noisy input's features (default
    `Featurizer(cfg.featurizer)`)."""
    featurizer = featurizer or Featurizer(cfg.featurizer)
    loss_cfg = cfg.train.loss_config
    max_norm = cfg.train.optimization.grad_clip_norm
    schedule = make_schedule(cfg)

    def step(state: TrainState, clean, noisy, tgru_h0=None):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, loss_dict, tgru_h = loss_fn(
            model, clean, noisy, featurizer, cfg.network, loss_cfg, tgru_h0=tgru_h0
        )
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = global_norm(grads)
        clip_by_global_norm_(grads, max_norm, metrics["grad_norm"])
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.step += 1
        if with_carry:
            return state, metrics, tgru_h.detach()
        return state, metrics

    return step


def make_eval_step(cfg: Config):
    """(state, clean, noisy) -> loss_dict, with the model in eval mode (BatchNorm
    on its running statistics, nothing updated)."""
    featurizer = Featurizer(cfg.featurizer)
    loss_cfg = cfg.train.loss_config

    @torch.no_grad()
    def step(state: TrainState, clean, noisy):
        state.model.eval()
        _, loss_dict, _ = loss_fn(state.model, clean, noisy, featurizer, cfg.network, loss_cfg)
        return loss_dict

    return step


def current_learning_rate(cfg: Config, step_count: int) -> float:
    """The rate of update `step_count`, for the log."""
    return make_schedule(cfg)(step_count)
