"""Train state: the model, its optimizer and the count of updates.

Counterpart of `tinyrecurrentunet_tpu/train/state.py`. The optimizer is
optax's chain(clip_by_global_norm(grad_clip_norm), adamw(schedule,
weight_decay)):

- clipping as optax does it: scale by max_norm / norm only when
  norm >= max_norm (`clip_by_global_norm_`, called by the train step);
- AdamW, b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
  parameter (optax has no mask here; the BatchNorm running statistics are
  buffers, not parameters). `torch.optim.AdamW` computes optax's update when
  its rate is set to schedule(k) before update k (0-based), as the train
  step does.

Initial weights are flax's distributions drawn from a `torch.Generator`
seeded with `optimization.seed` (`models.blocks.init_parameters`).
"""

from __future__ import annotations

import dataclasses

import torch

from tinyrecurrentunet_torch.config import Config
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.models.blocks import init_parameters
from tinyrecurrentunet_torch.train.schedule import linear_warmup_cosine_decay


@dataclasses.dataclass
class TrainState:
    model: TRUNet
    optimizer: torch.optim.Optimizer
    step: int = 0  # updates applied, optax's count


def check_train_dtype(cfg: Config):
    """The port trains in float32; bf16 training is a later slice."""
    dtype = cfg.train.optimization.train_compute_dtype
    if dtype not in ("", "float32"):
        raise NotImplementedError(
            f"train_compute_dtype {dtype!r}: the port trains in float32; bf16 training is "
            "a later slice of the port (ROADMAP). Clear train.optimization.train_compute_dtype."
        )


def make_schedule(cfg: Config):
    opt = cfg.train.optimization
    return linear_warmup_cosine_decay(
        opt.learning_rate, opt.n_iters, divider=opt.lr_divider, warmup_proportion=opt.warmup_proportion
    )


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.AdamW:
    return torch.optim.AdamW(
        model.parameters(),
        lr=make_schedule(cfg)(0),
        betas=(0.9, 0.999),
        eps=1e-8,
        weight_decay=cfg.train.optimization.weight_decay,
    )


def create_train_state(cfg: Config, device="cuda") -> TrainState:
    """A model on `device` with initial weights from `optimization.seed`, and
    its optimizer. On a card it turns TF32 off for matmuls and cuDNN, which
    PyTorch enables for convolutions by default."""
    check_train_dtype(cfg)
    if torch.device(device).type == "cuda":
        # the port trains in float32: keep matmuls and cuDNN convolutions out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = TRUNet(cfg.network, device=device)
    init_parameters(model, torch.Generator().manual_seed(cfg.train.optimization.seed))
    return TrainState(model, make_optimizer(cfg, model))
