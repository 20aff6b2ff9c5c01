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
  step does (`set_learning_rate`).

On a card AdamW is `capturable`, so that a CUDA graph of the train step can
replay its update: its step counts live on the card, its bias corrections
are taken there in float32 (as optax takes them), and its rate is a 0-dim
float32 tensor on the card that `set_learning_rate` writes in place before
each update. On the CPU, whose parameters `capturable` refuses, the rate is
a float and the step counts and bias corrections stay on the host. Both
compute the same update in exact arithmetic, and a checkpoint written by
either restores into the other (`load_optimizer_state`).

Initial weights are flax's distributions drawn from a `torch.Generator`
seeded with `optimization.seed` (`models.blocks.init_parameters`).

The training model computes in `optimization.train_compute_dtype` where the
config sets it ("bfloat16" in every shipped training config), else in
`network.compute_dtype`: the train-only override of
`tinyrecurrentunet_tpu/train/loop.py`. Its parameters and the optimizer's
state stay float32, so checkpoints and `pretrained.npz` are float32 and a
Denoiser built from `network` serves them in its own dtype.
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


def train_network_config(cfg: Config):
    """`cfg.network` with the train-only compute dtype applied."""
    dtype = cfg.train.optimization.train_compute_dtype
    return dataclasses.replace(cfg.network, compute_dtype=dtype) if dtype else cfg.network


def make_schedule(cfg: Config):
    opt = cfg.train.optimization
    return linear_warmup_cosine_decay(
        opt.learning_rate, opt.n_iters, divider=opt.lr_divider, warmup_proportion=opt.warmup_proportion
    )


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW over the model's parameters, `capturable` where they lie on a card."""
    device = next(model.parameters()).device
    lr = make_schedule(cfg)(0)
    hyper = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.train.optimization.weight_decay)
    if device.type == "cuda":
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
        return torch.optim.AdamW(model.parameters(), lr=lr, capturable=True, foreach=True, **hyper)
    return torch.optim.AdamW(model.parameters(), lr=lr, **hyper)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """The rate of the next update: written into a card optimizer's rate
    tensor (a CUDA graph holds its address), assigned on the CPU."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict):
    """`optimizer.load_state_dict` from a checkpoint of either form (the
    card's capturable one or the CPU's), keeping the optimizer's own form:
    its groups' rate holder and flags, and its step counts on the card as
    float32 when it is capturable, on the host otherwise."""
    own = [{k: group[k] for k in ("lr", "capturable", "foreach")} for group in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, kept in zip(optimizer.param_groups, own):
        group.update(kept)
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                device = p.device if kept["capturable"] else "cpu"
                state["step"] = state["step"].to(dtype=torch.float32, device=device)


def create_train_state(cfg: Config, device="cuda") -> TrainState:
    """The training model (`train_network_config`) on `device` with initial
    weights from `optimization.seed`, and its optimizer. On a card it turns
    TF32 off for matmuls and cuDNN, which PyTorch enables for convolutions
    by default."""
    if torch.device(device).type == "cuda":
        # float32 matmuls and cuDNN convolutions stay out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = TRUNet(train_network_config(cfg), device=device)
    init_parameters(model, torch.Generator().manual_seed(cfg.train.optimization.seed))
    return TrainState(model, make_optimizer(cfg, model))
