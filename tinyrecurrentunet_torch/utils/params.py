"""Parameter accounting and the weight-rescaling initialization, counterparts
of `tinyrecurrentunet_tpu/utils/params.py`.

The JAX package counts and rescales a flax params tree; the port works on
the model (`count_params`, `print_size`) and on its `state_dict`
(`weight_scaling_init`), whose names map onto the flax tree
(`weights.py`): a 2-D or 3-D `weight` is a Dense or Conv `kernel` (a 1-D one
is a BatchNorm `scale`), `depthwise_weight` and `tr_weight` are
`depthwise_kernel` and `tr_kernel`, and the GRU keeps `wi_fwd`. The small
helpers `rescale`, `flatten` and `std_normal` mirror the JAX package's.
"""

from __future__ import annotations

import torch
from torch import nn

# state_dict leaf of a kernel -> leaf of its bias (None: a kernel without one)
_KERNEL_BIAS = {"weight": "bias", "depthwise_weight": "depthwise_bias", "tr_weight": "tr_bias", "wi_fwd": None}


def rescale(x) -> torch.Tensor:
    """Min-max rescale to [0, 1] (reference `util.py:26-27`)."""
    x = torch.as_tensor(x)
    return (x - x.min()) / (x.max() - x.min())


def flatten(v) -> list:
    """Flatten one nesting level (reference `util.py:22-23`)."""
    return [x for y in v for x in y]


def std_normal(generator: torch.Generator, size, device=None) -> torch.Tensor:
    """Standard-normal float32 sample of shape `size` (reference
    `util.py:160-164`), drawn from `generator` instead of CUDA's global
    state; the JAX package takes a PRNG key, so the numbers differ."""
    return torch.randn(size, generator=generator, device=device)


def count_params(model: nn.Module) -> int:
    """Entries of the model's parameters (BatchNorm's running statistics are
    buffers, as they are flax's `batch_stats`, and are not counted)."""
    return sum(p.numel() for p in model.parameters())


def print_size(model: nn.Module, name: str = "TRUNet", keyword: str | None = None) -> int:
    """Print the parameter count in millions (and that of the parameters
    whose name contains `keyword`); returns the count."""
    n = count_params(model)
    print(f"{name} Parameters: {n / 1e6:.6f}M", flush=True, end="; ")
    if keyword is not None:
        kn = sum(p.numel() for path, p in model.named_parameters() if keyword in path)
        print(f"{keyword} Parameters: {kn / 1e6:.6f}M", flush=True, end="; ")
    print(" ")
    return n


@torch.no_grad()
def weight_scaling_init(state_dict: dict, alpha_mul: float = 10.0) -> dict:
    """A copy of `state_dict` with every kernel (and its bias, where it has
    one) divided by sqrt(max(alpha_mul * std(kernel), 1e-8)), std the biased
    estimator as `jnp.std` takes it. The kernels are the JAX package's:
    Dense, Conv, depthwise and transposed-conv kernels and the forward
    GRU's input weights `wi_fwd`."""
    out = dict(state_dict)
    for key, w in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf not in _KERNEL_BIAS or (leaf == "weight" and w.dim() < 2):
            continue
        alpha = alpha_mul * torch.std(w, correction=0)
        scale = torch.sqrt(torch.clamp(alpha, min=1e-8))
        out[key] = w / scale
        bias_key = f"{prefix}.{_KERNEL_BIAS[leaf]}" if _KERNEL_BIAS[leaf] else None
        if bias_key in state_dict:
            out[bias_key] = state_dict[bias_key] / scale
    return out
