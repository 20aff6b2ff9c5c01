"""TRU-Net building blocks, counterparts of
`tinyrecurrentunet_tpu/models/blocks.py`.

Activations are (N, L, C), channels last, as in the JAX package. Submodule
and parameter names follow the flax tree (`Dense_0`, `BatchNorm_1`,
`GRU_0`, `wi_fwd`, ...), so `weights.state_dict_from_variables` is a
straight mapping. Parameters start at zero (BatchNorm at identity): load a
state_dict, or draw flax's initial distributions with `init_parameters`.

BatchNorm follows flax (eps 1e-5, momentum 0.99), in flax's order
(x - mean) * (rsqrt(var + eps) * scale) + bias. In eval mode it reads the
running statistics. In training mode (`Module.train()`) it normalises by the
batch mean and the biased batch variance E[x^2] - E[x]^2, clipped at 0, and
updates the running statistics as ra = 0.99 ra + 0.01 batch.

The GRU projects its inputs with one matmul and hands the recurrence to
`ops.cuda_gru`: where a gradient is wanted (grad enabled and an input or
weight of the recurrence requires one), in either mode, the autograd
Function `GRURecurrence` (kernels `gru_fwd_train` and the BPTT); otherwise,
as under `torch.inference_mode()` or `no_grad`, `gru_recurrence` (kernel
`gru_fwd`). Tensors on the CPU run the plain PyTorch versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinyrecurrentunet_torch.ops import conv as conv_ops
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.ops.gru import gru_project_inputs


def _zeros(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


def _draw_(param: torch.Tensor, generator: torch.Generator, fan_in: int = 0, bound: float = 0.0):
    """Fill `param` with a draw made on the CPU from `generator`: flax's
    lecun_normal (truncated normal in +-2 std, variance 1/fan_in after the
    truncation) for `fan_in`, else U(-bound, bound). Drawing on the CPU makes
    the weights of a seed the same on every device."""
    values = torch.empty(param.shape, dtype=torch.float32)
    if fan_in:
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(values, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    else:
        nn.init.uniform_(values, -bound, bound, generator=generator)
    param.copy_(values)


class Dense(nn.Module):
    """flax Dense: x @ W.T + b with W in torch's (out, in) layout."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = _zeros(out_features, in_features, device=device)
        self.bias = _zeros(out_features, device=device)

    def init_params(self, generator: torch.Generator):
        _draw_(self.weight, generator, fan_in=self.weight.shape[1])
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """flax BatchNorm over the last (channel) axis; see the module docstring."""

    MOMENTUM = 0.99  # flax's default, which every BatchNorm of the JAX package uses

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = _zeros(features, device=device)
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def init_params(self, generator: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class Conv(nn.Module):
    """Parameters of a flax Conv, in torch's conv1d layout (Cout, Cin, k)."""

    def __init__(self, in_features: int, out_features: int, kernel: int, device=None):
        super().__init__()
        self.weight = _zeros(out_features, in_features, kernel, device=device)
        self.bias = _zeros(out_features, device=device)

    def init_params(self, generator: torch.Generator):
        _draw_(self.weight, generator, fan_in=self.weight.shape[1] * self.weight.shape[2])
        self.bias.zero_()


class StandardConv1d(nn.Module):
    """Conv1d(k, s, pad=s//2) + ReLU."""

    def __init__(self, in_features, features, kernel, stride, device=None):
        super().__init__()
        self.stride = stride
        self.Conv_0 = Conv(in_features, features, kernel, device=device)

    def forward(self, x):
        c = self.Conv_0
        return torch.relu(conv_ops.conv1d(x, c.weight, c.bias, self.stride, self.stride // 2))


class DepthwiseSeparableConv1d(nn.Module):
    """pointwise 1x1 -> BN -> ReLU -> depthwise(k, s, pad=k//2) -> BN -> ReLU."""

    def __init__(self, in_features, features, kernel, stride, device=None):
        super().__init__()
        self.stride = stride
        self.Dense_0 = Dense(in_features, features, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.depthwise_weight = _zeros(features, 1, kernel, device=device)
        self.depthwise_bias = _zeros(features, device=device)
        self.BatchNorm_1 = BatchNorm(features, device=device)

    def init_params(self, generator: torch.Generator):
        _draw_(self.depthwise_weight, generator, fan_in=self.depthwise_weight.shape[-1])
        self.depthwise_bias.zero_()

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Dense_0(x)))
        k = self.depthwise_weight.shape[-1]
        x = conv_ops.conv1d(
            x, self.depthwise_weight, self.depthwise_bias, self.stride, k // 2,
            groups=x.shape[-1],
        )
        return torch.relu(self.BatchNorm_1(x))


class GRU(nn.Module):
    """Single-layer, optionally bidirectional GRU with the JAX parameter
    layout: wi (D, 3H), wh (H, 3H), bi and bh (3H,) per direction.

    Returns (outputs (B, L, H * directions), final h of the forward
    direction (B, H)).
    """

    def __init__(self, in_features: int, hidden: int, bidirectional: bool = False, device=None):
        super().__init__()
        self.hidden = hidden
        self.bidirectional = bidirectional
        for d in ("fwd", "bwd") if bidirectional else ("fwd",):
            self.register_parameter(f"wi_{d}", _zeros(in_features, 3 * hidden, device=device))
            self.register_parameter(f"wh_{d}", _zeros(hidden, 3 * hidden, device=device))
            self.register_parameter(f"bi_{d}", _zeros(3 * hidden, device=device))
            self.register_parameter(f"bh_{d}", _zeros(3 * hidden, device=device))

    def init_params(self, generator: torch.Generator):
        """torch.nn.GRU's U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias."""
        for param in self.parameters(recurse=False):
            _draw_(param, generator, bound=1.0 / self.hidden**0.5)

    def _direction(self, x, h0, d: str, reverse: bool):
        x_proj = gru_project_inputs(x, getattr(self, f"wi_{d}"), getattr(self, f"bi_{d}"))
        args = (x_proj.contiguous(), h0, getattr(self, f"wh_{d}"), getattr(self, f"bh_{d}"))
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return cuda_gru.GRURecurrence.apply(*args, reverse)
        return cuda_gru.gru_recurrence(*args, reverse=reverse)

    def forward(self, x, h0=None):
        zeros = x.new_zeros((x.shape[0], self.hidden))
        h0 = zeros if h0 is None else h0.contiguous()
        out_f, h_f = self._direction(x, h0, "fwd", reverse=False)
        if not self.bidirectional:
            return out_f, h_f
        out_b, _ = self._direction(x, zeros, "bwd", reverse=True)
        return torch.cat([out_f, out_b], dim=-1), h_f


class GRUBlock(nn.Module):
    """GRU -> 1x1 projection -> BN -> ReLU."""

    def __init__(self, in_features, hidden, out_features, bidirectional=False, device=None):
        super().__init__()
        dirs = 2 if bidirectional else 1
        self.GRU_0 = GRU(in_features, hidden, bidirectional, device=device)
        self.Dense_0 = Dense(dirs * hidden, out_features, device=device)
        self.BatchNorm_0 = BatchNorm(out_features, device=device)

    def forward(self, x, h0=None):
        out, h_final = self.GRU_0(x, h0)
        return torch.relu(self.BatchNorm_0(self.Dense_0(out))), h_final


class TrCNNBlock(nn.Module):
    """1x1 -> BN -> ReLU -> ConvTranspose(k, s, p=s//2) [-> BN -> ReLU].

    `tr_weight` is in torch's conv_transpose1d layout (Cin, Cout, k) with the
    taps already flipped from the JAX kernel (ops/conv.py).
    """

    def __init__(self, in_features, features, kernel, stride, final_norm=True, device=None):
        super().__init__()
        self.stride = stride
        self.Dense_0 = Dense(in_features, features, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.tr_weight = _zeros(features, features, kernel, device=device)
        self.tr_bias = _zeros(features, device=device)
        self.BatchNorm_1 = BatchNorm(features, device=device) if final_norm else None

    def init_params(self, generator: torch.Generator):
        w = self.tr_weight
        _draw_(w, generator, fan_in=w.shape[0] * w.shape[2])
        self.tr_bias.zero_()

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Dense_0(x)))
        x = conv_ops.conv_transpose1d(x, self.tr_weight, self.tr_bias, self.stride, self.stride // 2)
        if self.BatchNorm_1 is not None:
            x = torch.relu(self.BatchNorm_1(x))
        return x


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `model` from flax's initial distributions, in
    the order of `model.modules()`: lecun_normal for Dense, Conv, depthwise
    and transposed-conv kernels, zeros for their biases, BatchNorm at
    identity (scale 1, bias 0, running mean 0 and variance 1), torch.nn.GRU's
    uniform for the GRUs. The same generator state gives the same weights on
    any device; the numbers differ from flax's, whose generator differs."""
    for module in model.modules():
        if hasattr(module, "init_params"):
            module.init_params(generator)
    return model
