"""TRU-Net building blocks (inference), counterparts of
`tinyrecurrentunet_tpu/models/blocks.py`.

Activations are (N, L, C), channels last, as in the JAX package. Submodule
and parameter names follow the flax tree (`Dense_0`, `BatchNorm_1`,
`GRU_0`, `wi_fwd`, ...), so `weights.state_dict_from_variables` is a
straight mapping. Parameters start at zero (BatchNorm at identity); load a
state_dict to use a model.

BatchNorm runs in eval mode from the running statistics, eps 1e-5, in
flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias.

The GRU projects its inputs with one matmul and hands the recurrence to
`ops.cuda_gru.gru_recurrence`: the CUDA kernel for tensors on the card, the
plain PyTorch version for tensors on the CPU.
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


class Dense(nn.Module):
    """flax Dense: x @ W.T + b with W in torch's (out, in) layout."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = _zeros(out_features, in_features, device=device)
        self.bias = _zeros(out_features, device=device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last (channel) axis."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = _zeros(features, device=device)
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class Conv(nn.Module):
    """Parameters of a flax Conv, in torch's conv1d layout (Cout, Cin, k)."""

    def __init__(self, in_features: int, out_features: int, kernel: int, device=None):
        super().__init__()
        self.weight = _zeros(out_features, in_features, kernel, device=device)
        self.bias = _zeros(out_features, device=device)


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

    def _direction(self, x, h0, d: str, reverse: bool):
        x_proj = gru_project_inputs(x, getattr(self, f"wi_{d}"), getattr(self, f"bi_{d}"))
        return cuda_gru.gru_recurrence(
            x_proj.contiguous(), h0, getattr(self, f"wh_{d}"), getattr(self, f"bh_{d}"),
            reverse=reverse,
        )

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

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Dense_0(x)))
        x = conv_ops.conv_transpose1d(x, self.tr_weight, self.tr_bias, self.stride, self.stride // 2)
        if self.BatchNorm_1 is not None:
            x = torch.relu(self.BatchNorm_1(x))
        return x
