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
updates the running statistics as ra = 0.99 ra + 0.01 batch. It takes Σx,
Σx² and the count, and divides once on that (2C+1,) vector, so that the
gradient of the statistics reaches x as an expanded view and no full-size
tensor is divided. Under data parallelism (an initialized process group, of
any size, `parallel/mesh.py`) the ranks all-reduce the vector first, so the
batch is the global one, as flax's BatchNorm reduces over a batch sharded
across a mesh; alone, the all-reduce is the identity. The count is filled on
the device, so that no host-to-device copy stands in a captured step.

`dtype` (None or torch.bfloat16) is flax's compute dtype. Parameters and
running statistics stay float32 whatever it is, and are cast at use. None
computes in the parameters' dtype (float32, or float64 after
`model.double()`). bfloat16 computes as the JAX package's modules do at
`dtype=jnp.bfloat16`: Dense, Conv and ConvTranspose cast inputs, kernel and
bias to bf16 and add the bias to the rounded product; BatchNorm takes its
statistics and its affine in float32 from the bf16 input (flax's
`force_float32_reductions`) and rounds the result to bf16; the GRU keeps the
Pallas kernels' edges (`ops.gru.gru_layer`).

The GRU projects its inputs with one matmul and hands the recurrence to
the implementation that `use_pallas_gru` (`network.use_pallas_gru`) names:

- "auto" (the default) and "always": `ops.cuda_gru`. Where a gradient is
  wanted (grad enabled and an input or weight of the recurrence requires
  one), in either mode, the autograd Function `GRURecurrence` (kernels
  `gru_fwd_train` and the BPTT); otherwise, as under
  `torch.inference_mode()` or `no_grad`, `gru_recurrence` (kernel
  `gru_fwd`). Tensors on the CPU run the plain PyTorch versions; CUDA
  tensors launch the kernels or raise. Unlike the JAX package, whose "auto"
  takes its Pallas kernels only at the shapes its TPU policy
  (`pallas_gru_shape_ok`) picks, "auto" here takes the kernels at every
  shape, so the two values are one.
- "never": the plain PyTorch versions of `ops/gru.py` on any device
  (`PlainGRURecurrence` where a gradient is wanted), which launch none of
  the port's kernels. The caller asks for it; nothing falls back to it.

Any other value raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinyrecurrentunet_torch import parallel
from tinyrecurrentunet_torch.ops import conv as conv_ops
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.ops import gru as gru_ops
from tinyrecurrentunet_torch.ops.gru import gru_layer

GRU_IMPLEMENTATIONS = ("auto", "always", "never")  # values of network.use_pallas_gru


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


def _affine(op, x, weight, bias, dtype, **kwargs):
    """op(x, weight, bias) in the parameters' dtype (dtype None), or as flax
    computes it at a lower dtype: inputs, kernel and bias cast to it, the
    product rounded to it, then the bias added."""
    if dtype is None:
        return op(x, weight, bias, **kwargs)
    return op(x.to(dtype), weight.to(dtype), None, **kwargs) + bias.to(dtype)


class Dense(nn.Module):
    """flax Dense: x @ W.T + b with W in torch's (out, in) layout."""

    def __init__(self, in_features: int, out_features: int, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _zeros(out_features, in_features, device=device)
        self.bias = _zeros(out_features, device=device)

    def init_params(self, generator: torch.Generator):
        _draw_(self.weight, generator, fan_in=self.weight.shape[1])
        self.bias.zero_()

    def forward(self, x):
        return _affine(F.linear, x, self.weight, self.bias, self.dtype)


class BatchNorm(nn.Module):
    """flax BatchNorm over the last (channel) axis; see the module docstring."""

    MOMENTUM = 0.99  # flax's default, which every BatchNorm of the JAX package uses

    def __init__(self, features: int, eps: float = 1e-5, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
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
        if self.dtype is not None:
            x = x.float()  # statistics and affine in float32
        if self.training:
            dims = tuple(range(x.dim() - 1))
            count = torch.full((1,), x.numel() // x.shape[-1], dtype=x.dtype, device=x.device)
            sums = parallel.all_reduce_sum(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), count]))
            mean, mean_sq = (sums[:-1] / sums[-1]).chunk(2)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean) * mul + self.bias
        return y if self.dtype is None else y.to(self.dtype)


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

    def __init__(self, in_features, features, kernel, stride, dtype=None, device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.Conv_0 = Conv(in_features, features, kernel, device=device)

    def forward(self, x):
        c = self.Conv_0
        return torch.relu(_affine(conv_ops.conv1d, x, c.weight, c.bias, self.dtype,
                                  stride=self.stride, padding=self.stride // 2))


class DepthwiseSeparableConv1d(nn.Module):
    """pointwise 1x1 -> BN -> ReLU -> depthwise(k, s, pad=k//2) -> BN -> ReLU."""

    def __init__(self, in_features, features, kernel, stride, dtype=None, device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.Dense_0 = Dense(in_features, features, dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype, device=device)
        self.depthwise_weight = _zeros(features, 1, kernel, device=device)
        self.depthwise_bias = _zeros(features, device=device)
        self.BatchNorm_1 = BatchNorm(features, dtype=dtype, device=device)

    def init_params(self, generator: torch.Generator):
        _draw_(self.depthwise_weight, generator, fan_in=self.depthwise_weight.shape[-1])
        self.depthwise_bias.zero_()

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Dense_0(x)))
        k = self.depthwise_weight.shape[-1]
        x = _affine(conv_ops.conv1d, x, self.depthwise_weight, self.depthwise_bias, self.dtype,
                    stride=self.stride, padding=k // 2, groups=x.shape[-1])
        return torch.relu(self.BatchNorm_1(x))


class GRU(nn.Module):
    """Single-layer, optionally bidirectional GRU with the JAX parameter
    layout: wi (D, 3H), wh (H, 3H), bi and bh (3H,) per direction.

    Returns (outputs (B, L, H * directions), final h of the forward
    direction (B, H)).
    """

    def __init__(self, in_features: int, hidden: int, bidirectional: bool = False, dtype=None,
                 use_pallas_gru: str = "auto", device=None):
        super().__init__()
        if use_pallas_gru not in GRU_IMPLEMENTATIONS:
            raise ValueError(f"use_pallas_gru {use_pallas_gru!r}: one of {GRU_IMPLEMENTATIONS}")
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.dtype = dtype
        self.use_pallas_gru = use_pallas_gru
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
        params = [getattr(self, f"{name}_{d}") for name in ("wi", "wh", "bi", "bh")]
        if self.dtype is not None:
            x, params = x.to(self.dtype), [p.to(self.dtype) for p in params]
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, h0, *params))
        if self.use_pallas_gru == "never":
            recurrence = gru_ops.PlainGRURecurrence.apply if grad else gru_ops.gru_recurrence
        else:
            recurrence = cuda_gru.GRURecurrence.apply if grad else cuda_gru.gru_recurrence
        return gru_layer(x, h0, *params, recurrence, reverse)

    def forward(self, x, h0=None):
        zeros = x.new_zeros((x.shape[0], self.hidden), dtype=self.dtype or x.dtype)
        h0 = zeros if h0 is None else h0.contiguous()
        out_f, h_f = self._direction(x, h0, "fwd", reverse=False)
        if not self.bidirectional:
            return out_f, h_f
        out_b, _ = self._direction(x, zeros, "bwd", reverse=True)
        return torch.cat([out_f, out_b], dim=-1), h_f


class GRUBlock(nn.Module):
    """GRU -> 1x1 projection -> BN -> ReLU."""

    def __init__(self, in_features, hidden, out_features, bidirectional=False, dtype=None,
                 use_pallas_gru: str = "auto", device=None):
        super().__init__()
        dirs = 2 if bidirectional else 1
        self.GRU_0 = GRU(in_features, hidden, bidirectional, dtype=dtype, use_pallas_gru=use_pallas_gru,
                         device=device)
        self.Dense_0 = Dense(dirs * hidden, out_features, dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(out_features, dtype=dtype, device=device)

    def forward(self, x, h0=None):
        out, h_final = self.GRU_0(x, h0)
        return torch.relu(self.BatchNorm_0(self.Dense_0(out))), h_final


class TrCNNBlock(nn.Module):
    """1x1 -> BN -> ReLU -> ConvTranspose(k, s, p=s//2) [-> BN -> ReLU].

    `tr_weight` is in torch's conv_transpose1d layout (Cin, Cout, k) with the
    taps already flipped from the JAX kernel (ops/conv.py).
    """

    def __init__(self, in_features, features, kernel, stride, final_norm=True, dtype=None, device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.Dense_0 = Dense(in_features, features, dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype, device=device)
        self.tr_weight = _zeros(features, features, kernel, device=device)
        self.tr_bias = _zeros(features, device=device)
        self.BatchNorm_1 = BatchNorm(features, dtype=dtype, device=device) if final_norm else None

    def init_params(self, generator: torch.Generator):
        w = self.tr_weight
        _draw_(w, generator, fan_in=w.shape[0] * w.shape[2])
        self.tr_bias.zero_()

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Dense_0(x)))
        x = _affine(conv_ops.conv_transpose1d, x, self.tr_weight, self.tr_bias, self.dtype,
                    stride=self.stride, padding=self.stride // 2)
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
