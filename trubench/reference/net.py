"""TRU-Net (arXiv 2102.03207) in plain PyTorch: the benchmark's reference
network, a function of a parameter dict, with no kernel, graph or cache.

Written for the benchmark from the layer equations the port implements,
and importing nothing of the port. Parameters use the port's state_dict
names and torch's layouts (`reference/weights.py` makes them): Dense
`weight` (out, in); Conv `weight` (Cout, Cin, k); `depthwise_weight`
(C, 1, k); `tr_weight` (Cin, Cout, k) with the taps flipped from flax's
kernel; GRU `wi_*` (D, 3H), `wh_*` (H, 3H), `bi_*`, `bh_*` (3H,); BatchNorm
`weight`, `bias`, `running_mean`, `running_var`.

Activations are (N, L, C). BatchNorm is flax's: eps 1e-5; in training mode
the batch mean and the biased variance E[x^2] - E[x]^2 clipped at 0; in
eval mode the running statistics. The GRU is torch.nn.GRU's (gates r, z, n;
the hidden bias inside r * (h Wh_n + bh_n)), walked step by step.

`Rounding` stands for a compute precision below float32, where flax casts
(Dense, Conv and ConvTranspose round their inputs, kernel, product and bias
add; BatchNorm computes in float32 and rounds its output; the GRU projects
in the low precision and recurs in float32). Its rounding also rounds the
gradient that flows back through each cast. `Rounding(None)` is float32
throughout: the reference proper.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is torch.float8_e4m3fn:
        # per-tensor scaling, as fp8 training recipes do
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(dtype).to(x.dtype) * scale
    return x.to(dtype).to(x.dtype)


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


class Rounding:
    """Rounds through `dtype` (None: no rounding), forward and backward."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dtype is None else _RoundBoth.apply(x, self.dtype)


FLOAT32 = Rounding(None)


def _affine(q, op, x, w, b, **kw):
    return q(q(op(q(x), q(w), None, **kw)) + q(b))


def dense(p, name, x, q):
    return _affine(q, F.linear, x, p[f"{name}.weight"], p[f"{name}.bias"])


def conv1d(x, w, b, stride, padding, groups=1):
    """x (N, L, Cin), w (Cout, Cin/groups, k) -> (N, (L + 2p - k)//s + 1, Cout)."""
    return F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=padding, groups=groups).transpose(1, 2)


def conv_transpose1d(x, w, b, stride, padding):
    """x (N, L, Cin), w (Cin, Cout, k) -> (N, (L - 1)s - 2p + k, Cout)."""
    return F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride, padding=padding).transpose(1, 2)


def batch_norm(p, name, x, train: bool, q):
    x = x.float()
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return q((x - mean) * (torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"]) + p[f"{name}.bias"])


def gru_direction(x, h0, wi, wh, bi, bh, reverse: bool, q):
    """x (N, L, D) -> (outputs (N, L, H), h after the last step walked)."""
    xp = q(q(x @ q(wi)) + q(bi)).float()
    h = h0.float()
    wh, bh = q(wh).float(), q(bh).float()
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    outs = [None] * x.shape[1]
    for t in steps:
        xr, xz, xn = xp[:, t].chunk(3, dim=-1)
        hr, hz, hn = (h @ wh + bh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return q(torch.stack(outs, dim=1)), q(h)


def gru_block(p, name, x, h0, bidirectional: bool, train: bool, q):
    g = f"{name}.GRU_0"
    hidden = p[f"{g}.wh_fwd"].shape[0]
    zeros = x.new_zeros((x.shape[0], hidden))
    h0 = zeros if h0 is None else h0
    out, h_last = gru_direction(x, h0, *(p[f"{g}.{w}_fwd"] for w in ("wi", "wh", "bi", "bh")), False, q)
    if bidirectional:
        back, _ = gru_direction(x, zeros, *(p[f"{g}.{w}_bwd"] for w in ("wi", "wh", "bi", "bh")), True, q)
        out = torch.cat([out, back], dim=-1)
    y = torch.relu(batch_norm(p, f"{name}.BatchNorm_0", dense(p, f"{name}.Dense_0", out, q), train, q))
    return y, h_last


def pad_or_crop(x, target: int, dim: int = 1):
    """diff // 2 zeros (or a crop, where negative) in front on `dim`, the rest behind."""
    diff = target - x.shape[dim]
    if diff == 0:
        return x
    front = diff // 2
    if diff > 0:
        pads = [0, 0] * (x.dim() - 1 - dim) + [front, diff - front]
        return F.pad(x, pads)
    return x.narrow(dim, -front, target)


def bottleneck_freqs(net: dict, freqs: int) -> int:
    for i, (_, k, s) in enumerate(net["encoder"]):
        pad = s // 2 if i == 0 else k // 2
        freqs = (freqs + 2 * pad - k) // s + 1
    return freqs


def _encoder_block(p, i, k, s, z, train, q):
    if i == 0:
        c = "StandardConv1d_0.Conv_0"
        return torch.relu(_affine(q, conv1d, z, p[f"{c}.weight"], p[f"{c}.bias"], stride=s, padding=s // 2))
    m = f"DepthwiseSeparableConv1d_{i - 1}"
    z = torch.relu(batch_norm(p, f"{m}.BatchNorm_0", dense(p, f"{m}.Dense_0", z, q), train, q))
    z = _affine(q, conv1d, z, p[f"{m}.depthwise_weight"], p[f"{m}.depthwise_bias"],
                stride=s, padding=k // 2, groups=z.shape[-1])
    return torch.relu(batch_norm(p, f"{m}.BatchNorm_1", z, train, q))


def _decoder_block(p, idx, k, s, last, z, train, q):
    m = f"TrCNNBlock_{idx}"
    z = torch.relu(batch_norm(p, f"{m}.BatchNorm_0", dense(p, f"{m}.Dense_0", z, q), train, q))
    z = _affine(q, conv_transpose1d, z, p[f"{m}.tr_weight"], p[f"{m}.tr_bias"], stride=s, padding=s // 2)
    return z if last else torch.relu(batch_norm(p, f"{m}.BatchNorm_1", z, train, q))


def trunet(p: dict, net: dict, x: torch.Tensor, h0=None, train: bool = False, q: Rounding = FLOAT32,
           recompute: bool = False):
    """x (B, T, F, C_in) float32 -> (y (B, T, F, 2 C_in) float32, TGRU carry (B, F_b, H_t)).

    `net` is the configuration's "network" section (encoder and decoder
    as [features, kernel, stride] rows, the GRU widths). With `recompute`,
    each block keeps only its input for the backward and runs again there
    (torch.utils.checkpoint): the same arithmetic in less memory."""

    def block(fn, *args):
        if not recompute:
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    batch, time, freqs, chans = x.shape
    z = q(x.float()).reshape(batch * time, freqs, chans)
    skips = []
    for i, (_, k, s) in enumerate(net["encoder"]):
        z = block(lambda z, i=i, k=k, s=s: _encoder_block(p, i, k, s, z, train, q), z)
        skips.append(z)

    fb = z.shape[1]
    z, _ = block(lambda z: gru_block(p, "GRUBlock_0", z, None, True, train, q), z)
    fgru_out = z.shape[-1]
    z = z.reshape(batch, time, fb, fgru_out).transpose(1, 2).reshape(batch * fb, time, fgru_out)
    hidden = net["tgru_hidden"]
    carry = None if h0 is None else q(h0.float()).reshape(batch * fb, hidden)
    z, h_last = block(lambda z: gru_block(p, "GRUBlock_1", z, carry, False, train, q), z)
    tgru_out = z.shape[-1]
    z = z.reshape(batch, fb, time, tgru_out).transpose(1, 2).reshape(batch * time, fb, tgru_out)

    decoder = net["decoder"]
    for idx, (_, k, s) in enumerate(decoder):
        if idx > 0:
            skip = skips[-1 - idx]
            z = torch.cat([pad_or_crop(z, skip.shape[1]), skip], dim=-1)
        last = idx == len(decoder) - 1
        z = block(lambda z, idx=idx, k=k, s=s, last=last: _decoder_block(p, idx, k, s, last, z, train, q), z)
    z = pad_or_crop(z, freqs)
    return z.reshape(batch, time, freqs, -1).float(), h_last.reshape(batch, fb, hidden)
