"""GRU in plain PyTorch: the CPU path and the oracle of the CUDA kernel.

Counterpart of `tinyrecurrentunet_tpu/ops/gru.py`, with torch.nn.GRU math:
gate order r, z, n; separate input and hidden biases, the hidden bias inside
r * (h @ Wh_n + bh_n). The input projection of all steps is one matmul
outside the recurrence; the recurrence walks a projected input.

Layouts: weights as the JAX package stores them, wi (D, 3H), wh (H, 3H),
bi and bh (3H,). Sequences are batch-major, x (B, L, D) and x_proj
(B, L, 3H), outputs (B, L, H).

In bfloat16 a layer (`gru_layer`) keeps the contract of the JAX package's
Pallas kernels (`ops/pallas_gru.py`, `ops/pallas_gru_vjp.py`): the input
projection is a bf16 product plus a bf16 bias, the recurrence runs in
float32 on float32 copies of x_proj, h0, Wh and bh, and the outputs and the
last h are rounded back to bf16. Under autograd the casts give the
kernels' gradient casts: d_xproj, dWh, dbh and dh0 rounded to bf16, dx,
dWi and dbi computed in bf16.
"""

from __future__ import annotations

import torch


def gru_project_inputs(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    """Input projection of all steps: (..., D) @ (D, 3H) + (3H,)."""
    return torch.matmul(x, wi) + bi


def _gates(x_proj_t: torch.Tensor, h: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor):
    """(r, z, n, hn) of one step: hn = (h @ Wh + bh)_n, the residual the
    backward needs beside the gates."""
    h_proj = torch.matmul(h, wh) + bh
    xr, xz, xn = x_proj_t.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return r, z, n, hn


def gru_cell(x_proj_t: torch.Tensor, h: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor):
    """One cell update from a projected input: x_proj_t (B, 3H), h (B, H)."""
    r, z, n, _ = _gates(x_proj_t, h, wh, bh)
    return (1.0 - z) * n + z * h


def gru_step(
    x_t: torch.Tensor,
    h: torch.Tensor,
    wi: torch.Tensor,
    wh: torch.Tensor,
    bi: torch.Tensor,
    bh: torch.Tensor,
) -> torch.Tensor:
    """One streaming GRU step from a raw input frame x_t (B, D) -> h' (B, H),
    at the dtype of x_t (`gru_layer`)."""
    return gru_layer(x_t[:, None], h, wi, wh, bi, bh, gru_recurrence)[1]


def gru_recurrence(
    x_proj: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """The recurrence over a projected input, x_proj (B, L, 3H), h0 (B, H).

    `reverse` walks time right to left; outputs stay aligned with the input
    positions. Returns (outputs (B, L, H), h at the last step walked (B, H)).
    """
    length = x_proj.shape[1]
    out = x_proj.new_empty(x_proj.shape[:2] + h0.shape[-1:])
    h = h0
    for t in _walk(length, reverse):
        h = gru_cell(x_proj[:, t], h, wh, bh)
        out[:, t] = h
    return out, h


def _walk(length: int, reverse: bool) -> range:
    """The steps in the order the forward walks them."""
    return range(length - 1, -1, -1) if reverse else range(length)


def gru_recurrence_train(
    x_proj: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """The recurrence, also saving the residuals the backward needs.

    Counterpart of `_fwd_kernel` in `tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py`.
    Returns (outputs (B, L, H), h at the last step walked (B, H), saved
    (B, L, 4H) = concat(r, z, n, hn) per step).
    """
    hidden = h0.shape[-1]
    out = x_proj.new_empty(x_proj.shape[:2] + (hidden,))
    saved = x_proj.new_empty(x_proj.shape[:2] + (4 * hidden,))
    h = h0
    for t in _walk(x_proj.shape[1], reverse):
        r, z, n, hn = _gates(x_proj[:, t], h, wh, bh)
        h = (1.0 - z) * n + z * h
        out[:, t] = h
        saved[:, t] = torch.cat([r, z, n, hn], dim=-1)
    return out, h, saved


def gru_recurrence_bwd(
    g: torch.Tensor,
    g_hT: torch.Tensor,
    out: torch.Tensor,
    saved: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    reverse: bool = False,
):
    """BPTT of `gru_recurrence_train`, one step at a time in reverse walk order.

    Counterpart of `_bwd_kernel` in `tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py`.
    g (B, L, H) is the gradient of the outputs, g_hT (B, H) that of the
    state after the last step walked (added at that step). h_prev of step t
    is the output of the step walked before it, or h0. dWh and dbh are
    summed after the walk (`gru_weight_grads`). Returns
    (d_xp (B, L, 3H), dWh (H, 3H), dbh (3H,), dh0 (B, H)).
    """
    length = out.shape[1]
    d_xp = out.new_empty(out.shape[:2] + (wh.shape[1],))
    carry = g_hT
    order = list(_walk(length, reverse))
    for i in range(length - 1, -1, -1):
        t = order[i]
        h_prev = out[:, order[i - 1]] if i > 0 else h0
        r, z, n, hn = saved[:, t].chunk(4, dim=-1)
        dh = carry + g[:, t]
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn * r * (1.0 - r)
        d_xp[:, t] = torch.cat([dr, dz, dn], dim=-1)
        carry = dh * z + torch.matmul(torch.cat([dr, dz, dn * r], dim=-1), wh.T)
    dwh, dbh = gru_weight_grads(out, h0, d_xp, saved, reverse)
    return d_xp, dwh, dbh, carry


def gru_weight_grads(
    out: torch.Tensor,
    h0: torch.Tensor,
    d_xp: torch.Tensor,
    saved: torch.Tensor,
    reverse: bool = False,
):
    """(dWh (H, 3H), dbh (3H,)) from the BPTT's d_xp, in one product:
    the sum over rows and steps of h_prev^T d_hp, d_hp = (dr, dz, dn * r).
    The plain version of the kernels `gru_dw_partial` and `gru_dw_sum`."""
    hidden = out.shape[-1]
    first = h0[:, None]
    h_prev = torch.cat([out[:, 1:], first], 1) if reverse else torch.cat([first, out[:, :-1]], 1)
    h_prev = h_prev[:, : out.shape[1]]  # no step: no h_prev
    d_hp = torch.cat([d_xp[..., : 2 * hidden], d_xp[..., 2 * hidden :] * saved[..., :hidden]], -1)
    dwh = torch.matmul(h_prev.reshape(-1, hidden).T, d_hp.reshape(-1, 3 * hidden))
    return dwh, d_hp.sum(dim=(0, 1))


def recurrence_function(name: str, train, bwd, doc: str) -> type[torch.autograd.Function]:
    """A trainable recurrence `name`, the autograd Function (x_proj, h0, wh,
    bh, reverse) -> (outputs, h after the last step walked), whose forward is
    train(x_proj, h0, wh, bh, reverse) -> (outputs, h, saved) and whose
    backward is bwd(g, g_hT, out, saved, h0, wh, reverse) -> (d_xp, dWh,
    dbh, dh0). The input projection and its gradients stay plain matmuls
    outside, as in the JAX package."""

    def forward(ctx, x_proj, h0, wh, bh, reverse):
        out, h_last, saved = train(x_proj, h0, wh, bh, reverse=reverse)
        ctx.save_for_backward(out, saved, h0, wh)
        ctx.reverse = reverse
        return out, h_last

    def backward(ctx, g_out, g_hT):
        out, saved, h0, wh = ctx.saved_tensors
        d_xp, dwh, dbh, dh0 = bwd(g_out.contiguous(), g_hT.contiguous(), out, saved, h0, wh, reverse=ctx.reverse)
        return d_xp, dh0, dwh, dbh, None

    # built with type() so that autograd names the node `<name>Backward`
    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(forward), "backward": staticmethod(backward), "__doc__": doc})


PlainGRURecurrence = recurrence_function(
    "PlainGRURecurrence", gru_recurrence_train, gru_recurrence_bwd,
    """The trainable recurrence in plain PyTorch on any device, which
    launches none of the port's kernels (`network.use_pallas_gru` "never").""",
)


def gru_scan(
    x: torch.Tensor,
    h0: torch.Tensor,
    wi: torch.Tensor,
    wh: torch.Tensor,
    bi: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """Full-sequence GRU, x (B, L, D) -> (outputs (B, L, H), final h (B, H)),
    at the dtype of x (`gru_layer`)."""
    return gru_layer(x, h0, wi, wh, bi, bh, gru_recurrence, reverse)


def gru_layer(x, h0, wi, wh, bi, bh, recurrence, reverse: bool = False):
    """x (B, L, D) -> (outputs (B, L, H), h at the last step walked (B, H))
    through `recurrence(x_proj, h0, wh, bh, reverse)`: this module's plain
    version, or a CUDA kernel's wrapper. float32 and float64 run straight;
    bfloat16 takes the Pallas kernels' edges (module docstring), so the
    recurrence always sees float32."""
    x_proj = gru_project_inputs(x, wi, bi)
    if x.dtype != torch.bfloat16:
        return recurrence(x_proj.contiguous(), h0, wh, bh, reverse)
    out, h_last = recurrence(x_proj.float().contiguous(), h0.float(), wh.float(), bh.float(), reverse)
    return out.to(x.dtype), h_last.to(x.dtype)
