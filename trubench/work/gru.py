"""Bytes and FLOPs of the GRU recurrence's work, from its shapes alone.

Copied from `chip_smoke.py:630-672` (`gru_bound`, `bound`,
`train_kernel_work`) at commit d4c8964, without the partial sums of the
weight gradient: how many splits a kernel sums over is its own choice, not
the algorithm's work. Each input is read once and each output written
once, in float32; `rows` sequences of `steps` steps, hidden size H, gates
3H. Per row and step: the forward takes h Wh (2 H 3H FLOPs) and ~12 H for
the biases and gates; the BPTT d_hp Wh^T (2 3H H) and ~20 H; the weight
gradient h_prev^T d_hp (2 H 3H) and 4 H for dbh and dn r.
"""

from __future__ import annotations

from trubench.work.peaks import FLOPS, HBM_BYTES_PER_S

F32 = 4  # bytes


def forward(rows: int, steps: int, hidden: int) -> tuple[int, int]:
    """(bytes, FLOPs) of an inference recurrence: x_proj, h0, Wh, bh in;
    outputs and the last h out."""
    n, g = rows * steps, 3 * hidden
    nbytes = F32 * (n * g + rows * hidden + hidden * g + g + n * hidden + rows * hidden)
    return nbytes, n * (2 * hidden * g + 12 * hidden)


def forward_train(rows: int, steps: int, hidden: int) -> tuple[int, int]:
    """The training forward: as `forward`, also writing the residuals
    (r, z, n, hn) the BPTT reads."""
    nbytes, flops = forward(rows, steps, hidden)
    return nbytes + F32 * rows * steps * 4 * hidden, flops


def bptt(rows: int, steps: int, hidden: int) -> tuple[int, int]:
    """g, g_hT, the outputs (as h_prev), the residuals, h0, Wh in; d_xp and
    dh0 out."""
    n, g = rows * steps, 3 * hidden
    nbytes = F32 * (n * hidden + rows * hidden + n * hidden + n * 4 * hidden + rows * hidden
                    + hidden * g + n * g + rows * hidden)
    return nbytes, n * (2 * g * hidden + 20 * hidden)


def weight_grad(rows: int, steps: int, hidden: int) -> tuple[int, int]:
    """The outputs (as h_prev), h0, d_xp and r in; dWh and dbh out once."""
    n, g = rows * steps, 3 * hidden
    nbytes = F32 * (n * hidden + rows * hidden + n * g + n * hidden + g * (hidden + 1))
    return nbytes, n * (2 * hidden * g + 4 * hidden)


def train(rows: int, steps: int, hidden: int) -> tuple[int, int]:
    """Forward, BPTT and weight gradient of one trainable recurrence, each
    bounded on its own (`bound_s` of the three, summed by the caller)."""
    parts = (forward_train(rows, steps, hidden), bptt(rows, steps, hidden), weight_grad(rows, steps, hidden))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take: bytes over the HBM rate or
    FLOPs over the float32 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS["float32"])


def train_bound_s(rows: int, steps: int, hidden: int) -> float:
    return sum(bound_s(*work(rows, steps, hidden)) for work in (forward_train, bptt, weight_grad))
