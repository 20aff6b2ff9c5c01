"""Wrappers of the CUDA GRU recurrence kernels (`csrc/gru_fwd.cu`,
`csrc/gru_train.cu`) and the trainable recurrence `GRURecurrence`.

All tensors are float32: x_proj (rows, T, 3H), h0 (rows, H), wh (H, 3H),
bh (3H,); outputs (rows, T, H).

- `gru_recurrence`: the forward recurrence of inference, (outputs, h after
  the last step walked). Kernel `gru_fwd`, on one of three paths chosen by
  `fwd_plan`: Wh resident in registers (H 64, 128), the same across a thread
  block cluster (H 256, 512), or the general kernel (any H up to 1024).
- `gru_recurrence_train`: the same, also returning the residuals saved
  (rows, T, 4H) = (r, z, n, hn) per step. Kernel `gru_fwd_train`, on one of
  three paths chosen by `fwd_train_plan`: the resident kernel of `gru_fwd`
  with the residuals written beside h (H 64, 128: blocks that stay on the
  card and walk row tile after row tile; H 256, 512: clusters), or the
  general kernel of `gru_train.cu` (any H up to 1024).
- `gru_recurrence_bwd`: the BPTT, (d_xp, dWh, dbh, dh0). On a card it runs
  `bptt` (kernel `gru_bwd`: d_xp, dh0), then `dw_partial` and `dw_sum`
  (kernels `gru_dw_partial` and `gru_dw_sum`: dWh, dbh); these three take
  CUDA tensors only. `gru_bwd` runs on one of two paths chosen by
  `bwd_plan`: Wh resident in registers (H 64, 128: the flagship's FGRU and
  TGRU) or the general kernel (any other H up to 1024). `gru_dw_partial`
  runs on the tensor cores at H 64 and 128 (TF32 with bf16 corrections:
  within 1e-5 of the largest entry, about five times the error of a float32
  product, PERF.md) and as a float32 SIMT product at any other H
  (`dw_splits`). `gru_dw_sum` adds the splits in an order fixed by the
  shapes (`sum_plan`): bit-identical run to run, not the order of the splits.
- `GRURecurrence`: a `torch.autograd.Function` over (x_proj, h0, wh, bh,
  reverse) whose forward is `gru_recurrence_train` and whose backward is
  `gru_recurrence_bwd`. The input projection and its gradients stay plain
  matmuls outside, as in the JAX package.

A CPU tensor runs the plain PyTorch version (`ops/gru.py`). A CUDA tensor
launches the kernels or raises: nothing falls back to the plain version and
nothing moves to the CPU.

Each kernel has a launch count (`launch_counts()`): its wrapper adds one
where it launches the kernel, and nowhere else. `launches` is the count of
`gru_fwd`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tinyrecurrentunet_torch.ops import build
from tinyrecurrentunet_torch.ops import gru as gru_ops

launches = 0  # gru_fwd
last_fwd_plan = None  # the FwdPlan of the last gru_fwd launch
last_fwd_train_plan = None  # the FwdPlan of the last gru_fwd_train launch
last_bwd_plan = None  # the BwdPlan of the last gru_bwd launch
last_sum_plan = None  # the SumPlan of the last gru_dw_sum launch
last_dw_plan = None  # (tensor cores?, splits, row-steps per split) of the last gru_dw_partial launch
fwd_train_launches = 0
bwd_launches = 0
dw_partial_launches = 0
dw_sum_launches = 0

_MAX_HIDDEN = 1024  # one thread per hidden unit, one block per row tile
_DW_TILE = 64  # the output tile of gru_dw_partial_kernel
_DW_MIN_STEPS = 256  # fewest row-steps one split of the weight gradient sums
_DW_MMA_CHUNK = 32  # row-steps gru_dw_mma_kernel stages at a time
_DW_MMA_SLAB = 192  # columns of d_hp one block of gru_dw_mma_kernel owns
_DW_MMA_HIDDEN = (64, 128)  # hidden sizes gru_dw_mma_kernel is built for
_SUM_THREADS = 256  # most threads of a gru_dw_sum block


class FwdPlan(NamedTuple):
    """How one `gru_fwd` launch runs."""

    path: str  # "general", "registers" or "cluster"
    rows_per_tile: int  # rows a block (a cluster) walks


# hidden size -> (blocks of a cluster, blocks an SM holds, rows per tile built)
# of gru_fwd_resident_kernel
_RESIDENT = {
    64: (1, 4, (1, 2, 4, 8)),
    128: (1, 1, (1, 2, 4)),
    256: (8, 1, (1, 2, 4, 8)),
    512: (16, 1, (1, 2, 3, 4)),
}


# hidden size -> (blocks an SM holds, most rows per tile the plan takes) of
# gru_fwd_resident_kernel with its residuals saved (the training forward);
# rows per tile built and cluster size as in _RESIDENT. Blocks an SM holds:
# ptxas's registers at 4 and 8 rows a tile (135 and 167 at H 64, 168 at H
# 128). The most rows: the fastest tile at the flagship's and large16k's
# training shapes on an H100 (scripts/torch_gru_kernel_profile.py, PERF.md).
_FWD_TRAIN_RESIDENT = {
    64: (2, 8),
    128: (1, 4),
    256: (1, 4),
    512: (1, 4),
}


class BwdPlan(NamedTuple):
    """How one `gru_bwd` launch runs."""

    path: str  # "general" or "registers"
    rows_per_tile: int  # rows a block walks at once


# hidden size -> (blocks an SM holds, rows per tile built, most rows per tile
# the plan takes) of gru_bwd_resident_kernel
_BWD_RESIDENT = {
    64: (4, (1, 2, 4), 2),
    128: (1, (1, 2, 4), 4),
}


class SumPlan(NamedTuple):
    """How one `gru_dw_sum` launch runs: blocks of cols * groups threads."""

    cols: int  # float4 words (4 neighbouring entries) of dw a block owns
    groups: int  # lanes of a word, each summing every groups-th split


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the counts were last reset."""
    return {
        "gru_fwd": launches,
        "gru_fwd_train": fwd_train_launches,
        "gru_bwd": bwd_launches,
        "gru_dw_partial": dw_partial_launches,
        "gru_dw_sum": dw_sum_launches,
    }


def reset_launch_counts():
    global launches, fwd_train_launches, bwd_launches, dw_partial_launches, dw_sum_launches
    launches = fwd_train_launches = bwd_launches = dw_partial_launches = dw_sum_launches = 0


def rows_per_block(rows: int, hidden: int, num_sms: int) -> int:
    """Rows a block owns: the fewest (1, 2, 4, 8) that keep the grid within
    one wave of `num_sms` blocks, capped so that H * rows stays <= 2048."""
    rpb = 1
    while rpb < 8 and hidden * rpb * 2 <= 2048 and -(-rows // rpb) > num_sms:
        rpb *= 2
    return rpb


def _fewest_rows_in_one_wave(rows: int, tiles, wave: int) -> int:
    """The fewest rows per tile of `tiles` (ascending) that cut `rows` into
    at most `wave` tiles, else the most."""
    fits = [t for t in tiles if -(-rows // t) <= wave]
    return fits[0] if fits else tiles[-1]


def fwd_plan(rows: int, steps: int, hidden: int, num_sms: int, max_clusters: int | None = None) -> FwdPlan:
    """The plan of one `gru_fwd` launch.

    "registers" (H 64, 128) and "cluster" (H 256, 512: 8 and 16 blocks share
    a row tile) keep Wh in registers; they take the fewest rows per tile that
    keep the grid within one wave of the card, or the most the kernel is
    built for. One wave is four blocks an SM at H 64, one at H 128, and
    `max_clusters` clusters (what the card says it holds at once; by default
    the SMs over the cluster size). "general" is the kernel for every other
    H, with `rows_per_block`. T does not enter: on an H100 the resident kernel
    was at least as fast as the general one at T 16 and at T 251 to 556, at
    16 rows and at 16,064 (scripts/torch_gru_kernel_profile.py, PERF.md).
    """
    if hidden not in _RESIDENT:
        return FwdPlan("general", rows_per_block(rows, hidden, num_sms))
    cluster, per_sm, tiles = _RESIDENT[hidden]
    wave = num_sms * per_sm // cluster
    if cluster > 1 and max_clusters is not None:
        wave = max_clusters
    return FwdPlan("cluster" if cluster > 1 else "registers", _fewest_rows_in_one_wave(rows, tiles, wave))


def fwd_train_plan(rows: int, steps: int, hidden: int, num_sms: int, max_clusters: int | None = None) -> FwdPlan:
    """The plan of one `gru_fwd_train` launch.

    "registers" (H 64, 128) keeps Wh in registers, and its blocks stay on
    the card and walk row tile after row tile; "cluster" (H 256, 512) shares
    a row tile among 8 and 16 blocks, one cluster per tile. Both take the
    fewest rows per tile that keep the tiles within one wave of the card (the
    blocks it holds, or `max_clusters` clusters; by default the SMs over the
    cluster size), else the most the plan takes: 8 at H 64, 4 at H 128, 256
    and 512 (on an H100, 16,064 x 16 x 64: 0.31 ms at 8 rows, 0.33 at 4;
    1,024 x 251 x 128: 0.97 at 4, 1.07 at 2; 4,016 x 16 x 256: 1.63 at 4,
    1.77 at 8). "general" is the kernel of `gru_train.cu` for every other H,
    with `rows_per_block`.
    """
    if hidden not in _FWD_TRAIN_RESIDENT:
        return FwdPlan("general", rows_per_block(rows, hidden, num_sms))
    cluster, _, built = _RESIDENT[hidden]
    per_sm, most = _FWD_TRAIN_RESIDENT[hidden]
    tiles = [t for t in built if t <= most]
    wave = num_sms * per_sm // cluster
    if cluster > 1 and max_clusters is not None:
        wave = max_clusters
    return FwdPlan("cluster" if cluster > 1 else "registers", _fewest_rows_in_one_wave(rows, tiles, wave))


def dw_splits(steps: int, hidden: int, num_sms: int) -> tuple[int, int]:
    """(splits, row-steps per split) of the weight-gradient reduction over
    `steps` = rows * T, each split summing at least 256 row-steps.

    About two blocks per SM either way. On the tensor cores (H 64 and 128) a
    block owns all H rows and 192 columns of dWh, and a split is whole chunks
    of 32 row-steps; the SIMT kernel (any other H) has 64 x 64 output tiles.
    """
    if hidden in _DW_MMA_HIDDEN:
        slabs = 3 * hidden // _DW_MMA_SLAB
        splits = max(1, min(-(-steps // _DW_MIN_STEPS), 2 * num_sms // slabs))
        per_split = -(-steps // (splits * _DW_MMA_CHUNK)) * _DW_MMA_CHUNK
        return -(-steps // per_split), per_split
    tiles = -(-hidden // _DW_TILE) * -(-3 * hidden // _DW_TILE)
    splits = max(1, min(-(-steps // _DW_MIN_STEPS), -(-2 * num_sms // tiles)))
    per_split = -(-steps // splits)
    return -(-steps // per_split), per_split


def bwd_plan(rows: int, steps: int, hidden: int, num_sms: int) -> BwdPlan:
    """The plan of one `gru_bwd` launch.

    "registers" (H 64, 128) keeps Wh in registers; its blocks stay on the
    card and walk row tile after row tile, so Wh is loaded once a block. It
    takes the fewest rows per tile that keep the tiles within one wave of
    the blocks the card holds (four an SM at H 64, one at H 128), at most 2
    at H 64 and 4 at H 128: a wider step costs more than the waves it saves
    (on an H100, 16,064 x 16 x 64: 0.31 ms at 2 rows, 0.33 at 4; 1,024 x 251
    x 128: 0.86 ms at 4, 0.90 at 8; scripts/torch_gru_kernel_profile.py,
    PERF.md). "general" is the kernel for every other H, with
    `rows_per_block`.
    """
    if hidden not in _BWD_RESIDENT:
        return BwdPlan("general", rows_per_block(rows, hidden, num_sms))
    per_sm, tiles, most = _BWD_RESIDENT[hidden]
    tiles = [t for t in tiles if t <= most]
    return BwdPlan("registers", _fewest_rows_in_one_wave(rows, tiles, num_sms * per_sm))


def sum_plan(splits: int, size: int, num_sms: int) -> SumPlan:
    """The plan of one `gru_dw_sum` launch over `splits` partials of `size`
    entries: the widest blocks (8 to 128 float4 words) that still give at
    least two blocks an SM, up to 256 threads a block and as many lanes per
    word as splits (a power of two), at least one warp a block. On an H100
    (scripts/torch_gru_kernel_profile.py, PERF.md) 260 x 12,480 ran in 4.0
    µs at 8 words x 32 lanes, 132 x 49,536 in 5.6 µs at 32 x 8, where 8 x
    32 (1,548 blocks) took 10.6."""
    words = -(-size // 4)
    cols = 8
    while cols < 128 and -(-words // (2 * cols)) >= 2 * num_sms:
        cols *= 2
    groups = min(_SUM_THREADS // cols, 1 << (splits.bit_length() - 1))
    while cols * groups < 32:
        cols *= 2
    return SumPlan(cols, groups)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("gru_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.trunet_gru_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.trunet_gru_fwd.restype = i32
    lib.trunet_gru_fwd_train_resident.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.trunet_gru_fwd_train_resident.restype = i32
    lib.trunet_gru_fwd_max_clusters.argtypes = [i32, i32]
    lib.trunet_gru_fwd_max_clusters.restype = i32
    lib.trunet_cuda_error_string.argtypes = [i32]
    lib.trunet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _train_lib() -> ctypes.CDLL:
    lib = build.load("gru_train")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "trunet_gru_fwd_train": [ptr] * 7 + [i32] * 5 + [ptr],
        "trunet_gru_bwd": [ptr] * 8 + [i32] * 6 + [ptr],
        "trunet_gru_dw_partial": [ptr] * 5 + [i32] * 6 + [ptr],
        "trunet_gru_dw_sum": [ptr] * 2 + [i32] * 4 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.trunet_gru_train_error_string.argtypes = [i32]
    lib.trunet_gru_train_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensors(ref: torch.Tensor, **tensors):
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shape(name: str, t: torch.Tensor, shape: tuple):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _check(x_proj, h0, wh, bh):
    _check_tensors(x_proj, x_proj=x_proj, h0=h0, wh=wh, bh=bh)
    if x_proj.dim() != 3 or x_proj.shape[-1] % 3:
        raise ValueError(f"x_proj must be (rows, T, 3H), got {tuple(x_proj.shape)}")
    rows, _, g = x_proj.shape
    hidden = g // 3
    _check_shape("h0", h0, (rows, hidden))
    _check_shape("wh", wh, (hidden, g))
    _check_shape("bh", bh, (g,))
    if not 1 <= hidden <= _MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} outside the kernel's 1..{_MAX_HIDDEN}")


def _check_bwd(g, g_hT, out, saved, h0, wh):
    _check_tensors(out, g=g, g_hT=g_hT, out=out, saved=saved, h0=h0, wh=wh)
    if out.dim() != 3:
        raise ValueError(f"out must be (rows, T, H), got {tuple(out.shape)}")
    rows, steps, hidden = out.shape
    _check_shape("g", g, (rows, steps, hidden))
    _check_shape("saved", saved, (rows, steps, 4 * hidden))
    for name, t in (("g_hT", g_hT), ("h0", h0)):
        _check_shape(name, t, (rows, hidden))
    _check_shape("wh", wh, (hidden, 3 * hidden))
    if not 1 <= hidden <= _MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} outside the kernel's 1..{_MAX_HIDDEN}")


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one (kernel)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no GRU recurrence for device {t.device}")
    return True


def _raise_on_error(lib, err: int, kernel: str, error_string: str):
    if err != 0:
        msg = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _max_clusters(device: torch.device, hidden: int, save: bool = False) -> int | None:
    """Clusters of the resident kernel (of inference, or with `save` of the
    training forward) that `device` holds at once (H 256, 512), asked once
    per device, which also allows the kernel its cluster size there; None
    where the kernel runs without clusters. Raises if the card cannot
    schedule the cluster at all."""
    if _RESIDENT.get(hidden, (1,))[0] == 1:
        return None
    kernel = "gru_fwd_train" if save else "gru_fwd"
    lib = _lib()
    with torch.cuda.device(device):
        clusters = lib.trunet_gru_fwd_max_clusters(hidden, int(save))
    if clusters < 0:
        _raise_on_error(lib, -clusters, f"{kernel} cluster occupancy query", "trunet_cuda_error_string")
    if clusters == 0:
        raise RuntimeError(f"{kernel}: the card cannot schedule the clusters of the H={hidden} kernel")
    return clusters


def gru_recurrence(
    x_proj: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """The GRU recurrence: plain PyTorch on the CPU, the CUDA kernel on a card."""
    if not _on_card(x_proj):
        return gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    return _launch(x_proj, h0, wh, bh, reverse)


def _launch(x_proj, h0, wh, bh, reverse, plan=None):
    """Launches `gru_fwd` on `plan` (default: `fwd_plan` of the shapes)."""
    global launches, last_fwd_plan
    _check(x_proj, h0, wh, bh)
    rows, steps, g = x_proj.shape
    hidden = g // 3
    out = torch.empty((rows, steps, hidden), dtype=torch.float32, device=x_proj.device)
    h_last = torch.empty((rows, hidden), dtype=torch.float32, device=x_proj.device)
    if rows == 0:
        return out, h_last
    max_clusters = _max_clusters(x_proj.device, hidden)
    plan = plan or fwd_plan(rows, steps, hidden, _num_sms(x_proj.device), max_clusters)
    lib = _lib()
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream()
        err = lib.trunet_gru_fwd(
            x_proj.data_ptr(), h0.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            out.data_ptr(), h_last.data_ptr(),
            rows, steps, hidden, int(reverse), plan.rows_per_tile, int(plan.path != "general"),
            stream.cuda_stream,
        )
    _raise_on_error(lib, err, f"gru_fwd {plan}", "trunet_cuda_error_string")
    launches += 1
    last_fwd_plan = plan
    return out, h_last


def gru_recurrence_train(
    x_proj: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """(outputs, h after the last step walked, saved residuals): plain
    PyTorch on the CPU, the `gru_fwd_train` kernel on a card."""
    if not _on_card(x_proj):
        return gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    return _launch_fwd_train(x_proj, h0, wh, bh, reverse)


def _launch_fwd_train(x_proj, h0, wh, bh, reverse, plan=None):
    """Launches `gru_fwd_train` on `plan` (default: `fwd_train_plan` of the
    shapes): the resident kernel of `gru_fwd.cu` or the general one of
    `gru_train.cu`."""
    global fwd_train_launches, last_fwd_train_plan
    _check(x_proj, h0, wh, bh)
    rows, steps, g = x_proj.shape
    hidden = g // 3
    out = torch.empty((rows, steps, hidden), dtype=torch.float32, device=x_proj.device)
    h_last = torch.empty((rows, hidden), dtype=torch.float32, device=x_proj.device)
    saved = torch.empty((rows, steps, 4 * hidden), dtype=torch.float32, device=x_proj.device)
    if rows == 0:
        return out, h_last, saved
    if plan is None:
        max_clusters = _max_clusters(x_proj.device, hidden, save=True)
        plan = fwd_train_plan(rows, steps, hidden, _num_sms(x_proj.device), max_clusters)
    elif plan.path == "cluster":
        _max_clusters(x_proj.device, hidden, save=True)  # allows the cluster size on this device
    if plan.path == "general":
        lib, launch, error_string = _train_lib(), "trunet_gru_fwd_train", "trunet_gru_train_error_string"
    else:
        lib, launch, error_string = _lib(), "trunet_gru_fwd_train_resident", "trunet_cuda_error_string"
    with torch.cuda.device(x_proj.device):
        err = getattr(lib, launch)(
            x_proj.data_ptr(), h0.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            out.data_ptr(), h_last.data_ptr(), saved.data_ptr(),
            rows, steps, hidden, int(reverse), plan.rows_per_tile,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"gru_fwd_train {plan}", error_string)
    fwd_train_launches += 1
    last_fwd_train_plan = plan
    return out, h_last, saved


def gru_recurrence_bwd(
    g: torch.Tensor,
    g_hT: torch.Tensor,
    out: torch.Tensor,
    saved: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    reverse: bool = False,
):
    """(d_xp, dWh, dbh, dh0) of the recurrence from the gradients g of the
    outputs and g_hT of the last state: plain PyTorch on the CPU, the
    `gru_bwd`, `gru_dw_partial` and `gru_dw_sum` kernels on a card."""
    if not _on_card(out):
        return gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    d_xp, dh0 = bptt(g, g_hT, out, saved, h0, wh, reverse=reverse)
    rows, steps, hidden = out.shape
    if rows == 0 or steps == 0:
        dwh, dbh = torch.zeros_like(wh), wh.new_zeros(3 * hidden)
    else:
        dwh, dbh = dw_sum(dw_partial(out, h0, d_xp, saved, reverse=reverse), hidden)
    return d_xp, dwh, dbh, dh0


def _require_card(t: torch.Tensor, kernel: str):
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} runs on a CUDA device, got a tensor on {t.device}")


def bptt(g, g_hT, out, saved, h0, wh, reverse: bool = False):
    """Kernel `gru_bwd`: (d_xp (rows, T, 3H), dh0 (rows, H)). CUDA tensors only."""
    return _launch_bwd(g, g_hT, out, saved, h0, wh, reverse)


def _launch_bwd(g, g_hT, out, saved, h0, wh, reverse, plan=None):
    """Launches `gru_bwd` on `plan` (default: `bwd_plan` of the shapes)."""
    global bwd_launches, last_bwd_plan
    _require_card(out, "gru_bwd")
    _check_bwd(g, g_hT, out, saved, h0, wh)
    rows, steps, hidden = out.shape
    d_xp = torch.empty((rows, steps, 3 * hidden), dtype=torch.float32, device=out.device)
    dh0 = torch.empty((rows, hidden), dtype=torch.float32, device=out.device)
    if rows == 0:
        return d_xp, dh0
    plan = plan or bwd_plan(rows, steps, hidden, _num_sms(out.device))
    lib = _train_lib()
    with torch.cuda.device(out.device):
        err = lib.trunet_gru_bwd(
            g.data_ptr(), g_hT.data_ptr(), out.data_ptr(), saved.data_ptr(), h0.data_ptr(),
            wh.data_ptr(), d_xp.data_ptr(), dh0.data_ptr(),
            rows, steps, hidden, int(reverse), plan.rows_per_tile, int(plan.path != "general"),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(lib, err, f"gru_bwd {plan}", "trunet_gru_train_error_string")
    bwd_launches += 1
    last_bwd_plan = plan
    return d_xp, dh0


def dw_partial(out, h0, d_xp, saved, reverse: bool = False) -> torch.Tensor:
    """Kernel `gru_dw_partial`: per-split sums of dWh and dbh over the
    rows * T row-steps, (splits, H*3H + 3H). CUDA tensors only; rows, T >= 1."""
    return _launch_dw(out, h0, d_xp, saved, reverse)


def _launch_dw(out, h0, d_xp, saved, reverse, plan=None) -> torch.Tensor:
    """Launches `gru_dw_partial` on `plan` = (splits, row-steps per split);
    default: `dw_splits`."""
    global dw_partial_launches, last_dw_plan
    _require_card(out, "gru_dw_partial")
    rows, steps, hidden = out.shape
    _check_tensors(out, out=out, h0=h0, d_xp=d_xp, saved=saved)
    _check_shape("h0", h0, (rows, hidden))
    _check_shape("d_xp", d_xp, (rows, steps, 3 * hidden))
    _check_shape("saved", saved, (rows, steps, 4 * hidden))
    if rows < 1 or steps < 1:
        raise ValueError(f"gru_dw_partial needs rows, T >= 1, got {rows}, {steps}")
    tensor_cores = hidden in _DW_MMA_HIDDEN
    if tensor_cores:
        # the kernel copies 16 bytes at a time and indexes row-steps with an int
        for name, t in (("out", out), ("h0", h0), ("d_xp", d_xp), ("saved", saved)):
            if t.data_ptr() % 16:
                raise ValueError(f"gru_dw_partial at H={hidden} needs {name} aligned to 16 bytes")
        if rows * steps >= 2**31:
            raise ValueError(f"gru_dw_partial at H={hidden} takes rows * T < 2^31, got {rows * steps}")
    splits, per_split = plan or dw_splits(rows * steps, hidden, _num_sms(out.device))
    part = torch.empty((splits, 3 * hidden * (hidden + 1)), dtype=torch.float32, device=out.device)
    lib = _train_lib()
    with torch.cuda.device(out.device):
        err = lib.trunet_gru_dw_partial(
            out.data_ptr(), h0.data_ptr(), d_xp.data_ptr(), saved.data_ptr(), part.data_ptr(),
            rows, steps, hidden, int(reverse), splits, per_split,
            torch.cuda.current_stream().cuda_stream,
        )
    last_dw_plan = (tensor_cores, splits, per_split)
    _raise_on_error(lib, err, f"gru_dw_partial {last_dw_plan}", "trunet_gru_train_error_string")
    dw_partial_launches += 1
    return part


def dw_sum(part: torch.Tensor, hidden: int):
    """Kernel `gru_dw_sum`: the partials summed over the splits -> (dWh
    (H, 3H), dbh (3H,)). The order of the sum is fixed by the shapes
    (`sum_plan`), so two calls give the same bits, but it is not the
    sequential sum in split order. CUDA tensors only; `part` on a 16-byte
    boundary (the kernel reads 16 bytes at a time), else ValueError."""
    return _launch_sum(part, hidden)


def _launch_sum(part, hidden, plan=None):
    """Launches `gru_dw_sum` on `plan` (default: `sum_plan` of the shapes)."""
    global dw_sum_launches, last_sum_plan
    size = 3 * hidden * (hidden + 1)
    _check_tensors(part, part=part)
    if part.dim() != 2 or part.shape[1] != size or part.shape[0] < 1:
        raise ValueError(f"part must be (splits, {size}), got {tuple(part.shape)}")
    if part.data_ptr() % 16:
        raise ValueError("gru_dw_sum needs part aligned to 16 bytes")
    _require_card(part, "gru_dw_sum")
    splits = part.shape[0]
    plan = plan or sum_plan(splits, size, _num_sms(part.device))
    dw = torch.empty(size, dtype=torch.float32, device=part.device)
    lib = _train_lib()
    with torch.cuda.device(part.device):
        err = lib.trunet_gru_dw_sum(part.data_ptr(), dw.data_ptr(), splits, size, plan.cols, plan.groups,
                                    torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, f"gru_dw_sum {plan}", "trunet_gru_train_error_string")
    dw_sum_launches += 1
    last_sum_plan = plan
    return dw[: 3 * hidden * hidden].view(hidden, 3 * hidden), dw[3 * hidden * hidden :]


class GRURecurrence(torch.autograd.Function):
    """The trainable recurrence: (x_proj, h0, wh, bh, reverse) -> (outputs,
    h after the last step walked). Counterpart of the custom VJP of
    `tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py` over the recurrence alone.
    """

    @staticmethod
    def forward(ctx, x_proj, h0, wh, bh, reverse):
        out, h_last, saved = gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
        ctx.save_for_backward(out, saved, h0, wh)
        ctx.reverse = reverse
        return out, h_last

    @staticmethod
    def backward(ctx, g_out, g_hT):
        out, saved, h0, wh = ctx.saved_tensors
        d_xp, dwh, dbh, dh0 = gru_recurrence_bwd(
            g_out.contiguous(), g_hT.contiguous(), out, saved, h0, wh, reverse=ctx.reverse
        )
        return d_xp, dh0, dwh, dbh, None
