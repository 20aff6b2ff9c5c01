"""Wrapper of the CUDA forward GRU recurrence (`csrc/gru_fwd.cu`).

`gru_recurrence(x_proj, h0, wh, bh, reverse)` takes the projected inputs
x_proj (rows, T, 3H), h0 (rows, H), wh (H, 3H) and bh (3H,), all float32,
and returns (outputs (rows, T, H), h after the last step walked (rows, H)).

- A CPU tensor runs the plain PyTorch version (`ops/gru.py`).
- A CUDA tensor launches the kernel or raises: nothing falls back to the
  plain version and nothing moves to the CPU.

`launches` counts the kernel's launches: the wrapper adds one where it
launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tinyrecurrentunet_torch.ops import build
from tinyrecurrentunet_torch.ops import gru as gru_ops

launches = 0

_MAX_HIDDEN = 1024  # one thread per hidden unit, one block per row tile


def rows_per_block(rows: int, hidden: int, num_sms: int) -> int:
    """Rows a block owns: the fewest (1, 2, 4, 8) that keep the grid within
    one wave of `num_sms` blocks, capped so that H * rows stays <= 2048."""
    rpb = 1
    while rpb < 8 and hidden * rpb * 2 <= 2048 and -(-rows // rpb) > num_sms:
        rpb *= 2
    return rpb


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("gru_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.trunet_gru_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.trunet_gru_fwd.restype = i32
    lib.trunet_gru_fwd_wh_in_smem.argtypes = [i32, i32]
    lib.trunet_gru_fwd_wh_in_smem.restype = i32
    lib.trunet_cuda_error_string.argtypes = [i32]
    lib.trunet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x_proj, h0, wh, bh):
    tensors = {"x_proj": x_proj, "h0": h0, "wh": wh, "bh": bh}
    for name, t in tensors.items():
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on {x_proj.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x_proj.dim() != 3 or x_proj.shape[-1] % 3:
        raise ValueError(f"x_proj must be (rows, T, 3H), got {tuple(x_proj.shape)}")
    rows, _, g = x_proj.shape
    hidden = g // 3
    if tuple(h0.shape) != (rows, hidden):
        raise ValueError(f"h0 must be {(rows, hidden)}, got {tuple(h0.shape)}")
    if tuple(wh.shape) != (hidden, g):
        raise ValueError(f"wh must be {(hidden, g)}, got {tuple(wh.shape)}")
    if tuple(bh.shape) != (g,):
        raise ValueError(f"bh must be {(g,)}, got {tuple(bh.shape)}")
    if not 1 <= hidden <= _MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} outside the kernel's 1..{_MAX_HIDDEN}")


def gru_recurrence(
    x_proj: torch.Tensor,
    h0: torch.Tensor,
    wh: torch.Tensor,
    bh: torch.Tensor,
    reverse: bool = False,
):
    """The GRU recurrence: plain PyTorch on the CPU, the CUDA kernel on a card."""
    if x_proj.device.type == "cpu":
        return gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no GRU recurrence for device {x_proj.device}")
    return _launch(x_proj, h0, wh, bh, reverse)


def _launch(x_proj, h0, wh, bh, reverse):
    global launches
    _check(x_proj, h0, wh, bh)
    rows, steps, g = x_proj.shape
    hidden = g // 3
    out = torch.empty((rows, steps, hidden), dtype=torch.float32, device=x_proj.device)
    h_last = torch.empty((rows, hidden), dtype=torch.float32, device=x_proj.device)
    if rows == 0:
        return out, h_last
    lib = _lib()
    num_sms = torch.cuda.get_device_properties(x_proj.device).multi_processor_count
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream()
        err = lib.trunet_gru_fwd(
            x_proj.data_ptr(), h0.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            out.data_ptr(), h_last.data_ptr(),
            rows, steps, hidden, int(reverse), rows_per_block(rows, hidden, num_sms),
            stream.cuda_stream,
        )
    if err != 0:
        msg = lib.trunet_cuda_error_string(err).decode()
        raise RuntimeError(f"gru_fwd launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out, h_last
