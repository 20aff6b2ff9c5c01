"""The port's CUDA kernel on the card (marker `cuda`; skips without a card).

Run on a machine with an NVIDIA card and nvcc:
    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerance: 1e-4 absolute between the kernel and the plain PyTorch version
on the same card: float32 dot products of length H summed in another order,
carried through up to a few hundred steps (chip_smoke.py measured <= 3e-7).
"""

import os

import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.ops import gru as gru_ops

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(rows, steps, hidden, seed, device):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(hidden)
    arrays = (rng.standard_normal((rows, steps, 3 * hidden)) * 0.5,
              rng.standard_normal((rows, hidden)) * 0.1,
              rng.uniform(-k, k, (hidden, 3 * hidden)),
              rng.uniform(-k, k, (3 * hidden,)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,steps,hidden", [
    (556, 16, 64),   # flagship FGRU, 4 s clip
    (16, 300, 128),  # flagship TGRU
    (7, 9, 40),      # H not a multiple of 32, ragged row tile
    (133, 5, 256),   # Wh read from global memory (large16k FGRU width)
    (3, 1, 8),
])
def test_kernel_matches_plain_version(card, rows, steps, hidden, reverse):
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    before = cuda_gru.launches
    out, h_last = cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.launches == before + 1
    ref_out, ref_h = gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=ATOL)
    torch.testing.assert_close(h_last, ref_h, rtol=0, atol=ATOL)


def test_zero_steps_returns_h0(card):
    x_proj, h0, wh, bh = _inputs(4, 0, 16, 0, card)
    out, h_last = cuda_gru.gru_recurrence(x_proj, h0, wh, bh)
    torch.cuda.synchronize()
    assert out.shape == (4, 0, 16)
    torch.testing.assert_close(h_last, h0, rtol=0, atol=0)


def test_denoise_on_card_matches_cpu_with_three_launches(card):
    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cfg = load_config(os.path.join(REPO, "config", "proc16k.json"))
    artifact = os.path.join(REPO, "artifacts", "TRUNet-proc")
    clip = (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32)
    den = Denoiser.from_pretrained(cfg, artifact, device="cuda")
    cuda_gru.launches = 0
    out = den(clip)
    assert cuda_gru.launches == 3
    ref = Denoiser.from_pretrained(cfg, artifact, device="cpu")(clip)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)
