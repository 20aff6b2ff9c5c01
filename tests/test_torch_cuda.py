"""The port's CUDA kernels on the card (marker `cuda`; skips without a card).

Run on a machine with an NVIDIA card and nvcc:
    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances, kernel against the plain PyTorch version on the same card:
- 1e-4 absolute on outputs, h_T, saved residuals, d_xp and dh0: float32 dot
  products of length H or 3H summed in another order, carried through up to
  a few hundred steps (chip_smoke.py measured <= 3e-7 for gru_fwd);
- 1e-4 relative to the largest entry, max|a - b| / max|b|, on dWh and dbh:
  sums over rows * T row-steps taken in another order (per split, then over
  the splits) than the plain version's step-by-step sum.
"""

import os

import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.ops import gru as gru_ops

torch.set_num_threads(2)  # beside JAX's pools under several test workers

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


def _grads(rows, steps, hidden, seed, device):
    rng = np.random.default_rng(seed + 1)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
            for s in ((rows, steps, hidden), (rows, hidden))]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,steps,hidden", [
    (2008, 16, 64),  # flagship FGRU at batch 8
    (128, 251, 128),  # flagship TGRU at batch 8
    (7, 9, 40),       # H not a multiple of 32 or 64, ragged row tile
    (133, 5, 256),    # Wh read from global memory
    (3, 1, 8),
])
def test_training_kernels_match_plain_versions(card, rows, steps, hidden, reverse):
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    g, g_hT = _grads(rows, steps, hidden, rows + steps, card)
    counts = cuda_gru.launch_counts()
    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    want = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    out, _, saved = want
    d_got = cuda_gru.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.cuda.synchronize()
    d_want = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.testing.assert_close(d_got[0], d_want[0], rtol=0, atol=ATOL)  # d_xp
    torch.testing.assert_close(d_got[3], d_want[3], rtol=0, atol=ATOL)  # dh0
    assert _rel(d_got[1], d_want[1]) <= 1e-4  # dWh
    assert _rel(d_got[2], d_want[2]) <= 1e-4  # dbh
    after = cuda_gru.launch_counts()
    assert {k: after[k] - counts[k] for k in after} == {
        "gru_fwd": 0, "gru_fwd_train": 1, "gru_bwd": 1, "gru_dw_partial": 1, "gru_dw_sum": 1}


def test_weight_gradient_is_deterministic(card):
    x_proj, h0, wh, bh = _inputs(1000, 20, 64, 5, card)
    g, g_hT = _grads(1000, 20, 64, 5, card)
    out, _, saved = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh)
    first = cuda_gru.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh)
    second = cuda_gru.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh)
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gru_recurrence_function_on_card_matches_cpu(card):
    x_proj, h0, wh, bh = _inputs(40, 12, 32, 3, card)
    g, g_hT = _grads(40, 12, 32, 3, card)

    def grads(device):
        leaves = [t.detach().to(device).requires_grad_() for t in (x_proj, h0, wh, bh)]
        out, h_last = cuda_gru.GRURecurrence.apply(*leaves, True)
        loss = (out * g.to(device)).sum() + (h_last * g_hT.to(device)).sum()
        return [t.cpu() for t in torch.autograd.grad(loss, leaves)]

    for a, b in zip(grads(card), grads("cpu")):
        assert _rel(a, b) <= 1e-4


def test_zero_steps_returns_h0(card):
    x_proj, h0, wh, bh = _inputs(4, 0, 16, 0, card)
    out, h_last = cuda_gru.gru_recurrence(x_proj, h0, wh, bh)
    torch.cuda.synchronize()
    assert out.shape == (4, 0, 16)
    torch.testing.assert_close(h_last, h0, rtol=0, atol=0)
    out, h_last, saved = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh)
    torch.testing.assert_close(h_last, h0, rtol=0, atol=0)
    g, g_hT = _grads(4, 0, 16, 0, card)
    d_xp, dwh, dbh, dh0 = cuda_gru.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh)
    torch.cuda.synchronize()
    torch.testing.assert_close(dh0, g_hT, rtol=0, atol=0)
    assert not dwh.any() and not dbh.any()


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


def test_train_state_on_card_turns_tf32_off(card):
    """The port trains in float32: PyTorch runs cuDNN convolutions in TF32
    by default, and create_train_state turns that off on a card."""
    import dataclasses

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.train.state import create_train_state

    cfg = load_config(os.path.join(REPO, "config", "proc16k.json"))
    opt = dataclasses.replace(cfg.train.optimization, train_compute_dtype="")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))
    torch.backends.cudnn.allow_tf32 = True
    create_train_state(cfg, device=card)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
