"""The port's CUDA kernels on the card (marker `cuda`; skips without a card).

Run on a machine with an NVIDIA card and nvcc:
    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances, kernel against the plain PyTorch version on the same card:
- 1e-4 absolute on outputs, h_T, saved residuals, d_xp and dh0: float32 dot
  products of length H or 3H summed in another order, carried through up to
  a few hundred steps (chip_smoke.py measured <= 3e-7 for gru_fwd);
- 1e-4 relative to the largest entry, max|a - b| / max|b|, on dWh and dbh:
  sums over rows * T row-steps taken in another order (per split, then over
  the splits) than the plain version's step-by-step sum, and at H 64 and 128
  on the tensor cores as TF32 products with bf16 corrections (chip_smoke.py
  measured <= 1e-5).
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
@pytest.mark.parametrize("rows,steps,hidden,path", [
    (556, 16, 64, "registers"),   # flagship FGRU, 4 s clip, both directions
    (16, 300, 128, "registers"),  # flagship TGRU
    (556, 16, 256, "cluster"),    # large16k FGRU: clusters of 8 blocks
    (16, 300, 512, "cluster"),    # large16k TGRU: clusters of 16 blocks
    (133, 7, 128, "registers"),   # ragged: rows not a multiple of the tile, T odd
    (133, 5, 256, "cluster"),
    (19, 3, 512, "cluster"),
    (301, 9, 40, "general"),      # H not a multiple of 32, ragged row tile
    (16, 1, 128, "registers"),    # T = 1
    (16, 1, 512, "cluster"),
    (1, 9, 64, "registers"),      # rows = 1
    (1, 9, 256, "cluster"),
    (3, 1, 8, "general"),
    (16064, 16, 64, "registers"),  # evaluation at batch 64 of 2 s clips: several waves
    (1024, 251, 128, "registers"),
    (5000, 3, 64, "registers"),    # many rows: the most rows per tile
    (1200, 3, 64, "registers"),
    (600, 3, 128, "registers"),
    (30, 3, 256, "cluster"),
    (50, 3, 256, "cluster"),
    (5, 3, 512, "cluster"),
    (12, 3, 512, "cluster"),
    (30, 3, 512, "cluster"),
])
def test_kernel_matches_plain_version(card, rows, steps, hidden, path, reverse):
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    before = cuda_gru.launches
    out, h_last = cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.launches == before + 1
    assert cuda_gru.last_fwd_plan.path == path
    ref_out, ref_h = gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=ATOL)
    torch.testing.assert_close(h_last, ref_h, rtol=0, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden,rows_per_tile", [
    (hidden, r) for hidden, (_, _, tiles) in cuda_gru._RESIDENT.items() for r in tiles])
def test_every_resident_instantiation(card, hidden, rows_per_tile, reverse):
    """Every (H, rows per tile) the library builds, on a ragged last tile and
    over more tiles than one wave of clusters."""
    rows, steps = 20 * rows_per_tile + 1, 5
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, hidden + rows_per_tile, card)
    path = "cluster" if cuda_gru._RESIDENT[hidden][0] > 1 else "registers"
    out, h_last = cuda_gru._launch(x_proj, h0, wh, bh, reverse, plan=cuda_gru.FwdPlan(path, rows_per_tile))
    torch.cuda.synchronize()
    ref_out, ref_h = gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=ATOL)
    torch.testing.assert_close(h_last, ref_h, rtol=0, atol=ATOL)


@pytest.mark.parametrize("rows,steps,hidden", [(556, 16, 64), (16, 300, 128), (556, 16, 256), (16, 300, 512)])
def test_general_kernel_at_the_resident_sizes(card, rows, steps, hidden):
    """The general kernel still takes the sizes that `fwd_plan` sends elsewhere."""
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    plan = cuda_gru.FwdPlan("general", cuda_gru.rows_per_block(rows, hidden, 132))
    out, h_last = cuda_gru._launch(x_proj, h0, wh, bh, False, plan=plan)
    torch.cuda.synchronize()
    ref_out, ref_h = gru_ops.gru_recurrence(x_proj, h0, wh, bh)
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
    (1001, 13, 64),   # tensor cores: rows * T not a multiple of the chunk of 32
    (37, 11, 128),    # the same at H 128, two splits
    (5, 7, 64),       # rows * T smaller than one split (and than two chunks)
    (1, 1, 128),
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


@pytest.mark.parametrize("hidden", [64, 128])
def test_tensor_core_reduction_refuses_misaligned_tensors(card, hidden):
    """The tensor-core kernel copies 16 bytes at a time: a tensor off a
    16-byte boundary raises, it does not take another kernel."""
    rows, steps = 37, 11
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, 7, card)
    g, g_hT = _grads(rows, steps, hidden, 7, card)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh)
    d_xp = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh)[0]
    flat = torch.empty(out.numel() + 1, device=card)
    shifted = flat[1:].view_as(out).copy_(out)  # 4 bytes off a 16-byte boundary
    before = cuda_gru.dw_partial_launches
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        cuda_gru.dw_partial(shifted, h0, d_xp, saved)
    assert cuda_gru.dw_partial_launches == before
    cuda_gru.dw_partial(out, h0, d_xp, saved)
    assert cuda_gru.last_dw_plan[0] is True


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


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden,rows_per_tile", [
    (hidden, r) for hidden, (_, tiles, _) in cuda_gru._BWD_RESIDENT.items() for r in tiles])
def test_every_resident_bwd_instantiation(card, hidden, rows_per_tile, reverse):
    """Every (H, rows per tile) of the resident BPTT, on a ragged last tile,
    T odd, and more tiles than the blocks the card holds, so that blocks
    walk several tiles."""
    per_sm = cuda_gru._BWD_RESIDENT[hidden][0]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rows, steps = (per_sm * sms + 3) * rows_per_tile + 1, 5
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, hidden + rows_per_tile, card)
    g, g_hT = _grads(rows, steps, hidden, hidden + rows_per_tile, card)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    before = cuda_gru.bwd_launches
    d_xp, dh0 = cuda_gru._launch_bwd(g, g_hT, out, saved, h0, wh, reverse,
                                     plan=cuda_gru.BwdPlan("registers", rows_per_tile))
    torch.cuda.synchronize()
    assert cuda_gru.bwd_launches == before + 1
    want = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.testing.assert_close(d_xp, want[0], rtol=0, atol=ATOL)
    torch.testing.assert_close(dh0, want[3], rtol=0, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,steps,hidden,path", [
    (16064, 16, 64, "registers"),  # flagship training shapes at batch 64
    (1024, 251, 128, "registers"),
    (1001, 13, 64, "registers"),   # ragged rows and T
    (133, 7, 128, "registers"),
    (301, 9, 40, "general"),
    (16, 0, 64, "registers"),      # no step: dh0 = g_hT
])
def test_bwd_path_matches_plain_version(card, rows, steps, hidden, path, reverse):
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    g, g_hT = _grads(rows, steps, hidden, rows + steps, card)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    d_xp, dh0 = cuda_gru.bptt(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.last_bwd_plan.path == path
    want = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.testing.assert_close(d_xp, want[0], rtol=0, atol=ATOL)
    torch.testing.assert_close(dh0, want[3], rtol=0, atol=ATOL)


@pytest.mark.parametrize("splits,hidden", [
    (1, 33),    # one split; 3,366 entries, not a multiple of 4
    (5, 33),
    (1, 64),
    (260, 64),  # the flagship's splits
    (132, 128),
    (37, 8),
])
def test_dw_sum_matches_sum_and_is_bit_identical(card, splits, hidden):
    size = 3 * hidden * (hidden + 1)
    part = torch.from_numpy(np.random.default_rng(splits).standard_normal((splits, size)).astype(np.float32)).to(card)
    before = cuda_gru.dw_sum_launches
    first = torch.cat([t.reshape(-1) for t in cuda_gru.dw_sum(part, hidden)])
    second = torch.cat([t.reshape(-1) for t in cuda_gru.dw_sum(part, hidden)])
    torch.cuda.synchronize()
    assert cuda_gru.dw_sum_launches == before + 2
    assert torch.equal(first, second)
    assert _rel(first, part.sum(dim=0)) <= 1e-4


def test_dw_sum_refuses_misaligned_part_on_card(card):
    flat = torch.zeros(2 * 60 + 1, device=card)
    before = cuda_gru.dw_sum_launches
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        cuda_gru.dw_sum(flat[1:].view(2, 60), 4)
    assert cuda_gru.dw_sum_launches == before


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden,rows_per_tile", [
    (hidden, r) for hidden in cuda_gru._FWD_TRAIN_RESIDENT for r in cuda_gru._RESIDENT[hidden][2]])
def test_every_resident_fwd_train_instantiation(card, hidden, rows_per_tile, reverse):
    """Every (H, rows per tile) of the resident training forward, on a
    ragged last tile, T odd, and more tiles than the card holds blocks (H 64,
    128: blocks walk several tiles) or clusters (H 256, 512)."""
    cluster = cuda_gru._RESIDENT[hidden][0]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    tiles = 8 * sms + 3 if cluster == 1 else 20
    rows, steps = tiles * rows_per_tile + 1, 5
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, hidden + rows_per_tile, card)
    path = "cluster" if cluster > 1 else "registers"
    before = cuda_gru.fwd_train_launches
    got = cuda_gru._launch_fwd_train(x_proj, h0, wh, bh, reverse, plan=cuda_gru.FwdPlan(path, rows_per_tile))
    torch.cuda.synchronize()
    assert cuda_gru.fwd_train_launches == before + 1
    want = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    for a, b in zip(got, want):  # out, h_T, saved
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,steps,hidden,path", [
    (16064, 16, 64, "registers"),  # flagship training shapes at batch 64
    (1024, 251, 128, "registers"),
    (4016, 16, 256, "cluster"),    # large16k's at its batch of 16
    (256, 251, 512, "cluster"),
    (1001, 13, 64, "registers"),   # ragged rows and T
    (133, 7, 128, "registers"),
    (133, 5, 256, "cluster"),
    (19, 3, 512, "cluster"),
    (301, 9, 40, "general"),
    (1, 9, 64, "registers"),
    (16, 0, 64, "registers"),      # no step: h_T = h0
    (16, 0, 256, "cluster"),
])
def test_fwd_train_path_matches_plain_version(card, rows, steps, hidden, path, reverse):
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    got = cuda_gru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.last_fwd_train_plan.path == path
    want = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    for a, b in zip(got, want):  # out, h_T, saved
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)


# gru_fwd at the streaming path's launch shapes (rows x T x H): the
# flagship's FGRU and TGRU at one hop, at 4 hops a call and at 64 streams,
# large16k's at one hop
STREAMING_SHAPES = [
    (1, 16, 64, "registers"), (16, 1, 128, "registers"),
    (4, 16, 64, "registers"), (16, 4, 128, "registers"),
    (64, 16, 64, "registers"), (1024, 1, 128, "registers"),
    (1, 16, 256, "cluster"), (16, 1, 512, "cluster"),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,steps,hidden,path", STREAMING_SHAPES)
def test_kernel_at_streaming_shapes(card, rows, steps, hidden, path, reverse):
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, 7 * rows + steps, card)
    before = cuda_gru.launch_counts()
    out, h_last = cuda_gru.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    after = cuda_gru.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**{k: 0 for k in after}, "gru_fwd": 1}
    assert cuda_gru.last_fwd_plan.path == path
    ref_out, ref_h = gru_ops.gru_recurrence(x_proj, h0, wh, bh, reverse=reverse)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=ATOL)
    torch.testing.assert_close(h_last, ref_h, rtol=0, atol=ATOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_eval_mode_gru_on_card_keeps_its_gradients(card, bidirectional):
    """An eval-mode GRU on the card takes the trainable recurrence where a
    gradient is wanted: the gradients of the input, wi and wh equal the
    CPU's to 1e-4 relative to the largest entry (dWh summed on the tensor
    cores, as in training). Under inference_mode it launches gru_fwd only."""
    import copy

    from tinyrecurrentunet_torch.models.blocks import GRU, init_parameters

    gru_cpu = init_parameters(GRU(24, 64, bidirectional=bidirectional), torch.Generator().manual_seed(0)).eval()
    gru_card = copy.deepcopy(gru_cpu).to(card)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 16, 24)).astype(np.float32)
    g = rng.standard_normal((40, 16, 64 * (2 if bidirectional else 1))).astype(np.float32)

    def grads(gru, device):
        xt = torch.from_numpy(x).to(device).requires_grad_()
        out, h = gru(xt)
        loss = (out * torch.from_numpy(g).to(device)).sum() + h.sum()
        return [t.cpu() for t in torch.autograd.grad(loss, [xt, gru.wi_fwd, gru.wh_fwd])]

    dirs = 2 if bidirectional else 1
    before = cuda_gru.launch_counts()
    got = grads(gru_card, card)
    torch.cuda.synchronize()
    after = cuda_gru.launch_counts()
    assert after["gru_fwd_train"] - before["gru_fwd_train"] == dirs
    assert after["gru_bwd"] - before["gru_bwd"] == dirs
    assert after["gru_fwd"] == before["gru_fwd"]
    for a, b in zip(got, grads(gru_cpu, "cpu")):
        assert _rel(a, b) <= 1e-4
    before = cuda_gru.launch_counts()
    with torch.inference_mode():
        gru_card(torch.from_numpy(x).to(card))
    after = cuda_gru.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**{k: 0 for k in after}, "gru_fwd": dirs}


def _tiny_streaming():
    import dataclasses

    from tinyrecurrentunet_torch.config import Config, FeaturizerConfig, NetworkConfig
    from tinyrecurrentunet_torch.infer.denoise import random_state_dict

    tiny = dict(encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)), fgru_hidden=64, fgru_out=8,
                tgru_hidden=128, tgru_out=8, decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)))
    cfg = dataclasses.replace(Config(), featurizer=FeaturizerConfig(sample_rate=16000),
                              network=NetworkConfig(**tiny))
    audio = (0.2 * np.sin(2 * np.pi * 220 * np.arange(8000) / 16000)
             + 0.05 * np.random.default_rng(0).standard_normal(8000)).astype(np.float32)
    return cfg, random_state_dict(cfg), audio


def test_streaming_step_launches_three_gru_fwd(card):
    """One hop (and one call of 4 hops) of the streaming step launches
    gru_fwd three times (FGRU forward and reverse, TGRU) and nothing else."""
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser

    cfg, sd, audio = _tiny_streaming()
    for chunk in (1, 4):
        den = StreamingDenoiser(cfg, sd, chunk_frames=chunk, device=card)
        state = den.init_state()
        den.process_block(state, audio[: den.hop])  # build the kernels first
        cuda_gru.reset_launch_counts()
        out, state = den.process_block(state, audio[den.hop : 2 * den.hop])
        torch.cuda.synchronize()
        assert cuda_gru.launch_counts() == {**{k: 0 for k in cuda_gru.launch_counts()}, "gru_fwd": 3}
        assert out.device.type == "cuda" and out.shape == (den.hop,)


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_streaming_on_card_matches_cpu(card, chunk_frames):
    """Card against CPU at 2e-4 (chip_smoke.py's DENOISE_ATOL: cuFFT and the
    CPU FFT differ in the last bit, which the unwrapped phase carries into
    the demod features)."""
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser

    cfg, sd, audio = _tiny_streaming()
    got, _ = StreamingDenoiser(cfg, sd, chunk_frames=chunk_frames, device=card).process(audio)
    want, _ = StreamingDenoiser(cfg, sd, chunk_frames=chunk_frames, device="cpu").process(audio)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_multistream_on_card_matches_cpu_and_single_streams(card):
    """Card against CPU at 2e-4 (as above); each stream of the batch against
    its own single-stream run on the card at 2e-4: cuDNN may take another
    convolution algorithm at another batch size (chip_smoke.py measured
    1.3e-6 at the flagship's width, 64 streams)."""
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser

    cfg, sd, audio = _tiny_streaming()
    streams = np.stack([audio[:4096], audio[-4096:], np.zeros(4096, np.float32)])
    got, _ = MultiStreamDenoiser(cfg, sd, 3, chunk_frames=2, device=card).process(streams)
    want, _ = MultiStreamDenoiser(cfg, sd, 3, chunk_frames=2, device="cpu").process(streams)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    single = StreamingDenoiser(cfg, sd, chunk_frames=2, device=card)
    for i in range(3):
        np.testing.assert_allclose(got[i], single.process(streams[i])[0], rtol=0, atol=2e-4)
