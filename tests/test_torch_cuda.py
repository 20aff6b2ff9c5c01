"""The port's CUDA kernels on the card (marker `cuda`; skips without a card).

Run on a machine with an NVIDIA card and nvcc:
    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances, kernel against the plain PyTorch version on the same card:
- 1e-4 absolute on outputs, h_T, saved residuals, d_xp and dh0: float32 dot
  products of length H or 3H summed in another order, carried through up to
  a few hundred steps (chip_smoke.py measured <= 3e-7 for gru_fwd);
- 1e-4 relative to the largest entry, max|a - b| / max|b|, on dWh and dbh:
  sums over rows * T row-steps taken in another order (per split, then over
  the splits) than the plain version's step-by-step sum, and at H 64, 128,
  256 and 512 on the tensor cores as TF32 products with bf16 corrections
  (chip_smoke.py measured <= 1e-5).
"""

import os

import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.ops import gru as gru_ops
from tinyrecurrentunet_torch.utils import graphs

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
    (133, 5, 256),    # the cluster BPTT and the tensor cores at a large16k width
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


@pytest.mark.parametrize("hidden", [64, 128, 256, 512])
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
    assert cuda_gru.last_dw_plan.path == "tensor_cores"


@pytest.mark.parametrize("rows,steps,hidden", [(1000, 20, 64), (301, 13, 256), (37, 25, 512)])
def test_weight_gradient_is_deterministic(card, rows, steps, hidden):
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, 5, card)
    g, g_hT = _grads(rows, steps, hidden, 5, card)
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


def _only_gru_fwd(n):
    return {**{k: 0 for k in cuda_gru.launch_counts()}, "gru_fwd": n}


def test_denoise_on_card_matches_cpu_with_three_launches(card):
    """The first call of a bucket runs the body graphs.WARMUP times eagerly and
    captures it (3 gru_fwd a run, the captured run's counted at the replay);
    a warmed call replays the graph: 3 gru_fwd and nothing else."""
    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cfg = load_config(os.path.join(REPO, "config", "proc16k.json"))
    artifact = os.path.join(REPO, "artifacts", "TRUNet-proc")
    clip = (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32)
    den = Denoiser.from_pretrained(cfg, artifact, device="cuda")
    cuda_gru.reset_launch_counts()
    first = den(clip)
    assert cuda_gru.launch_counts() == _only_gru_fwd(3 * (graphs.WARMUP + 1))
    cuda_gru.reset_launch_counts()
    out = den(clip)
    assert cuda_gru.launch_counts() == _only_gru_fwd(3)
    np.testing.assert_array_equal(out, first)
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
@pytest.mark.parametrize("hidden,rows_per_tile", [
    (hidden, r) for hidden, (_, tiles) in cuda_gru._BWD_CLUSTER.items() for r in tiles])
def test_every_cluster_bwd_instantiation(card, hidden, rows_per_tile, reverse):
    """Every (H, rows per tile) of the cluster BPTT, on a ragged last tile,
    T odd, and more tiles than the clusters the card holds, so that clusters
    walk several tiles."""
    clusters = cuda_gru._bwd_max_clusters(card, hidden)
    rows, steps = (clusters + 3) * rows_per_tile + 1, 5
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, hidden + rows_per_tile, card)
    g, g_hT = _grads(rows, steps, hidden, hidden + rows_per_tile, card)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    d_xp, dh0 = cuda_gru._launch_bwd(g, g_hT, out, saved, h0, wh, reverse,
                                     plan=cuda_gru.BwdPlan("cluster", rows_per_tile))
    torch.cuda.synchronize()
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
    (4016, 16, 256, "cluster"),    # large16k training shapes at batch 16
    (256, 251, 512, "cluster"),
    (133, 5, 256, "cluster"),      # ragged rows and T
    (19, 3, 512, "cluster"),
    (16, 0, 512, "cluster"),
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


def _long_audio(samples, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    return (0.2 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(samples)).astype(np.float32)


@pytest.mark.parametrize("chunk_frames,streams", [(1, 1), (2, 1), (4, 1), (1, 16)])
def test_replayed_graph_equals_the_uncaptured_body(card, chunk_frames, streams):
    """200 calls from one start: the captured step replayed against the same
    body run eagerly (`_process(..., replay=False)`) by a second denoiser,
    within 1e-6 (the same kernels in the same order: 0 expected)."""
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser

    cfg, sd, _ = _tiny_streaming()

    def make():
        if streams == 1:
            return StreamingDenoiser(cfg, sd, chunk_frames=chunk_frames, device=card)
        return MultiStreamDenoiser(cfg, sd, streams, chunk_frames=chunk_frames, device=card)

    graph, body = make(), make()
    calls = 200
    audio = np.stack([_long_audio(calls * graph.hop, seed) for seed in range(streams)])
    if streams == 1:
        audio = audio[0]
    state_g, state_b, err = graph.init_state(), body.init_state(), 0.0
    for i in range(calls):
        blocks = audio[..., i * graph.hop : (i + 1) * graph.hop]
        out_g, state_g = graph.process_block(state_g, blocks)
        out_b, state_b = body._process(state_b, blocks, replay=False)
        err = max(err, float((out_g - out_b).abs().max()))
    assert graph._captures == 1 and body._captures == 0
    assert err <= 1e-6
    for a, b in zip((state_g.in_buffer, *state_g.feat_state, state_g.tgru_h, state_g.ola_buffer),
                    (state_b.in_buffer, *state_b.feat_state, state_b.tgru_h, state_b.ola_buffer)):
        assert float((a.float() - b.float()).abs().max()) <= 1e-6


def test_denoiser_captures_once_then_replays(card):
    """The first call captures; every later call, whatever state it is
    given, replays the same graph and counts its 3 gru_fwd."""
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser

    cfg, sd, audio = _tiny_streaming()
    for den in (StreamingDenoiser(cfg, sd, device=card), MultiStreamDenoiser(cfg, sd, 3, device=card)):
        block = np.zeros(den._block_shape, np.float32)
        state = den.process_block(den.init_state(), block)[1]
        graph = den._graph
        cuda_gru.reset_launch_counts()
        for i in range(5):
            state = den.process_block(state if i != 2 else den.init_state(), block)[1]
        torch.cuda.synchronize()
        assert den._graph is graph and den._captures == 1
        assert cuda_gru.launch_counts() == {**{k: 0 for k in cuda_gru.launch_counts()}, "gru_fwd": 15}


def test_a_failure_inside_capture_propagates(card, monkeypatch):
    """No eager fallback: a wrapper that fails while the graph is captured
    (after the warm-up ran it eagerly) fails process_block."""
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser

    cfg, sd, audio = _tiny_streaming()
    den = StreamingDenoiser(cfg, sd, device=card)
    plain = cuda_gru.gru_recurrence

    def failing(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("forced failure inside capture")
        return plain(*args, **kwargs)

    monkeypatch.setattr(cuda_gru, "gru_recurrence", failing)
    with pytest.raises(RuntimeError, match="forced failure inside capture"):
        den.process_block(den.init_state(), audio[: den.hop])
    assert den._graph is None


def _bf16_gru_grads(gru, device, x, h0, g, g_h):
    xt = torch.from_numpy(x).to(device, torch.bfloat16).requires_grad_()
    ht = torch.from_numpy(h0).to(device, torch.bfloat16).requires_grad_()
    out, h = gru(xt, ht)
    loss = (out.float() * torch.from_numpy(g).to(device)).sum() + (h.float() * torch.from_numpy(g_h).to(device)).sum()
    params = [p for _, p in sorted(gru.named_parameters())]
    grads = torch.autograd.grad(loss, [xt, ht, *params])
    return [t.detach().float().cpu() for t in (out, h, *grads)]


@pytest.mark.parametrize("bidirectional", [False, True])
def test_bf16_gru_on_card_matches_cpu(card, bidirectional):
    """A bf16 GRU layer (the Pallas kernels' edges: bf16 projection, float32
    recurrence on the float32 kernels) on the card against the CPU: outputs,
    h_T and the gradients of x, h0 and every weight and bias within 2^-6 of
    the largest entry, four bf16 steps (the card's products round in
    another order, and dWh is summed on the tensor cores). It launches the
    training kernels once a direction."""
    import copy

    from tinyrecurrentunet_torch.models.blocks import GRU, init_parameters

    gru_cpu = init_parameters(GRU(24, 64, bidirectional=bidirectional, dtype=torch.bfloat16),
                              torch.Generator().manual_seed(0))
    gru_card = copy.deepcopy(gru_cpu).to(card)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 16, 24)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((40, 64))).astype(np.float32)
    g = rng.standard_normal((40, 16, 64 * (2 if bidirectional else 1))).astype(np.float32)
    g_h = rng.standard_normal((40, 64)).astype(np.float32)
    before = cuda_gru.launch_counts()
    got = _bf16_gru_grads(gru_card, card, x, h0, g, g_h)
    torch.cuda.synchronize()
    after = cuda_gru.launch_counts()
    dirs = 2 if bidirectional else 1
    assert after["gru_fwd_train"] - before["gru_fwd_train"] == dirs
    assert after["gru_bwd"] - before["gru_bwd"] == dirs
    want = _bf16_gru_grads(gru_cpu, "cpu", x, h0, g, g_h)
    assert len(got) == 2 + 2 + 4 * dirs
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2.0**-6


def test_bf16_denoise_on_card_against_float32(card):
    """The flagship served in bf16 (network.compute_dtype) on the card: three
    gru_fwd launches a call, the waveform at least 30 dB above its distance
    to the float32 call's and to the CPU's bf16 call (on the CPU bf16 lies
    41.4 dB from float32, and 49 dB from itself on an input moved by 1e-6),
    its SI-SDR against the clean speech within 0.1 dB of float32's."""
    import dataclasses

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.data import procgen
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.infer.metrics import si_sdr

    cfg = load_config(os.path.join(REPO, "config", "proc16k.json"))
    bf16 = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, compute_dtype="bfloat16"))
    artifact = os.path.join(REPO, "artifacts", "TRUNet-proc")
    rng = np.random.default_rng(0)
    clean = procgen.synth_speech(rng, 16000, 16000)
    clip = procgen.mix_at_snr(clean, procgen.synth_noise(rng, 16000, 16000, "babble"), 5.0).astype(np.float32)
    den = Denoiser.from_pretrained(bf16, artifact, device="cuda")
    assert den.model.compute_dtype == torch.bfloat16
    den(clip)  # captures the bucket's graph
    before = cuda_gru.launch_counts()
    out = den(clip)
    after = cuda_gru.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**{k: 0 for k in after}, "gru_fwd": 3}
    f32 = Denoiser.from_pretrained(cfg, artifact, device="cuda")(clip)
    cpu = Denoiser.from_pretrained(bf16, artifact, device="cpu")(clip)

    def snr_db(ref, est):
        return 10 * np.log10(np.sum(ref.astype(np.float64) ** 2) / np.sum((ref - est).astype(np.float64) ** 2))

    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert snr_db(f32, out) >= 30 and snr_db(cpu, out) >= 30
    assert abs(si_sdr(out, clean) - si_sdr(f32, clean)) <= 0.1


@pytest.mark.parametrize("value", ["never", "always", "auto"])
def test_use_pallas_gru_routes_by_launch_counts(card, value):
    """network.use_pallas_gru on the card: "never" launches none of the five
    kernels in a forward and backward and in an inference call; "always" and
    "auto" launch 3 of each training kernel and 3 gru_fwd. The outputs and
    the gradient of the input (eval mode: BatchNorm on its running
    statistics) agree with the CPU's to 1e-4 (relative to the largest entry
    for the gradient)."""
    import dataclasses

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.models import TRUNet
    from tinyrecurrentunet_torch.models.blocks import init_parameters

    cfg = load_config(os.path.join(REPO, "config", "proc16k.json"))
    net = dataclasses.replace(cfg.network, use_pallas_gru=value)
    model_cpu = init_parameters(TRUNet(net), torch.Generator().manual_seed(0)).eval()
    model_card = TRUNet(net, device=card).eval()
    model_card.load_state_dict(model_cpu.state_dict())
    x = (np.random.default_rng(4).standard_normal((2, 20, 257, 4)) * 0.5).astype(np.float32)

    def run(model, device):
        xt = torch.from_numpy(x).to(device).requires_grad_()
        y, _ = model(xt)
        (grad,) = torch.autograd.grad(y.square().sum(), [xt])
        return y.detach().cpu(), grad.cpu()

    cuda_gru.reset_launch_counts()
    y, grad = run(model_card, card)
    torch.cuda.synchronize()
    train_counts = cuda_gru.launch_counts()
    cuda_gru.reset_launch_counts()
    with torch.inference_mode():
        model_card(torch.from_numpy(x).to(card))
    torch.cuda.synchronize()
    infer_counts = cuda_gru.launch_counts()
    if value == "never":
        assert set(train_counts.values()) == set(infer_counts.values()) == {0}
    else:
        assert train_counts == {"gru_fwd": 0, "gru_fwd_train": 3, "gru_bwd": 3, "gru_dw_partial": 3, "gru_dw_sum": 3}
        assert infer_counts == {**{k: 0 for k in infer_counts}, "gru_fwd": 3}
    y_cpu, grad_cpu = run(model_cpu, "cpu")
    assert (y - y_cpu).abs().max().item() <= ATOL
    assert _rel(grad, grad_cpu) <= 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,steps,hidden,splits", [
    (37, 11, 256, None),  # large16k's FGRU width: rows not a multiple of the 8-row block, T odd
    (13, 9, 512, None),   # its TGRU width: 2 rows a block, a ragged last block
    (37, 11, 256, 3),     # the reduction over more splits than the plan gives
    (13, 9, 512, 2),
])
def test_general_bptt_and_simt_reduction_at_large16k_widths(card, rows, steps, hidden, splits, reverse):
    """The kernels large16k's training took before the cluster BPTT and the
    tensor cores, through forced plans: the general `gru_bwd`, the SIMT
    `gru_dw_partial` and `gru_dw_sum` at H 256 and 512, against the plain
    versions; the launches by path."""
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    g, g_hT = _grads(rows, steps, hidden, rows + steps, card)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    want = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    cuda_gru.reset_launch_counts()
    general = cuda_gru.BwdPlan("general", cuda_gru.rows_per_block(rows, hidden, cuda_gru._num_sms(card)))
    d_xp, dh0 = cuda_gru._launch_bwd(g, g_hT, out, saved, h0, wh, reverse, plan=general)
    if splits is None:
        plan = cuda_gru.DwPlan("simt", *cuda_gru.dw_splits(rows * steps, hidden, cuda_gru._num_sms(card), "simt"))
    else:
        plan = cuda_gru.DwPlan("simt", splits, -(-rows * steps // splits))
    part = cuda_gru._launch_dw(out, h0, want[0], saved, reverse, plan=plan)
    dwh, dbh = cuda_gru.dw_sum(part, hidden)
    torch.cuda.synchronize()
    assert cuda_gru.last_bwd_plan == general
    assert cuda_gru.launch_paths() == {"gru_bwd": {"general": 1}, "gru_dw_partial": {"simt": 1},
                                       "gru_dw_sum": {"sum": 1}}
    torch.testing.assert_close(d_xp, want[0], rtol=0, atol=ATOL)
    torch.testing.assert_close(dh0, want[3], rtol=0, atol=ATOL)
    assert _rel(dwh, want[1]) <= 1e-4
    assert _rel(dbh, want[2]) <= 1e-4


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,steps,hidden", [
    (4016, 16, 256),  # large16k's FGRU at batch 16
    (256, 251, 512),  # its TGRU
    (37, 11, 256),    # ragged: rows not a multiple of the row tile, T odd
    (13, 9, 512),
    (1, 1, 256),
])
def test_cluster_bptt_and_tensor_core_reduction_at_large16k_widths(card, rows, steps, hidden, reverse):
    """The paths large16k's training takes: the cluster `gru_bwd` and the
    tensor-core `gru_dw_partial` (with `gru_dw_sum`) at H 256 and 512,
    against the plain versions, twice with the same bits; the launches by
    path."""
    x_proj, h0, wh, bh = _inputs(rows, steps, hidden, rows + steps, card)
    g, g_hT = _grads(rows, steps, hidden, rows + steps, card)
    out, _, saved = gru_ops.gru_recurrence_train(x_proj, h0, wh, bh, reverse=reverse)
    want = gru_ops.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    cuda_gru.reset_launch_counts()
    got = cuda_gru.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.last_bwd_plan.path == "cluster" and cuda_gru.last_dw_plan.path == "tensor_cores"
    assert cuda_gru.launch_paths() == {"gru_bwd": {"cluster": 1}, "gru_dw_partial": {"tensor_cores": 1},
                                       "gru_dw_sum": {"sum": 1}}
    d_xp, dwh, dbh, dh0 = got
    torch.testing.assert_close(d_xp, want[0], rtol=0, atol=ATOL)
    torch.testing.assert_close(dh0, want[3], rtol=0, atol=ATOL)
    assert _rel(dwh, want[1]) <= 1e-4
    assert _rel(dbh, want[2]) <= 1e-4
    again = cuda_gru.gru_recurrence_bwd(g, g_hT, out, saved, h0, wh, reverse=reverse)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config,artifact,path", [
    ("large16k", "TRUNet-large", "cluster"),
    ("proc48k", "TRUNet-proc48", "registers"),
])
def test_shipped_model_denoises_on_card_as_on_cpu(card, config, artifact, path):
    """The two other shipped models with their committed weights: 1 s at the
    config's rate on the card against the CPU at 2e-4 (chip_smoke.py's
    DENOISE_ATOL), 3 gru_fwd a replayed call on the path the hidden sizes
    take (3 a run of the first call's warm-up and capture)."""
    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cfg = load_config(os.path.join(REPO, "config", f"{config}.json"))
    directory = os.path.join(REPO, "artifacts", artifact)
    sr = cfg.featurizer.sample_rate
    t = np.arange(sr) / sr
    clip = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.random.default_rng(0).standard_normal(sr)).astype(np.float32)
    den = Denoiser.from_pretrained(cfg, directory, device="cuda")
    cuda_gru.reset_launch_counts()
    den(clip)
    assert cuda_gru.launch_paths() == {"gru_fwd": {path: 3 * (graphs.WARMUP + 1)}}
    cuda_gru.reset_launch_counts()
    out = den(clip)
    assert cuda_gru.launch_paths() == {"gru_fwd": {path: 3}}
    ref = Denoiser.from_pretrained(cfg, directory, device="cpu")(clip)
    assert np.isfinite(out).all() and out.shape == clip.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)


def _padded_body(den, clip):
    """The body `Denoiser.run`, eager, on the clip padded to its bucket."""
    bucket = den._bucket(len(clip), den.cfg.featurizer.hop_length)
    audio = torch.from_numpy(np.pad(clip, (0, bucket - len(clip)))).to(den.device)
    return den.run(audio).cpu().numpy()[: len(clip)]


@pytest.mark.parametrize("config,artifact,compute_dtype", [
    ("proc16k", "TRUNet-proc", None),
    ("proc16k", "TRUNet-proc", "bfloat16"),
    ("large16k", "TRUNet-large", None),  # gru_fwd on "cluster" at T = 556 inside the capture
    ("proc48k", "TRUNet-proc48", None),
])
def test_replayed_denoise_equals_the_body(card, config, artifact, compute_dtype):
    """Two buckets called A, B, A, B (their graphs share one memory pool):
    every replayed call against the eager body on the same padded input
    within 1e-6 (the same kernels in the same order: 0 expected); one
    capture a bucket."""
    import dataclasses

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cfg = load_config(os.path.join(REPO, "config", f"{config}.json"))
    if compute_dtype:
        cfg = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, compute_dtype=compute_dtype))
    den = Denoiser.from_pretrained(cfg, os.path.join(REPO, "artifacts", artifact), device=card)
    sr = cfg.featurizer.sample_rate
    clips = [_long_audio(sr, 0), _long_audio(sr // 3, 1), _long_audio(sr - 300, 2), _long_audio(sr // 3 + 5, 3)]
    hop = cfg.featurizer.hop_length
    assert den._bucket(len(clips[0]), hop) == den._bucket(len(clips[2]), hop)
    assert den._bucket(len(clips[1]), hop) == den._bucket(len(clips[3]), hop) != den._bucket(len(clips[0]), hop)
    for clip in clips:
        got = den(clip)
        assert got.shape == clip.shape and np.isfinite(got).all()
        assert float(np.abs(got - _padded_body(den, clip)).max()) <= 1e-6
    assert den._captures == 2 and len(den._slots) == 2


def test_denoise_captures_once_per_bucket_then_replays(card):
    """One capture a bucket; then each call replays its bucket's graph and
    counts its 3 gru_fwd, and nothing else; the body uncaptured
    (`_denoise(..., replay=False)`) gives the same waveform."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cfg, sd, audio = _tiny_streaming()
    den = Denoiser(cfg, sd, device=card)
    clips = (audio, audio[:3000])
    for clip in clips:
        den(clip)
    captured = {b: slot.graph for b, slot in den._slots.items()}
    assert den._captures == 2 and all(g is not None for g in captured.values())
    cuda_gru.reset_launch_counts()
    outs = [den(clips[i % 2]) for i in range(6)]
    torch.cuda.synchronize()
    assert cuda_gru.launch_counts() == _only_gru_fwd(18)
    assert den._captures == 2 and {b: slot.graph for b, slot in den._slots.items()} == captured
    for i, out in enumerate(outs):
        assert float(np.abs(out - den._denoise(clips[i % 2], replay=False)).max()) <= 1e-6


def test_recorder_times_each_denoise_and_stream_call_on_the_card(card):
    """Every call has its device interval, mapped onto the host clock after
    its staging began and before the next call began (the host waited for
    its output between them; a denoise call waits for it itself), to the
    clock fit's tens of microseconds; a bucket's first call holds the
    capture's spans."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.utils import profiling

    cfg, sd, audio = _tiny_streaming()
    profiling.reset()
    den = Denoiser(cfg, sd, device=card)
    for i in range(8):
        den(audio if i % 2 else audio[:3000])
    streams = MultiStreamDenoiser(cfg, sd, 3, device=card)
    state = streams.init_state()
    for _ in range(8):
        out, state = streams.process_block(state, np.zeros(streams._block_shape, np.float32))
        out.cpu()
    slack = 50_000  # ns
    calls = profiling.calls()
    assert [c.name for c in calls] == ["trunet.denoise.call"] * 8 + ["trunet.stream.call"] * 8
    for before, call, after in zip([None, *calls], calls, [*calls[1:], None]):
        lo, hi = call.device
        stage = next(s for s in call.spans if s.name.endswith(".stage"))
        assert stage.start - slack <= lo < hi
        assert hi <= (call.end if call.name == "trunet.denoise.call" else after.start if after else hi) + slack
        assert before is None or before.device[1] - slack <= lo
    for call in calls[:2] + calls[8:9]:
        graph = [s.name for s in call.spans].index("trunet.graph.capture")
        assert call.spans[graph].parent == 0  # opened in the call itself
        assert not any(s.parent == graph for s in call.spans)  # the capture span has no children
    assert len(profiling.spans("trunet.graph.capture")) == 3
    assert not any(s.name.endswith(".capture") for c in calls[2:8] + calls[9:] for s in c.spans)
    profiling.reset()


def test_recorder_reads_its_events_only_when_the_ring_is_read(card, monkeypatch):
    """A ring of 8 calls: 20 stream calls take every pair of the pool again
    and read no event; the last 8 keep their device intervals, in order,
    read when the ring is."""
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.utils import profiling

    class Counted:
        """A pool event that counts the times read from it."""

        def __init__(self, event):
            self.event = event

        def record(self, stream):
            self.event.record(stream)

        def elapsed_time(self, other):
            reads.append(1)
            return self.event.elapsed_time(other.event)

    reads = []
    rec = profiling.Recorder(calls=8, spans=128)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    cfg, sd, _ = _tiny_streaming()
    streams = MultiStreamDenoiser(cfg, sd, 3, device=card)
    state = streams.init_state()
    for i in range(20):
        out, state = streams.process_block(state, np.zeros(streams._block_shape, np.float32))
        out.cpu()
        if i == 0:  # the pool is made
            rec._events = tuple([Counted(e) for e in events] for events in rec._events)
    assert reads == []
    calls = profiling.calls("trunet.stream.call", last=8)
    assert len(reads) == 1 + 2 * 7 and [c.id for c in calls] == list(range(12, 20))
    assert all(lo < hi for lo, hi in (c.device for c in calls))
    assert all(a.device[1] <= b.device[0] + 50_000 for a, b in zip(calls, calls[1:]))


def test_no_timing_event_is_recorded_inside_a_capture(card):
    """A device interval asked for while the stream captures is not taken:
    the capture succeeds and the call has none."""
    from tinyrecurrentunet_torch.utils import profiling

    profiling.reset()
    x = torch.ones(16, device=card)
    graph = torch.cuda.CUDAGraph()
    with profiling.span("call"):
        with torch.cuda.graph(graph):
            profiling.device_begin()
            y = x * 2
            profiling.device_end()
    graph.replay()
    with profiling.span("call"):
        profiling.device_begin()
        graph.replay()
        profiling.device_end()
    torch.cuda.synchronize()
    assert float(y.sum()) == 32
    assert [c.device is None for c in profiling.calls()] == [True, False]
    profiling.reset()


def test_a_failure_inside_denoise_capture_propagates(card, monkeypatch):
    """No eager fallback: a wrapper that fails while the bucket's graph is
    captured (after the warm-up ran it eagerly) fails the call and leaves
    no graph in the slot."""
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cfg, sd, audio = _tiny_streaming()
    den = Denoiser(cfg, sd, device=card)
    plain = cuda_gru.gru_recurrence

    def failing(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("forced failure inside capture")
        return plain(*args, **kwargs)

    monkeypatch.setattr(cuda_gru, "gru_recurrence", failing)
    with pytest.raises(RuntimeError, match="forced failure inside capture"):
        den(audio)
    assert den._captures == 0 and [slot.graph for slot in den._slots.values()] == [None]


# ------------------------------------------------------ the train step's graph
# (tinyrecurrentunet_torch/train/step.py: one CUDA graph a batch shape)

STEP_LOSS_RTOL = 1e-6  # each loss term, graph vs body: the same kernels on the same buffers
STEP_NORM_RTOL = 1e-5  # grad_norm, graph vs body
PARAM_ATOL = 1e-6  # parameters where both gradients are clear of 0 and of one sign (chip_smoke.py)


def _tiny_training(with_carry: bool, batch: int = 4):
    """The streaming tests' network (FGRU H 64, TGRU H 128: the kernels'
    register paths) trained on 0.5 s clips; with the carry, in two TBPTT
    segments of 0.25 s."""
    import dataclasses

    from tinyrecurrentunet_torch.config import OptimizationConfig, TrainConfig, TrainsetConfig
    from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset

    cfg, _, _ = _tiny_streaming()
    cfg = dataclasses.replace(
        cfg, trainset=TrainsetConfig(sample_rate=16000, crop_length_sec=0.5),
        train=TrainConfig(optimization=OptimizationConfig(batch_size_per_device=batch, n_iters=100,
                                                          tbptt_segment_sec=0.25 if with_carry else 0.0)))
    ds = SyntheticPairDataset(num_items=batch, length_sec=0.5, sample_rate=16000)
    items = [ds.get(i) for i in range(batch)]
    clean, noisy = (torch.from_numpy(np.stack([x[k] for x in items])).cuda() for k in (0, 1))
    if with_carry:
        clean, noisy = clean[:, :4000].contiguous(), noisy[:, :4000].contiguous()
    return cfg, clean, noisy


def _train_kernels(n):
    return {**{k: n for k in cuda_gru.launch_counts()}, "gru_fwd": 0}


def _step_report(a, b, metrics_a, metrics_b, lr0) -> dict:
    ga = torch.cat([p.grad.reshape(-1).double() for p in a.model.parameters()])
    gb = torch.cat([p.grad.reshape(-1).double() for p in b.model.parameters()])
    pa = torch.cat([p.detach().reshape(-1).double() for p in a.model.parameters()])
    pb = torch.cat([p.detach().reshape(-1).double() for p in b.model.parameters()])
    exact = (torch.minimum(ga.abs(), gb.abs()) >= 1e-5) & (ga.sign() == gb.sign())
    return {
        "loss": max(abs(float(metrics_a[k]) - float(metrics_b[k])) / abs(float(metrics_b[k]))
                    for k in metrics_b if k != "grad_norm"),
        "grad_norm": abs(float(metrics_a["grad_norm"]) - float(metrics_b["grad_norm"])) / float(metrics_b["grad_norm"]),
        "exact_share": float(exact.double().mean()),
        "param_exact": float((pa - pb).abs()[exact].max()) if exact.any() else 0.0,
        "param": float((pa - pb).abs().max()),
        "stats": max(float((x - y).abs().max()) for x, y in zip(a.model.buffers(), b.model.buffers())),
        "lr0": lr0,
    }


@pytest.mark.parametrize("with_carry", [False, True], ids=["whole_clip", "tbptt_carry"])
def test_replayed_train_step_equals_the_body(card, with_carry, monkeypatch):
    """One state trained by the slot's graph, one by the same body
    uncaptured (`replay=False`), a third by the body again (the body's own
    spread, printed), 3 steps from the same weights on the same batch, under
    torch.backends.cudnn.deterministic: cuDNN's float32 weight gradients may
    differ run to run in its default setting (chip_smoke.py holds the
    flagship's step there), and graph and body would then differ for no
    fault of the graph's. The capturing call launches 12 of each training
    kernel (3 warm-ups and the replay), a replayed call 3; the first step's
    metrics are not overwritten by later replays. Loss terms within 1e-6
    relative and grad_norm within 1e-5; parameters after the first step
    within 1e-6 where both gradients are clear of 0 and of one sign (0.61
    of them at this width, measured), within 2 lr(0) elsewhere; the carry
    within 1e-6."""
    from tinyrecurrentunet_torch.train.state import create_train_state, make_schedule
    from tinyrecurrentunet_torch.train.step import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg, clean, noisy = _tiny_training(with_carry)
    lr0 = make_schedule(cfg)(0)
    states = [create_train_state(cfg, device=card) for _ in range(3)]
    steps = [make_train_step(cfg, with_carry=with_carry) for _ in range(3)]
    h0 = [states[0].model.init_tgru_state(clean.shape[0], cfg.featurizer.num_freqs, card) + 0.1
          for _ in range(3)] if with_carry else [None] * 3
    first = None
    for i in range(3):
        cuda_gru.reset_launch_counts()
        outs = [steps[0](states[0], clean, noisy, *([h0[0]] if with_carry else []))]
        torch.cuda.synchronize()
        assert cuda_gru.launch_counts() == _train_kernels(12 if i == 0 else 3)
        outs += [steps[k](states[k], clean, noisy, *([h0[k]] if with_carry else []), replay=False)
                 for k in (1, 2)]
        if with_carry:
            h0 = [out[2] for out in outs]
            assert float((h0[0].float() - h0[1].float()).abs().max()) <= 1e-6
        spread = _step_report(states[2], states[1], outs[2][1], outs[1][1], lr0)
        report = _step_report(states[0], states[1], outs[0][1], outs[1][1], lr0)
        print(f"step {i}: graph vs body {report}, body vs body {spread}")
        assert report["loss"] <= STEP_LOSS_RTOL
        assert report["grad_norm"] <= STEP_NORM_RTOL
        if i == 0:
            first = (outs[0][1], {k: v.clone() for k, v in outs[0][1].items()})
            assert report["param_exact"] <= PARAM_ATOL and report["param"] <= 2 * lr0 + PARAM_ATOL
            assert report["stats"] <= 1e-4
    assert all(torch.equal(first[0][k], first[1][k]) for k in first[1])
    assert steps[0].captures == 1 and steps[1].captures == 0 and len(steps[0]._slots) == 1


def test_train_step_capture_records_the_backward_from_autograds_thread(card, monkeypatch):
    """Backward runs on autograd's device thread, on the forward's stream:
    while the step is captured every training kernel's wrapper, the
    backward's too, finds its current stream capturing, so its launch lands
    in the graph."""
    import threading

    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    seen = []
    count = cuda_gru._count

    def watched(kernel, path):
        seen.append((kernel, torch.cuda.is_current_stream_capturing(),
                     threading.current_thread() is threading.main_thread()))
        count(kernel, path)

    monkeypatch.setattr(cuda_gru, "_count", watched)
    cfg, clean, noisy = _tiny_training(False)
    state = create_train_state(cfg, device=card)
    make_train_step(cfg)(state, clean, noisy)
    captured = [(k, main) for k, capturing, main in seen if capturing]
    assert sorted(k for k, _ in captured) == sorted(["gru_fwd_train", "gru_bwd", "gru_dw_partial", "gru_dw_sum"] * 3)
    assert {main for k, main in captured if k != "gru_fwd_train"} == {False}  # autograd's thread


def test_a_reloaded_optimizer_gets_a_new_train_capture(card, tmp_path):
    """Loading the optimizer's state after the first call moves its
    tensors: the next call captures anew, and later calls replay that."""
    from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    cfg, clean, noisy = _tiny_training(False)
    state = create_train_state(cfg, device=card)
    step = make_train_step(cfg)
    step(state, clean, noisy)
    graph = next(iter(step._slots.values())).graph
    ckpt = CheckpointManager(str(tmp_path), "TRUNet")
    ckpt.save(0, state)
    ckpt.restore(state, 0)
    cuda_gru.reset_launch_counts()
    step(state, clean, noisy)
    step(state, clean, noisy)
    torch.cuda.synchronize()
    assert cuda_gru.launch_counts() == _train_kernels(15)
    assert step.captures == 2 and next(iter(step._slots.values())).graph is not graph


def test_a_cpu_checkpoint_restores_into_the_card_optimizer(card, tmp_path):
    """A checkpoint the CPU's AdamW wrote restores into the card's
    capturable one (its step counts on the card as float32, its rate tensor
    the one it had), and the card steps on from it."""
    from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    cfg, clean, noisy = _tiny_training(False)
    cpu = create_train_state(cfg, device="cpu")
    make_train_step(cfg)(cpu, clean.cpu(), noisy.cpu())
    ckpt = CheckpointManager(str(tmp_path), "TRUNet")
    ckpt.save(0, cpu)
    state = create_train_state(cfg, device=card)
    lr = state.optimizer.param_groups[0]["lr"]
    ckpt.restore(state, 0)
    group = state.optimizer.param_groups[0]
    assert group["lr"] is lr and group["capturable"] and state.step == 1
    for p, s in state.optimizer.state.items():
        assert s["step"].device == p.device and s["step"].dtype == torch.float32 and float(s["step"]) == 1
    _, metrics = make_train_step(cfg)(state, clean, noisy)
    assert all(bool(torch.isfinite(v)) for v in metrics.values()) and state.step == 2


def test_a_failure_inside_train_capture_propagates(card, monkeypatch):
    """No eager fallback: a training kernel's wrapper that fails while the
    step is captured fails the call and leaves no graph in the slot."""
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    count = cuda_gru._count

    def failing(kernel, path):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("forced failure inside capture")
        count(kernel, path)

    monkeypatch.setattr(cuda_gru, "_count", failing)
    cfg, clean, noisy = _tiny_training(False)
    state = create_train_state(cfg, device=card)
    step = make_train_step(cfg)
    with pytest.raises(RuntimeError, match="forced failure inside capture"):
        step(state, clean, noisy)
    assert step.captures == 0 and [slot.graph for slot in step._slots.values()] == [None]


# ------------------------------------------------------- the eval step's graph
# (tinyrecurrentunet_torch/train/step.py EvalStep: one CUDA graph a validation batch shape)

GRAPH_ATOL = 1e-6  # graph vs body: the same kernels on the same buffers (chip_smoke.py)


def _only_gru_fwd_counts(n):
    return {**{k: 0 for k in cuda_gru.launch_counts()}, "gru_fwd": n}


def test_replayed_eval_step_equals_the_body(card):
    """The eval slot's first call launches 12 gru_fwd (3 warm-ups and the
    replay), a replayed call 3 and nothing else; graph and body
    (`replay=False`) give each loss term within GRAPH_ATOL, before and after
    a train step on the same state (the replay reads the updated weights
    and running statistics where they lie); the returned metrics are
    copies."""
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_eval_step, make_train_step

    cfg, clean, noisy = _tiny_training(False)
    state = create_train_state(cfg, device=card)
    train, evaluate = make_train_step(cfg), make_eval_step(cfg)
    train(state, clean, noisy)
    cuda_gru.reset_launch_counts()
    first = evaluate(state, clean, noisy)
    torch.cuda.synchronize()
    assert cuda_gru.launch_counts() == _only_gru_fwd_counts(12)
    for i in range(2):
        cuda_gru.reset_launch_counts()
        got = evaluate(state, clean, noisy)
        torch.cuda.synchronize()
        assert cuda_gru.launch_counts() == _only_gru_fwd_counts(3)
        want = evaluate(state, clean, noisy, replay=False)
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= GRAPH_ATOL * max(1.0, abs(float(want[k]))), (i, k)
        if i == 0:
            train(state, clean, noisy)
    assert not torch.equal(got["loss"], first["loss"])
    slot = next(iter(evaluate._slots.values()))
    assert all(first[k] is not slot.metrics[k] for k in first)
    assert evaluate.captures == 1 and len(evaluate._slots) == 1


def test_a_failure_inside_eval_capture_propagates(card, monkeypatch):
    """No eager fallback: gru_fwd's wrapper failing while the eval call is
    captured fails the call and leaves no graph in the slot."""
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_eval_step

    plain = cuda_gru.gru_recurrence

    def failing(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("forced failure inside capture")
        return plain(*args, **kwargs)

    monkeypatch.setattr(cuda_gru, "gru_recurrence", failing)
    cfg, clean, noisy = _tiny_training(False)
    evaluate = make_eval_step(cfg)
    with pytest.raises(RuntimeError, match="forced failure inside capture"):
        evaluate(create_train_state(cfg, device=card), clean, noisy)
    assert evaluate.captures == 0 and [slot.graph for slot in evaluate._slots.values()] == [None]


# ------------------------------------------------------ rt_bench's graph engines


def test_rt_bench_graph_engines_equal_their_bodies(card):
    """Each engine of the port's model replayed against the same engine's
    body: the full clip and the int8 engine within GRAPH_ATOL, the
    per-frame engine frame by frame over 6 frames (and its carry), from the
    same zero carry; 3 gru_fwd a replay."""
    from tinyrecurrentunet_torch.export import rt_bench

    cfg, sd, _ = _tiny_streaming()
    feats = torch.from_numpy((np.random.default_rng(0).standard_normal((40, 257, 4)) * 0.3)
                             .astype(np.float32)).to(card)
    graphs_, bodies = rt_bench.engines(cfg, sd, feats), rt_bench.engines(cfg, sd, feats, replay=False)
    for name in graphs_:
        calls = 6 if name.endswith("per_frame") else 1
        for _ in range(calls):
            cuda_gru.reset_launch_counts()
            got = graphs_[name]().clone()
            torch.cuda.synchronize()
            assert cuda_gru.launch_counts() == _only_gru_fwd_counts(3), name
            want = bodies[name]()
            assert float((got - want).abs().max()) <= GRAPH_ATOL, name
        assert graphs_[name].graph is not None and bodies[name].graph is None
    carry = graphs_["graph_per_frame"].carry, bodies["graph_per_frame"].carry
    assert float((carry[0] - carry[1]).abs().max()) <= GRAPH_ATOL


# --------------------------------------------- the data-parallel step over NCCL


def test_one_rank_nccl_step_replays_and_equals_the_body(card, monkeypatch):
    """A process group of one rank over NCCL takes the data-parallel path,
    and its step replays one CUDA graph that holds the collectives: the
    capturing call launches 12 of each training kernel, a replay 3; the
    all-reduces of BatchNorm, the loss and `sum_gradients_` are issued
    while capturing from the main thread, the sum-backward's from autograd's;
    under torch.backends.cudnn.deterministic the replayed steps and the
    body's (`replay=False`) from the same weights give the same bits, 3
    steps on."""
    import socket
    import threading

    import torch.distributed as dist

    from tinyrecurrentunet_torch import parallel
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    seen = []
    all_reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: seen.append(
        (torch.cuda.is_current_stream_capturing(), threading.current_thread() is threading.main_thread()))
        or all_reduce(*a, **k))
    cfg, clean, noisy = _tiny_training(False)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        assert parallel.is_distributed() and parallel.capturable_collectives()
        states = [create_train_state(cfg, device=card) for _ in range(2)]
        graph, body = make_train_step(cfg), make_train_step(cfg)
        for i in range(3):
            cuda_gru.reset_launch_counts()
            _, got = graph(states[0], clean, noisy)
            torch.cuda.synchronize()
            assert graph.replayed and cuda_gru.launch_counts() == _train_kernels(12 if i == 0 else 3)
            _, want = body(states[1], clean, noisy, replay=False)
            assert not body.replayed
            assert all(torch.equal(got[k], want[k]) for k in want), i
            for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
                assert torch.equal(a, b) and torch.equal(a.grad, b.grad), i
            for a, b in zip(states[0].model.buffers(), states[1].model.buffers()):
                assert torch.equal(a, b), i
    finally:
        dist.destroy_process_group()
    captured = [main for capturing, main in seen if capturing]
    assert captured.count(True) > 0 and captured.count(False) > 0
    assert graph.captures == 1 and body.captures == 0
