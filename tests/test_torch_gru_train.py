"""The port's trainable GRU recurrence (`ops.cuda_gru.GRURecurrence`, on the
CPU through its plain versions) against the JAX package: the Pallas
trainable GRU in interpret mode and jax.grad of the lax.scan GRU.

Tolerance: 1e-5 absolute on outputs and h_T, 1e-5 relative to the largest
entry on each of the six gradients (x, h0, wi, wh, bi, bh). Both sides are
float32 with the same gate math; the dot products and the sums over rows
and steps of dWh, dbh, dwi and dbi are taken in another order (measured
<= 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.ops import gru as tgru
from tinyrecurrentunet_tpu.ops.gru import gru_scan as jax_gru_scan
from tinyrecurrentunet_tpu.ops.pallas_gru_vjp import gru_scan_pallas_trainable

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_RTOL = 1e-5


def _inputs(rows, length, d, h, seed):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    arrays = [
        rng.standard_normal((rows, length, d)),
        0.1 * rng.standard_normal((rows, h)),
        *(rng.uniform(-k, k, s) for s in [(d, 3 * h), (h, 3 * h), (3 * h,), (3 * h,)]),
    ]
    g_out = rng.standard_normal((rows, length, h))
    g_h = rng.standard_normal((rows, h))
    return [a.astype(np.float32) for a in arrays], g_out.astype(np.float32), g_h.astype(np.float32)


def _max_rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _port(args, g_out, g_h, reverse):
    x, h0, wi, wh, bi, bh = [torch.from_numpy(a).requires_grad_() for a in args]
    x_proj = tgru.gru_project_inputs(x, wi, bi)
    out, h_last = cuda_gru.GRURecurrence.apply(x_proj, h0, wh, bh, reverse)
    loss = (out * torch.from_numpy(g_out)).sum() + (h_last * torch.from_numpy(g_h)).sum()
    grads = torch.autograd.grad(loss, (x, h0, wi, wh, bi, bh))
    return out.detach().numpy(), h_last.detach().numpy(), [g.numpy() for g in grads]


def _jax(fn, args, g_out, g_h):
    def loss(*params):
        out, h_last = fn(*params)
        return jnp.sum(out * g_out) + jnp.sum(h_last * g_h), (out, h_last)

    grads, (out, h_last) = jax.jit(jax.grad(loss, argnums=tuple(range(6)), has_aux=True))(
        *map(jnp.asarray, args))
    return np.asarray(out), np.asarray(h_last), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,length,d,h", [
    (6, 16, 32, 64),   # FGRU-like: H=64 walked over 16 frequency bins
    (4, 24, 16, 32),   # TGRU-like: a longer walk over time
])
def test_gru_recurrence_matches_pallas_trainable_and_jax_grad(rows, length, d, h, reverse):
    args, g_out, g_h = _inputs(rows, length, d, h, seed=rows * length + reverse)
    out, h_last, grads = _port(args, g_out, g_h, reverse)
    references = {
        "pallas_interpret": lambda *p: gru_scan_pallas_trainable(*p, reverse=reverse, interpret=True),
        "scan": lambda *p: jax_gru_scan(*p, reverse=reverse),
    }
    for name, fn in references.items():
        ref_out, ref_h, ref_grads = _jax(fn, args, g_out, g_h)
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(h_last, ref_h, rtol=0, atol=ATOL, err_msg=name)
        for which, got, want in zip(("x", "h0", "wi", "wh", "bi", "bh"), grads, ref_grads):
            assert _max_rel(got, want) <= GRAD_RTOL, (name, which, _max_rel(got, want))


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_bptt_matches_autograd_through_the_plain_loop(reverse):
    """gru_recurrence_bwd against torch.autograd through gru_recurrence:
    the same float32 arithmetic in another order (1e-5 relative)."""
    (_, h0, _, wh, _, bh), g_out, g_h = _inputs(5, 11, 4, 12, seed=7)
    x_proj = np.random.default_rng(8).standard_normal((5, 11, 36)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x_proj, h0, wh, bh)]
    out, h_last = tgru.gru_recurrence(*leaves, reverse=reverse)
    loss = (out * torch.from_numpy(g_out)).sum() + (h_last * torch.from_numpy(g_h)).sum()
    want = torch.autograd.grad(loss, leaves)

    with torch.no_grad():
        out2, h2, saved = tgru.gru_recurrence_train(*leaves, reverse=reverse)
        torch.testing.assert_close(out2, out, rtol=0, atol=0)
        torch.testing.assert_close(h2, h_last, rtol=0, atol=0)
        d_xp, dwh, dbh, dh0 = tgru.gru_recurrence_bwd(
            torch.from_numpy(g_out), torch.from_numpy(g_h), out2, saved, leaves[1], leaves[2],
            reverse=reverse)
    for got, ref in zip((d_xp, dh0, dwh, dbh), want):
        assert _max_rel(got.numpy(), ref.numpy()) <= GRAD_RTOL


def test_card_only_wrappers_refuse_cpu_tensors():
    out, h0, d_xp, saved = torch.zeros(2, 3, 4), torch.zeros(2, 4), torch.zeros(2, 3, 12), torch.zeros(2, 3, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_gru.bptt(torch.zeros(2, 3, 4), torch.zeros(2, 4), out, saved, h0, torch.zeros(4, 12))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_gru.dw_partial(out, h0, d_xp, saved)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_gru.dw_sum(torch.zeros(1, 60), 4)


def test_saved_residuals_are_the_gates():
    """saved[:, t] = (r, z, n, hn) of the step, with h_prev the step walked
    before it (checked at one step of a reversed walk)."""
    (_, h0, _, wh, _, bh), _, _ = _inputs(3, 4, 4, 5, seed=9)
    x_proj = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 4, 15)).astype(np.float32))
    h0, wh, bh = map(torch.from_numpy, (h0, wh, bh))
    out, _, saved = tgru.gru_recurrence_train(x_proj, h0, wh, bh, reverse=True)
    hp = out[:, 2] @ wh + bh  # step 1 of a reversed walk follows step 2
    r = torch.sigmoid(x_proj[:, 1, :5] + hp[:, :5])
    z = torch.sigmoid(x_proj[:, 1, 5:10] + hp[:, 5:10])
    n = torch.tanh(x_proj[:, 1, 10:] + r * hp[:, 10:])
    torch.testing.assert_close(saved[:, 1], torch.cat([r, z, n, hp[:, 10:]], -1))
    torch.testing.assert_close(out[:, 1], (1 - z) * n + z * out[:, 2])


def test_cpu_tensors_launch_nothing():
    args, g_out, g_h = _inputs(2, 3, 4, 8, seed=1)
    before = cuda_gru.launch_counts()
    _port(args, g_out, g_h, reverse=False)
    assert cuda_gru.launch_counts() == before


def test_launch_paths_reset_with_the_counts_and_count_only_launches(monkeypatch):
    """`launch_paths` splits the launches by path; `reset_launch_counts`
    clears it, and the plain versions on CPU tensors record nothing."""
    monkeypatch.setattr(cuda_gru, "_paths", {"gru_bwd": {"general": 2}})
    assert cuda_gru.launch_paths() == {"gru_bwd": {"general": 2}}
    cuda_gru.reset_launch_counts()
    assert cuda_gru.launch_paths() == {} and set(cuda_gru.launch_counts().values()) == {0}
    args, g_out, g_h = _inputs(2, 3, 4, 8, seed=1)
    _port(args, g_out, g_h, reverse=True)
    assert cuda_gru.launch_paths() == {}


def _bwd_args(rows=4, steps=3, hidden=8):
    return (torch.zeros(rows, steps, hidden), torch.zeros(rows, hidden),
            torch.zeros(rows, steps, hidden), torch.zeros(rows, steps, 4 * hidden),
            torch.zeros(rows, hidden), torch.zeros(hidden, 3 * hidden))


@pytest.mark.parametrize("index,bad,err", [
    (0, torch.zeros(4, 3, 7), ValueError),            # g
    (1, torch.zeros(4, 8, dtype=torch.float64), TypeError),  # g_hT
    (3, torch.zeros(4, 3, 24), ValueError),           # saved
    (4, torch.zeros(8, 4).T, ValueError),              # h0 not contiguous
    (5, torch.zeros(8, 23), ValueError),              # wh
])
def test_bwd_argument_checks(index, bad, err):
    """The checks that guard the BPTT launch, run on CPU tensors."""
    cuda_gru._check_bwd(*_bwd_args())
    args = list(_bwd_args())
    args[index] = bad
    with pytest.raises(err):
        cuda_gru._check_bwd(*args)


@pytest.mark.parametrize("steps,hidden,path,expect", [
    # tensor cores (H 64, 128): two blocks an SM over the 192-column slabs, whole chunks
    (16064 * 16, 64, None, (260, 992)),    # flagship FGRU at batch 64: 1 slab x 260 splits
    (1024 * 251, 128, None, (132, 1952)),  # flagship TGRU at batch 64: 2 slabs x 132 splits
    (1000, 64, None, (4, 256)),
    (100, 64, None, (1, 128)),             # too few row-steps to split
    (63, 128, None, (1, 64)),
    # tensor cores (H 256, 512): whole waves of one block an SM over the
    # 128-row x 192-column tiles, at most 2,048 row-steps a split
    (4016 * 16, 256, None, (33, 1952)),    # large16k FGRU at batch 16: 8 tiles x 33 splits, two waves
    (256 * 251, 512, None, (33, 1952)),    # large16k TGRU at batch 16: 32 tiles x 33 splits, eight
    (133 * 5, 256, None, (3, 224)),        # ragged: whole chunks, the last split short
    (37 * 11, 512, None, (2, 224)),
    (1024 * 251, 512, None, (126, 2048)),
    (2008 * 16, 256, None, (16, 2016)),    # one wave of 8 tiles x 16 splits
    # the SIMT kernel (any other H, and any H when asked for): 64 x 64 tiles
    (100, 8, None, (1, 100)),
    (16064 * 16, 32, None, (132, 1948)),   # 2 tiles x 132 splits
    (133 * 5, 256, "simt", (3, 222)),
    (1024 * 251, 512, "simt", (2, 128512)),  # 192 tiles x 2 splits
    (4016 * 16, 256, "simt", (6, 10710)),    # large16k FGRU: 48 tiles x 6 splits
])
def test_dw_splits(steps, hidden, path, expect):
    splits, per_split = cuda_gru.dw_splits(steps, hidden, 132, path)
    assert (splits, per_split) == expect
    assert cuda_gru.dw_plan(steps, hidden, 132).path == ("tensor_cores" if hidden in (64, 128, 256, 512) else "simt")
    assert splits * per_split >= steps > (splits - 1) * per_split


@pytest.mark.parametrize("rows,steps,hidden,max_clusters,expect", [
    # Wh in registers (H 64: four blocks an SM, H 128: one): the fewest rows a
    # tile that keep one wave, at most 2 at H 64 and 4 at H 128
    (16064, 16, 64, None, ("registers", 2)),   # flagship FGRU at batch 64: 8,032 tiles
    (1024, 251, 128, None, ("registers", 4)),  # flagship TGRU at batch 64: 256 tiles, two waves
    (2008, 16, 64, None, ("registers", 2)),    # FGRU at batch 8
    (500, 16, 64, None, ("registers", 1)),     # 500 tiles of one row: one wave of 528
    (128, 251, 128, None, ("registers", 1)),   # TGRU at batch 8
    (133, 7, 128, None, ("registers", 2)),
    (1001, 13, 64, None, ("registers", 2)),
    (1, 1, 64, None, ("registers", 1)),
    # clusters (H 256: 8 blocks, H 512: 16): the fewest rows a tile (2, 4, 8)
    # that keep one wave of the clusters the card holds (30 and 7 on an
    # H100), else 8
    (16064, 16, 256, None, ("cluster", 8)),  # large16k FGRU at batch 64
    (4016, 16, 256, 30, ("cluster", 8)),     # large16k FGRU at batch 16: 502 tiles
    (256, 251, 512, 7, ("cluster", 8)),      # large16k TGRU at batch 16: 32 tiles
    (133, 5, 256, 30, ("cluster", 8)),       # ragged: 17 tiles, the last of 5 rows
    (37, 11, 256, 30, ("cluster", 2)),
    (19, 3, 512, 7, ("cluster", 4)),         # ragged: 5 tiles, the last of 3 rows
    (13, 9, 512, None, ("cluster", 2)),      # by default the SMs over the cluster size: 8
    # the general kernel (any other H), rows_per_block
    (301, 9, 40, None, ("general", 4)),
    (16064, 16, 100, None, ("general", 8)),
    (3, 1, 8, None, ("general", 1)),
])
def test_bwd_plan(rows, steps, hidden, max_clusters, expect):
    assert tuple(cuda_gru.bwd_plan(rows, steps, hidden, 132, max_clusters)) == expect


@pytest.mark.parametrize("rows,steps,hidden,max_clusters,expect", [
    # Wh in registers, blocks that stay on the card (H 64: two an SM, H 128:
    # one): the fewest rows a tile that keep one wave, at most 8 at H 64 and
    # 4 at H 128
    (16064, 16, 64, None, ("registers", 8)),   # flagship FGRU at batch 64: 2,008 tiles
    (1024, 251, 128, None, ("registers", 4)),  # flagship TGRU at batch 64: 256 tiles, two waves
    (2008, 16, 64, None, ("registers", 8)),    # FGRU at batch 8: one wave of 264
    (128, 251, 128, None, ("registers", 1)),   # TGRU at batch 8
    (500, 16, 64, None, ("registers", 2)),
    (1001, 13, 64, None, ("registers", 4)),
    (133, 7, 128, None, ("registers", 2)),
    (1, 1, 64, None, ("registers", 1)),
    # clusters (H 256: 8 blocks, H 512: 16), at most 4 rows a tile: as many
    # as fit the clusters the card holds (15 and 7 on an H100)
    (4016, 16, 256, 15, ("cluster", 4)),       # large16k FGRU at batch 16
    (256, 251, 512, 7, ("cluster", 4)),        # large16k TGRU at batch 16
    (133, 5, 256, 15, ("cluster", 4)),
    (19, 3, 512, 7, ("cluster", 3)),
    (16, 3, 512, None, ("cluster", 2)),        # by default the SMs over the cluster size: 8
    (16, 3, 512, 7, ("cluster", 3)),
    # the general kernel (any other H), rows_per_block
    (301, 9, 40, None, ("general", 4)),
    (16064, 16, 100, None, ("general", 8)),
    (3, 1, 8, None, ("general", 1)),
])
def test_fwd_train_plan(rows, steps, hidden, max_clusters, expect):
    assert tuple(cuda_gru.fwd_train_plan(rows, steps, hidden, 132, max_clusters)) == expect


@pytest.mark.parametrize("splits,size,expect", [
    (260, 12480, (8, 32)),   # flagship FGRU at batch 64: 390 blocks of 256 threads
    (132, 49536, (32, 8)),   # flagship TGRU at batch 64: 387 blocks
    (22, 49536, (32, 8)),    # fewer splits of the TGRU's size
    (4, 12480, (8, 4)),      # few splits: four lanes a word, one warp a block
    (126, 12480, (8, 32)),   # batch 8
    (1, 3366, (32, 1)),      # one split, a size not a multiple of 4
    (1, 60, (32, 1)),
    (3, 60, (16, 2)),
])
def test_sum_plan(splits, size, expect):
    plan = cuda_gru.sum_plan(splits, size, 132)
    assert tuple(plan) == expect
    threads = plan.cols * plan.groups
    assert threads % 32 == 0 and threads <= 256 and plan.groups <= splits


def test_dw_sum_refuses_a_misaligned_part_without_launching():
    """gru_dw_sum reads 16 bytes at a time: a part off a 16-byte boundary
    raises before anything is launched (checked before the device)."""
    flat = torch.zeros(2 * 60 + 1)
    part = flat[1:].view(2, 60)  # 4 bytes off the boundary
    before = cuda_gru.launch_counts()
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        cuda_gru.dw_sum(part, 4)
    assert cuda_gru.launch_counts() == before


@pytest.mark.parametrize("bidirectional", [False, True])
def test_eval_mode_gru_has_the_gradients_of_train_mode(bidirectional):
    """A GRU has nothing that eval mode changes, so where a gradient is
    wanted it takes the trainable recurrence in either mode: the gradients
    of eval and train mode are bit-equal (the same plain versions on the
    CPU). Without one (no_grad, inference_mode) it takes the inference
    recurrence, whose outputs are the same to float32 rounding (1e-6)."""
    from tinyrecurrentunet_torch.models.blocks import GRU, init_parameters

    gru = init_parameters(GRU(6, 8, bidirectional=bidirectional), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32)).requires_grad_()
    h0 = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 5, 8 * (2 if bidirectional else 1))).astype(np.float32))

    def grads(train: bool):
        out, h = gru.train(train)(x, h0)
        assert type(out.grad_fn).__name__ in ("GRURecurrenceBackward", "CatBackward0")
        return torch.autograd.grad((out * g).sum() + h.sum(), [x, h0, *gru.parameters()])

    for a, b in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.inference_mode():
        out_inf, h_inf = gru.eval()(x, h0)
    with torch.no_grad():
        out_ng, _ = gru(x, h0)
    out, h = gru(x, h0)
    assert out_ng.grad_fn is None
    torch.testing.assert_close(out_inf, out.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(h_inf, h.detach(), rtol=0, atol=1e-6)
