"""The port's GRU against the JAX scan and the Pallas kernel (interpret
mode), and the CUDA wrapper's dispatch (which path of `gru_fwd` a shape
takes), and checks.

Tolerance: 1e-5 absolute on outputs and final state. Both sides are float32
with the same gate math; only the order of the length-H dot products
differs (measured <= 1e-6 over 40 steps).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.infer.denoise import Denoiser, resolve_device
from tinyrecurrentunet_torch.ops import build, cuda_gru
from tinyrecurrentunet_torch.ops import gru as tgru
from tinyrecurrentunet_tpu.ops.gru import gru_scan as jax_gru_scan
from tinyrecurrentunet_tpu.ops.pallas_gru import gru_scan_pallas

torch.set_num_threads(2)  # beside JAX's pools under several test workers

ATOL = 1e-5


def _inputs(rows, length, d, h, seed):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    x = rng.standard_normal((rows, length, d)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((rows, h))).astype(np.float32)
    params = [rng.uniform(-k, k, s).astype(np.float32)
              for s in [(d, 3 * h), (h, 3 * h), (3 * h,), (3 * h,)]]
    return x, h0, params


CASES = [
    # rows, length, D, H
    (6, 16, 32, 64),   # FGRU-like: H=64 walked over 16 frequency bins
    (4, 40, 16, 128),  # TGRU-like: H=128 walked over time
    (3, 5, 8, 8),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows,length,d,h", CASES)
def test_gru_scan_matches_jax_scan_and_pallas(rows, length, d, h, reverse):
    x, h0, params = _inputs(rows, length, d, h, seed=rows * length)
    ref_out, ref_h = jax_gru_scan(jnp.asarray(x), jnp.asarray(h0), *map(jnp.asarray, params),
                                  reverse=reverse)
    pal_out, pal_h = gru_scan_pallas(jnp.asarray(x), jnp.asarray(h0), *map(jnp.asarray, params),
                                     reverse=reverse, interpret=True)
    out, h_last = tgru.gru_scan(torch.from_numpy(x), torch.from_numpy(h0),
                                *map(torch.from_numpy, params), reverse=reverse)
    for ref_o, ref_hh in ((ref_out, ref_h), (pal_out, pal_h)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), rtol=0, atol=ATOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(ref_hh), rtol=0, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_wrapper_runs_the_plain_version_on_cpu_tensors(reverse):
    x, h0, (wi, wh, bi, bh) = _inputs(5, 9, 8, 16, seed=1)
    x_proj = tgru.gru_project_inputs(torch.from_numpy(x), torch.from_numpy(wi), torch.from_numpy(bi))
    before = cuda_gru.launches
    got = cuda_gru.gru_recurrence(x_proj, torch.from_numpy(h0), torch.from_numpy(wh),
                                  torch.from_numpy(bh), reverse=reverse)
    want = tgru.gru_recurrence(x_proj, torch.from_numpy(h0), torch.from_numpy(wh),
                               torch.from_numpy(bh), reverse=reverse)
    assert cuda_gru.launches == before  # the plain version is not a launch
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_raises_on_devices_it_has_no_path_for():
    t = torch.empty((2, 3, 12), device="meta")
    with pytest.raises(ValueError, match="no GRU recurrence"):
        cuda_gru.gru_recurrence(t, torch.empty((2, 4), device="meta"),
                                torch.empty((4, 12), device="meta"), torch.empty(12, device="meta"))


def test_cuda_request_without_a_card_raises_instead_of_running_on_cpu():
    """device='cuda' on a CPU-only machine raises; on a card it is honoured."""
    cfg_dir = os.path.join(os.path.dirname(os.path.dirname(__file__)), "config")
    from tinyrecurrentunet_torch.config import load_config

    cfg = load_config(os.path.join(cfg_dir, "tiny16k.json"))
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Denoiser(cfg, {}, device="cuda")
    assert resolve_device("cpu").type == "cpu"


def _cpu_args(rows=4, steps=3, hidden=8):
    return (torch.zeros(rows, steps, 3 * hidden), torch.zeros(rows, hidden),
            torch.zeros(hidden, 3 * hidden), torch.zeros(3 * hidden))


@pytest.mark.parametrize("mutate,err", [
    (lambda a: (a[0].double(),) + a[1:], TypeError),
    (lambda a: (a[0].transpose(0, 1).contiguous().transpose(0, 1),) + a[1:], ValueError),
    (lambda a: (a[0][..., :-1],) + a[1:], ValueError),
    (lambda a: (a[0], a[1][:-1]) + a[2:], ValueError),
    (lambda a: a[:2] + (a[2][:, :-3],) + a[3:], ValueError),
    (lambda a: a[:3] + (a[3][None],), ValueError),
])
def test_kernel_argument_checks(mutate, err):
    """The checks that guard the kernel launch, run on CPU tensors."""
    cuda_gru._check(*_cpu_args())
    with pytest.raises(err):
        cuda_gru._check(*mutate(_cpu_args()))


def test_kernel_rejects_hidden_above_one_block():
    with pytest.raises(ValueError, match="hidden size"):
        cuda_gru._check(*_cpu_args(rows=1, steps=1, hidden=1025))


@pytest.mark.parametrize("rows,hidden,expect", [
    (556, 64, 8),    # flagship FGRU, 4 s clip: 70 blocks
    (501, 64, 4),
    (16, 128, 1),    # flagship TGRU: one row per block, 16 blocks
    (16, 512, 1),
    (5000, 512, 4),  # capped: H * rows per block <= 2048
    (5000, 1024, 2),
])
def test_rows_per_block(rows, hidden, expect):
    assert cuda_gru.rows_per_block(rows, hidden, 132) == expect


@pytest.mark.parametrize("rows,steps,hidden,expect", [
    (556, 16, 64, ("registers", 2)),    # flagship FGRU, 4 s clip: 278 blocks, four an SM
    (16, 556, 128, ("registers", 1)),   # flagship TGRU: one block per row
    (556, 16, 256, ("cluster", 8)),     # large16k FGRU: 70 clusters of 8 blocks
    (16, 556, 512, ("cluster", 2)),     # large16k TGRU: 8 clusters of 16 blocks, one wave
    (17, 556, 512, ("cluster", 3)),
    (16, 100, 256, ("cluster", 1)),
    (133, 7, 128, ("registers", 2)),
    (5000, 3, 128, ("registers", 4)),   # the most rows per tile the kernel is built for
    (5000, 3, 64, ("registers", 8)),
    (1, 0, 64, ("registers", 1)),
    (16064, 16, 64, ("registers", 8)),  # evaluation at batch 64 of 2 s clips: several waves
    (1024, 251, 128, ("registers", 4)),
    (16064, 16, 256, ("cluster", 8)),
    (1024, 251, 512, ("cluster", 4)),
    (7, 9, 40, ("general", 1)),         # any other H: the general kernel with rows_per_block
    (301, 9, 40, ("general", 4)),
    (16, 556, 1024, ("general", 1)),
])
def test_fwd_plan(rows, steps, hidden, expect):
    plan = cuda_gru.fwd_plan(rows, steps, hidden, 132)
    assert plan == expect
    assert plan.path == expect[0] and plan.rows_per_tile == expect[1]


@pytest.mark.parametrize("rows,hidden,max_clusters,expect", [
    (16, 512, 8, 2),    # the card holds all 8 clusters of 16 blocks at once
    (16, 512, 6, 3),    # it holds 6: three rows a tile keep the call in one wave
    (16, 512, 1, 4),    # more waves than tiles built for: the most rows per tile
    (16, 256, 14, 2),
    (556, 256, 16, 8),
    (16, 128, 5, 1),    # no clusters at H 128: the count is not read
])
def test_fwd_plan_follows_the_clusters_the_card_holds(rows, hidden, max_clusters, expect):
    assert cuda_gru.fwd_plan(rows, 556, hidden, 132, max_clusters).rows_per_tile == expect


def test_build_names_every_source_and_hashes_its_content(tmp_path, monkeypatch):
    assert build.kernel_names() == ["gru_fwd", "gru_train"]
    path = build.library_path("gru_fwd")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libgru_fwd-")
    src = tmp_path / "gru_fwd.cu"
    src.write_text("// a different source\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.library_path("gru_fwd") != path
