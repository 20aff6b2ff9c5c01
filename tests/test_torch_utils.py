"""The port's `utils/params.py` and `utils/profiling.py` against the JAX
package's: parameter counts equal at the tiny and the flagship width, the
weight rescaling within 1e-6 relative (float32 std and division; the JAX
package's `jnp.std` is the biased estimator, as the port's `correction=0`),
the printed size in JAX's format; a torch.profiler trace with the program's
span in it (and not in the recorder's ring), the H100 peaks and
`throughput_seconds` on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import TINY

import chip_smoke
from tinyrecurrentunet_torch.config import NetworkConfig
from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.models import TRUNet as TTRUNet
from tinyrecurrentunet_torch.models.blocks import init_parameters
from tinyrecurrentunet_torch.utils import params as tparams
from tinyrecurrentunet_torch.utils import profiling as tprofiling
from tinyrecurrentunet_torch.weights import variables_from_state_dict
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.models import TRUNet as JTRUNet
from tinyrecurrentunet_tpu.utils import params as jparams

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _networks(width):
    if width == "tiny":
        return NetworkConfig(**TINY), jconfig.NetworkConfig(**TINY)
    path = os.path.join(REPO, "config", "proc16k.json")
    return tload_config(path).network, jconfig.load_config(path).network


@pytest.mark.parametrize("width", ["tiny", "proc16k"])
def test_count_params_matches_jax(width):
    """The port model's parameters against the flax params tree's shapes
    (BatchNorm statistics are buffers in one, batch_stats in the other)."""
    tnet, jnet = _networks(width)
    shapes = jax.eval_shape(JTRUNet(jnet).init, jax.random.PRNGKey(0), jnp.zeros((2, 257, jnet.input_size)))
    want = jparams.count_params(shapes["params"])
    assert tparams.count_params(TTRUNet(tnet, device="meta")) == want
    if width == "proc16k":
        assert 370_000 < want < 390_000  # the 381k flagship


@pytest.mark.parametrize("width", ["tiny", "proc16k"])
def test_weight_scaling_init_matches_jax(width):
    tnet, _ = _networks(width)
    model = init_parameters(TTRUNet(tnet), torch.Generator().manual_seed(5))
    with torch.no_grad():  # BatchNorm and GRU biases away from their initial 1 / 0
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    state = model.state_dict()
    got = variables_from_state_dict(tparams.weight_scaling_init(state))["params"]
    want = jparams.weight_scaling_init(variables_from_state_dict(state)["params"])
    before = variables_from_state_dict(state)["params"]
    changed = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        key = jax.tree_util.keystr(path)
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, np.asarray(leaf), rtol=1e-6, atol=0, err_msg=key)
        b = before
        for k in path:
            b = b[k.key]
        changed += not np.array_equal(b, np.asarray(leaf))
    assert changed >= 10  # kernels and their biases were rescaled


def test_print_size_prints_as_jax(capsys):
    model = TTRUNet(NetworkConfig(**TINY))
    n = tparams.print_size(model, "Tiny", keyword="GRU")
    got = capsys.readouterr().out
    tree = variables_from_state_dict(model.state_dict())["params"]
    want_n = jparams.print_size(tree, "Tiny", keyword="GRU")
    assert n == want_n and got == capsys.readouterr().out
    assert got.startswith(f"Tiny Parameters: {n / 1e6:.6f}M; GRU Parameters: ")


def test_trace_holds_an_annotated_span(tmp_path):
    """Under the profiler a span is a range of the trace, and stays out of the recorder's ring."""
    tprofiling.reset()
    with tprofiling.trace(str(tmp_path / "prof")) as log_dir:
        with tprofiling.span("trunet_span"):
            torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert log_dir == str(tmp_path / "prof")
    with open(tmp_path / "prof" / "trace_rank0.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "trunet_span" in names and "aten::mm" in names
    assert tprofiling.calls() == [] and tprofiling.spans("trunet_span") == []


def test_peak_flops_knows_the_h100_and_nothing_else():
    """The H100's peaks are chip_smoke.py's; a device it does not know raises."""
    peaks = tprofiling.PEAK_FLOPS["H100"]
    assert peaks == {"float32": chip_smoke.PEAK_F32_FLOPS, "tf32": chip_smoke.PEAK_TF32_FLOPS,
                     "bfloat16": chip_smoke.PEAK_BF16_FLOPS}
    with pytest.raises(ValueError, match="no published peak"):
        tprofiling.peak_flops(torch.device("cpu"))


def test_throughput_seconds_and_step_timer_on_the_cpu():
    calls, probes = [], []
    x = torch.randn(128, 128)
    sec = tprofiling.throughput_seconds(lambda: calls.append(1) or x @ x, probes.append, reps_hi=3, reps_lo=1,
                                        repeats=2)
    assert sec > 0 and len(calls) == 2 * (3 + 1) and len(probes) == 2


@pytest.mark.parametrize("values", [[3.0, -1.0, 2.5, 7.0], [[0.5, 4.0], [-2.0, 1.0]]])
def test_rescale_matches_jax(values):
    x = np.asarray(values, np.float32)
    got = tparams.rescale(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jparams.rescale(x)))
    assert got.min() == 0.0 and got.max() == 1.0


def test_flatten_matches_jax():
    nested = [[1, 2], [], [3], ["a", (4, 5)]]
    assert tparams.flatten(nested) == jparams.flatten(nested) == [1, 2, 3, "a", (4, 5)]


def test_std_normal_by_shape_dtype_and_moments():
    """The generators differ (torch.Generator, JAX's PRNG key), so the two
    are held by shape, dtype and the moments of 200,000 draws: mean within
    0.01 of 0 and standard deviation within 0.01 of 1 (5 sigma of their
    sampling error is 0.011 and 0.008)."""
    size = (400, 500)
    got = tparams.std_normal(torch.Generator().manual_seed(0), size)
    want = np.asarray(jparams.std_normal(jax.random.PRNGKey(0), size))
    assert tuple(got.shape) == want.shape == size
    assert got.dtype == torch.float32 and want.dtype == np.float32
    for sample in (got.numpy(), want):
        assert abs(sample.mean()) < 0.01 and abs(sample.std() - 1.0) < 0.01
    again = tparams.std_normal(torch.Generator().manual_seed(0), size)
    assert torch.equal(got, again)
