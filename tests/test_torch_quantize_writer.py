"""The port's int8 pack writer (`export/quantize.py`) against the JAX
package's: the same bytes from the same variables, on random tiny variables
and on the shipped flagship (`artifacts/TRUNet-proc/pretrained.npz` ->
the committed `model_int8.trq`), and each package reading the other's pack.

Tolerance: none; packs are compared byte for byte, dequantized parameters
bit for bit.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.config import NetworkConfig as TNetCfg
from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.export import quantize as tquant
from tinyrecurrentunet_torch.models import TRUNet as TorchTRUNet
from tinyrecurrentunet_torch.weights import artifact_meta, state_dict_from_variables, variables_from_state_dict
from tinyrecurrentunet_tpu.config import NetworkConfig as JNetCfg
from tinyrecurrentunet_tpu.export import quantize as jquant
from tinyrecurrentunet_tpu.models import TRUNet as JaxTRUNet

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)


@pytest.fixture(scope="module")
def tiny_variables():
    """Random tiny flax variables (numpy leaves) with running statistics
    moved off their initial values."""
    model = JaxTRUNet(JNetCfg(**TINY))
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             model.init(jax.random.PRNGKey(3), jnp.zeros((2, 33, 4))))
    rng = np.random.default_rng(3)
    variables["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32), variables["batch_stats"])
    return variables


@pytest.mark.parametrize("with_stats,meta", [(True, {"phm_source": "bsigmoid", "sample_rate": 16000}),
                                             (True, None), (False, None)],
                         ids=["stats+meta", "stats", "params-only"])
def test_pack_is_the_jax_writers_pack(tmp_path, tiny_variables, with_stats, meta):
    stats = tiny_variables["batch_stats"] if with_stats else None
    port, ref = str(tmp_path / "port.trq"), str(tmp_path / "jax.trq")
    size = tquant.save_quantized(port, tiny_variables["params"], stats, meta=meta)
    assert size == jquant.save_quantized(ref, tiny_variables["params"], stats, meta=meta)
    assert filecmp.cmp(port, ref, shallow=False)


def test_pack_from_a_state_dict_is_the_jax_writers_pack(tmp_path, tiny_variables):
    """The port's own weights (state_dict -> variables, dicts in module
    order) are walked in JAX's sorted order."""
    model = TorchTRUNet(TNetCfg(**TINY))
    model.load_state_dict(state_dict_from_variables(tiny_variables))
    variables = variables_from_state_dict(model.state_dict())
    port, ref = str(tmp_path / "port.trq"), str(tmp_path / "jax.trq")
    tquant.save_quantized(port, variables["params"], variables["batch_stats"])
    jquant.save_quantized(ref, tiny_variables["params"], tiny_variables["batch_stats"])
    assert filecmp.cmp(port, ref, shallow=False)


def test_quantize_params_match_jax(tiny_variables):
    got = tquant.quantize_params(tiny_variables["params"])
    want = jquant.quantize_params(tiny_variables["params"])
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name][0], want[name][0])
        assert got[name][1] == want[name][1] and got[name][1].dtype == np.float32


@pytest.mark.parametrize("config,artifact,size", [
    ("proc16k", "TRUNet-proc", 343_200),
    ("large16k", "TRUNet-large", 3_676_296),
    ("proc48k", "TRUNet-proc48", 350_731),
], ids=["proc16k", "large16k", "proc48k"])
def test_cli_packs_the_shipped_flagship_byte_for_byte(tmp_path, config, artifact, size):
    """python -m tinyrecurrentunet_torch.export.quantize -c config/<config>.json
    --pretrained artifacts/<artifact> --out X writes the committed pack, for
    each of the three shipped models."""
    out = str(tmp_path / "model_int8.trq")
    path, directory = os.path.join(REPO, "config", f"{config}.json"), os.path.join(REPO, "artifacts", artifact)
    committed = os.path.join(directory, "model_int8.trq")
    assert tquant.main(["-c", path, "--pretrained", directory, "--out", out]) == os.path.getsize(committed) == size
    assert filecmp.cmp(out, committed, shallow=False)
    assert tquant.load_quantized_meta(out) == {k: str(v) for k, v in artifact_meta(tload_config(path)).items()}


def test_each_package_reads_the_others_pack(tmp_path, tiny_variables):
    port, ref = str(tmp_path / "port.trq"), str(tmp_path / "jax.trq")
    tquant.save_quantized(port, tiny_variables["params"], tiny_variables["batch_stats"])
    jquant.save_quantized(ref, tiny_variables["params"], tiny_variables["batch_stats"])
    for writer, reader, dequantize, restore in (
        (port, jquant.load_quantized, jquant.dequantize_params, jquant.restore_batch_stats),
        (ref, tquant.load_quantized, tquant.dequantize_params, tquant.restore_batch_stats),
    ):
        q, stats = reader(writer)
        params = dequantize(q, tiny_variables["params"])
        want = jquant.dequantize_params(jquant.quantize_params(tiny_variables["params"]), tiny_variables["params"])
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        restored = restore(stats, tiny_variables["batch_stats"])
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(tiny_variables["batch_stats"])):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_int8_state_dict_is_the_jax_dequantized_variables(tiny_variables):
    state = state_dict_from_variables(tiny_variables)
    got = tquant.int8_state_dict(state)
    params = jquant.dequantize_params(jquant.quantize_params(tiny_variables["params"]), tiny_variables["params"])
    want = state_dict_from_variables({"params": jax.tree.map(np.asarray, params),
                                      "batch_stats": tiny_variables["batch_stats"]})
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
