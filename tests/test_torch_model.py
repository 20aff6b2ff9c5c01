"""The port's model, conv ops, weight converter and PHM head against the JAX
package.

Tolerances (absolute, float32):
- conv ops and tiny-width TRUNet: 1e-5 (same math, convolutions and matmuls
  summed in another order; measured <= 2e-6).
- PHM head: 1e-5 (elementwise math; measured ~1e-7).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.config import FeaturizerConfig as TFeatCfg
from tinyrecurrentunet_torch.config import NetworkConfig as TNetCfg
from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.models import TRUNet as TorchTRUNet
from tinyrecurrentunet_torch.models import phm as tphm
from tinyrecurrentunet_torch.ops import conv as tconv
from tinyrecurrentunet_torch.signal import Featurizer as TFeaturizer
from tinyrecurrentunet_torch.weights import (
    check_artifact_meta,
    load_pretrained,
    read_npz,
    state_dict_from_variables,
)
from tinyrecurrentunet_tpu.config import FeaturizerConfig as JFeatCfg
from tinyrecurrentunet_tpu.config import NetworkConfig as JNetCfg
from tinyrecurrentunet_tpu.models import TRUNet as JaxTRUNet
from tinyrecurrentunet_tpu.models import phm as jphm
from tinyrecurrentunet_tpu.ops import conv as jconv
from tinyrecurrentunet_tpu.signal import Featurizer as JFeaturizer

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5

TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tiny_models(seed=0, **overrides):
    jcfg = JNetCfg(**TINY, **overrides)
    tcfg = TNetCfg(**TINY, **overrides)
    jmodel = JaxTRUNet(jcfg)
    variables = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, 33, jcfg.input_size))))
    # non-trivial running statistics, so they must flow through the converter
    rng = np.random.default_rng(seed)
    variables["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    tmodel = TorchTRUNet(tcfg)
    tmodel.load_state_dict(state_dict_from_variables(variables))
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("batched", [True, False])
def test_tiny_trunet_matches_jax(batched):
    jmodel, variables, tmodel = _tiny_models()
    shape = (2, 7, 33, 4) if batched else (7, 33, 4)
    x = (np.random.default_rng(1).standard_normal(shape) * 0.5).astype(np.float32)
    y_ref, h_ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        y, h = tmodel(torch.from_numpy(x))
    assert y.shape == y_ref.shape and h.shape == h_ref.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=0, atol=ATOL)


def test_tiny_trunet_tgru_carry_matches_jax():
    jmodel, variables, tmodel = _tiny_models(seed=2)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((1, 5, 33, 4)) * 0.5).astype(np.float32)
    fb = tmodel.bottleneck_freqs(33)
    assert fb == jmodel.bottleneck_freqs(33)
    assert tuple(tmodel.init_tgru_state(1, 33).shape) == (1, fb, 16)
    h0 = (rng.standard_normal((1, fb, 16)) * 0.2).astype(np.float32)
    y_ref, h_ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(h0))
    with torch.no_grad():
        y, h = tmodel(torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=0, atol=ATOL)


def test_three_channel_variant_matches_jax():
    jmodel, variables, tmodel = _tiny_models(seed=3, input_size=3, output_size=6)
    x = (np.random.default_rng(3).standard_normal((1, 4, 33, 3)) * 0.5).astype(np.float32)
    y_ref, _ = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        y, _ = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)


def test_flagship_weights_load_strictly_with_the_jax_param_count():
    cfg = tload_config(os.path.join(REPO, "config", "proc16k.json"))
    state = load_pretrained(os.path.join(REPO, "artifacts", "TRUNet-proc"), cfg)
    model = TorchTRUNet(cfg.network)
    model.load_state_dict(state)  # strict: every key mapped, none left over
    variables, meta = read_npz(os.path.join(REPO, "artifacts", "TRUNet-proc", "pretrained.npz"))
    n_jax = sum(a.size for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert str(meta["phm_source"]) == "bsigmoid"


def test_artifact_meta_mismatch_raises():
    cfg = tload_config(os.path.join(REPO, "config", "proc16k.json"))
    bad = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, phm_source="mixture"))
    with pytest.raises(ValueError, match="phm_source"):
        load_pretrained(os.path.join(REPO, "artifacts", "TRUNet-proc"), bad)
    check_artifact_meta({}, bad, "old-artifact")  # nothing recorded: nothing to check


@pytest.mark.parametrize("k,stride,padding,groups", [(5, 2, 1, 1), (3, 1, 1, 4), (5, 2, 2, 8)])
def test_conv1d_matches_jax(k, stride, padding, groups):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((3, 21, 8)).astype(np.float32)
    w = rng.standard_normal((k, 8 // groups, 8)).astype(np.float32)
    ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), stride, padding, groups))
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(tconv.conv_weight_from_jax(w)),
                       None, stride, padding, groups).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k,stride,padding", [(3, 2, 1), (5, 2, 1), (3, 1, 0), (5, 1, 2)])
def test_conv_transpose1d_matches_jax(k, stride, padding):
    rng = np.random.default_rng(k * 10 + stride + padding)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    ref = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), stride, padding))
    got = tconv.conv_transpose1d(
        torch.from_numpy(x), torch.from_numpy(tconv.conv_transpose_weight_from_jax(w)), None,
        stride, padding).numpy()
    assert got.shape == ref.shape == (2, (9 - 1) * stride - 2 * padding + k, 5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("target", [4, 7, 10, 11, 13])
def test_pad_or_crop_matches_jax(target):
    """Includes odd negative diffs, where floor division crops one more at
    the front."""
    x = np.arange(2 * 10 * 3, dtype=np.float32).reshape(2, 10, 3)
    ref = np.asarray(jconv.pad_or_crop(jnp.asarray(x), target, axis=1))
    got = tconv.pad_or_crop(torch.from_numpy(x), target, dim=1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_bsigmoid_mask_matches_jax():
    rng = np.random.default_rng(0)
    zs, zn, sg = (rng.standard_normal((5, 33)).astype(np.float32) * 3 for _ in range(3))
    ref = np.asarray(jphm.bsigmoid_complex_mask(*map(jnp.asarray, (zs, zn, sg))))
    got = tphm.bsigmoid_complex_mask(*map(torch.from_numpy, (zs, zn, sg))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("source", ["bsigmoid", "mixture", "network"])
def test_head_to_audio_matches_jax(source):
    rng = np.random.default_rng(1)
    jfz, tfz = JFeaturizer(JFeatCfg(sample_rate=16000)), TFeaturizer(TFeatCfg(sample_rate=16000))
    audio = (0.1 * rng.standard_normal(2048)).astype(np.float32)
    spec = np.array(jfz.spectrogram(jnp.asarray(audio)))
    out = (rng.standard_normal(spec.shape + (8,)) * 0.5).astype(np.float32)
    ref = np.asarray(jphm.denoise_output_to_audio(
        jnp.asarray(out), jfz, JNetCfg(phm_source=source), length=2048,
        mixture_spec=jnp.asarray(spec)))
    got = tphm.denoise_output_to_audio(
        torch.from_numpy(out), tfz, TNetCfg(phm_source=source), length=2048,
        mixture_spec=torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
