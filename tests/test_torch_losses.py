"""The port's losses against the JAX package: values and gradients
(torch.autograd against jax.grad) on the same numpy inputs.

Tolerances, float32 on both sides:
- values: 1e-5 relative (FFTs, norms and means summed in another order;
  measured <= 1e-6).
- gradients: 1e-3 relative L2, ||a - b|| / ||b||. The log-magnitude term's
  gradient divides by each bin's magnitude, so it carries the float32
  rounding of the weakest bins: the MR-STFT test also runs the port in
  float64 and requires the port's float32 gradient to be no further from it
  than twice JAX's (each is ~2e-4 off on these inputs).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tinyrecurrentunet_torch.config import LossConfig as TLossCfg
from tinyrecurrentunet_torch.config import NetworkConfig as TNetCfg
from tinyrecurrentunet_torch.config import STFTLossConfig as TSTFTCfg
from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.losses import MultiResolutionSTFTLoss as TMRSTFT
from tinyrecurrentunet_torch.losses import cossim_loss as tcossim
from tinyrecurrentunet_torch.losses import loss_fn as tloss_fn
from tinyrecurrentunet_torch.losses import per_item_weights as tper_item
from tinyrecurrentunet_torch.signal import Featurizer as TFeaturizer
from tinyrecurrentunet_tpu.config import STFTLossConfig as JSTFTCfg
from tinyrecurrentunet_tpu.config import load_config as jload_config
from tinyrecurrentunet_tpu.losses import loss_fn as jloss_fn
from tinyrecurrentunet_tpu.losses.composite import per_item_weights as jper_item
from tinyrecurrentunet_tpu.losses.cossim import cossim_loss as jcossim
from tinyrecurrentunet_tpu.losses.mrstft import MultiResolutionSTFTLoss as JMRSTFT
from tinyrecurrentunet_tpu.signal import Featurizer as JFeaturizer

torch.set_num_threads(2)

PROC16K = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
                       "proc16k.json")
LENGTH = 4100  # 0.26 s at 16 kHz: longer than the 2048-point bank's padding and cossim's segments
GRAD_TOL = 1e-3
VALUE_RTOL = 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _waves(seed, batch=2):
    """Tones over a -50 dB noise floor, plus noise. Without the floor a pure
    tone's spectrum has bins at the FFT's rounding level, where the gradient
    of log|X| (1/|X|) turns that rounding into percent-level differences in
    either framework."""
    rng = np.random.default_rng(seed)
    t = np.arange(LENGTH) / 16000
    clean = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (batch, 1)) * t)
    clean = (clean + 1e-3 * rng.standard_normal((batch, LENGTH))).astype(np.float32)
    noise = (0.1 * rng.standard_normal((batch, LENGTH))).astype(np.float32)
    return clean, clean + noise


@pytest.mark.parametrize("band", ["full", "high"])
def test_mrstft_value_and_grad_match_jax(band):
    x, y = _waves(1)
    jloss = JMRSTFT(JSTFTCfg(band=band))
    tloss = TMRSTFT(TSTFTCfg(band=band))

    def jtotal(xx):
        sc, mag = jloss(xx, jnp.asarray(y))
        return sc + mag, (sc, mag)

    (_, (jsc, jmag)), jgrad = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jnp.asarray(x))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        sc, mag = tloss(xt, torch.from_numpy(y).to(dtype))
        (sc + mag).backward()
        grads[dtype] = xt.grad.numpy()
        np.testing.assert_allclose(sc.item(), float(jsc), rtol=VALUE_RTOL)
        np.testing.assert_allclose(mag.item(), float(jmag), rtol=VALUE_RTOL)
    assert _rel_l2(grads[torch.float32], jgrad) <= GRAD_TOL
    ref = grads[torch.float64]
    assert _rel_l2(grads[torch.float32], ref) <= 2 * _rel_l2(jgrad, ref)


def test_cossim_value_and_grad_match_jax():
    x, y = _waves(2)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda a: jcossim(a, jnp.asarray(y))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    val = tcossim(xt, torch.from_numpy(y))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=VALUE_RTOL)
    assert _rel_l2(xt.grad.numpy(), jgrad) <= GRAD_TOL


def test_per_item_weights_match_jax():
    clean, noisy = _waves(3, batch=4)
    noisy[1] = clean[1] + 10 * (noisy[1] - clean[1])  # one loud item hits the clip
    want = np.asarray(jper_item(jnp.asarray(clean), jnp.asarray(noisy)))
    got = tper_item(torch.from_numpy(clean), torch.from_numpy(noisy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


class _FixedOutput(nn.Module):
    """A stand-in network that returns a given output, so the gradient of the
    loss with respect to the network output can be read off its parameter."""

    def __init__(self, output):
        super().__init__()
        self.output = nn.Parameter(torch.from_numpy(output))

    def forward(self, feats, tgru_h0=None):
        assert feats.shape[:-1] == self.output.shape[:-1]
        return self.output, tgru_h0


@pytest.mark.parametrize("overrides", [
    {},  # the flagship loss: L1 + MR-STFT + noise-side MR-STFT (0.5)
    {"cossim_lambda": 0.5, "ell_p": 2, "per_item_norm": True, "aux_feature_lambda": 0.1},
], ids=["flagship", "every_term"])
def test_loss_fn_value_and_output_grad_match_jax(overrides):
    jcfg, tcfg = jload_config(PROC16K), tload_config(PROC16K)
    jloss_cfg = dataclasses.replace(jcfg.train.loss_config, **overrides)
    tloss_cfg = dataclasses.replace(tcfg.train.loss_config, **overrides)
    assert tcfg.network.phm_source == "bsigmoid" and tloss_cfg.noise_stft_lambda == 0.5
    jfz, tfz = JFeaturizer(jcfg.featurizer), TFeaturizer(tcfg.featurizer)
    clean, noisy = _waves(4)
    frames = LENGTH // tcfg.featurizer.hop_length + 1
    rng = np.random.default_rng(5)
    output = (rng.standard_normal((2, frames, tcfg.featurizer.num_freqs, 8)) * 0.5).astype(np.float32)

    def apply_fn(variables, feats, tgru_h0, train=False, mutable=()):
        assert feats.shape[:-1] == output.shape[:-1]
        return (variables["params"]["out"], tgru_h0), {"batch_stats": {}}

    def jtotal(params):
        loss, terms, _, _ = jloss_fn(apply_fn, params, {}, jnp.asarray(clean), jnp.asarray(noisy),
                                     jfz, jcfg.network, jloss_cfg, train=True)
        return loss, terms

    (_, jterms), jgrad = jax.jit(jax.value_and_grad(jtotal, has_aux=True))({"out": jnp.asarray(output)})
    model = _FixedOutput(output)
    loss, terms, _ = tloss_fn(model, torch.from_numpy(clean), torch.from_numpy(noisy), tfz,
                              tcfg.network, tloss_cfg)
    loss.backward()
    assert sorted(terms) == sorted(jterms)
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), float(jterms[name]), rtol=VALUE_RTOL, err_msg=name)
    assert _rel_l2(model.output.grad.numpy(), jgrad["out"]) <= GRAD_TOL


def test_loss_fn_rejects_other_norms():
    model = _FixedOutput(np.zeros((1, 33, 257, 8), np.float32))
    audio = torch.zeros(1, 4096)
    with pytest.raises(ValueError, match="ell_p"):
        tloss_fn(model, audio, audio, TFeaturizer(tload_config(PROC16K).featurizer),
                 TNetCfg(), TLossCfg(ell_p=3))
