"""The offline Denoiser's length buckets on the CPU: each bucket's slot (its
static input and output, which on a card also hold the bucket's CUDA
graph) against the eager body `Denoiser.run`, against fresh denoisers and
against the JAX Denoiser; and the PCEN smoother's cache of decay matrices,
which keeps host-to-device copies out of a captured call.

Tolerances: bit for bit where the same body runs on the same padded input;
1e-4 absolute against the JAX Denoiser, as tests/test_torch_denoise.py
(the last bit of the FFT carried by the unwrapped phase).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.infer import denoise as tdenoise
from tinyrecurrentunet_torch.signal import pcen as tpcen
from tinyrecurrentunet_torch.weights import load_pretrained
from tinyrecurrentunet_tpu.config import load_config as jload_config
from tinyrecurrentunet_tpu.infer.denoise import Denoiser as JaxDenoiser
from tinyrecurrentunet_tpu.models import TRUNet as JaxTRUNet
from tinyrecurrentunet_tpu.train.checkpoint import load_pretrained_variables

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "proc16k.json")
ARTIFACT = os.path.join(REPO, "artifacts", "TRUNet-proc")
SR = 16000
HOP = 128
ATOL = 1e-4


def _clip(samples, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t) + 0.1 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def flagship():
    cfg = tload_config(CONFIG)
    return cfg, load_pretrained(ARTIFACT, cfg)


def _bucket(length):
    return tdenoise.Denoiser._bucket(length, HOP)


def test_call_equals_run_on_the_padded_input(flagship):
    cfg, sd = flagship
    den = tdenoise.Denoiser(cfg, sd, device="cpu")
    clip = _clip(8000)
    bucket = _bucket(len(clip))
    want = den.run(torch.from_numpy(np.pad(clip, (0, bucket - len(clip))))).numpy()[: len(clip)]
    got = den(clip)
    assert got.dtype == np.float32 and got.shape == clip.shape
    np.testing.assert_array_equal(got, want)


def test_calls_of_other_lengths_do_not_cross(flagship):
    """A long clip, a shorter one in the same bucket, one in another bucket,
    then the first bucket again: each call equals a fresh denoiser's, so the
    shorter clip's tail is zeros and no slot reads another's."""
    cfg, sd = flagship
    long, short, other = _clip(12000, 1), _clip(11500, 2), _clip(3000, 3)
    assert _bucket(len(long)) == _bucket(len(short)) != _bucket(len(other))
    den = tdenoise.Denoiser(cfg, sd, device="cpu")
    for clip in (long, short, other, long, short):
        want = tdenoise.Denoiser(cfg, sd, device="cpu")(clip)
        np.testing.assert_array_equal(den(clip), want)
    assert sorted(den._slots) == sorted({_bucket(len(long)), _bucket(len(other))})


def test_one_slot_per_bucket(flagship):
    """A slot a bucket, made at the bucket's first call: a static input and
    output of the bucket's length, float32 on the denoiser's device; on the
    CPU no pinned buffer, no graph and no capture."""
    cfg, sd = flagship
    den = tdenoise.Denoiser(cfg, sd, device="cpu")
    lengths = (700, 1024, 1025, 5000, 5001, 700)
    for n in lengths:
        den(_clip(n, n))
    buckets = {_bucket(n) for n in lengths}
    assert len(buckets) == 3 and set(den._slots) == buckets
    for bucket, slot in den._slots.items():
        for t in (slot.input, slot.output):
            assert t.shape == (bucket,) and t.dtype == torch.float32 and t.device.type == "cpu"
        assert slot.pinned is None and slot.graph is None and slot.launches is None
    assert den._captures == 0 and den._pool is None


def test_two_buckets_match_jax(flagship):
    """Calls in two buckets, in turns, against the JAX Denoiser (one compile
    a bucket) on the shipped flagship weights."""
    cfg, sd = flagship
    jcfg = jload_config(CONFIG)
    init = JaxTRUNet(jcfg.network).init(jax.random.PRNGKey(0), jnp.zeros((2, 257, 4)))
    params, stats = load_pretrained_variables(ARTIFACT, init["params"], init["batch_stats"], cfg=jcfg)
    jax_den = JaxDenoiser(jcfg, {"params": params, "batch_stats": stats})
    den = tdenoise.Denoiser(cfg, sd, device="cpu")
    clips = (_clip(6000, 4), _clip(2500, 5), _clip(6600, 6))
    assert _bucket(6000) == _bucket(6600) != _bucket(2500)
    for clip in clips:
        got = den(clip)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, jax_den(clip), rtol=0, atol=ATOL)


def _smoother_uncached(x, s, dim=-2):
    """The smoother with its decay matrices built on every call."""
    block = tpcen._BLOCK

    def decay(n, base, scale):
        idx = torch.arange(n, dtype=torch.float64)
        diff = idx[:, None] - idx[None, :]
        return torch.where(diff >= 0, scale * base ** diff.clamp(min=0), torch.zeros(())).to(x)

    x = x.movedim(dim, -1)
    n = x.shape[-1]
    a = 1.0 - s
    nb = -(-n // block)
    xb = F.pad(x, (0, nb * block - n)).reshape(x.shape[:-1] + (nb, block))
    inblock = xb @ decay(block, a, s).T
    carries = inblock[..., -1] @ decay(nb, a**block, 1.0).T
    prev = F.pad(carries, (1, 0))[..., :-1]
    m = inblock + prev[..., None] * (a ** torch.arange(1, block + 1, dtype=torch.float64)).to(x)
    return m.reshape(x.shape[:-1] + (nb * block,))[..., :n].movedim(-1, dim)


@pytest.mark.parametrize("frames", [1, 31, 32, 33, 556, 1602])
def test_cached_smoother_is_bit_equal(frames):
    x = torch.from_numpy(np.abs(np.random.default_rng(frames).standard_normal((2, frames, 65))).astype(np.float32))
    got = tpcen.smoother(x, 0.025)
    assert torch.equal(got, _smoother_uncached(x, 0.025))
    with torch.inference_mode():
        assert torch.equal(tpcen.smoother(x, 0.025), got)


def test_decay_matrices_are_built_once():
    """The same tensor object on every call with the same shape, dtype and
    device, which a captured graph may hold."""
    first = tpcen._decay_matrix(18, 0.5, 1.0, torch.float32, torch.device("cpu"))
    assert tpcen._decay_matrix(18, 0.5, 1.0, torch.float32, torch.device("cpu")) is first
    assert tpcen._decay_matrix(18, 0.5, 1.0, torch.float64, torch.device("cpu")) is not first
    steps = tpcen._decay_steps(0.5, torch.float32, torch.device("cpu"))
    assert tpcen._decay_steps(0.5, torch.float32, torch.device("cpu")) is steps
    assert not first.is_inference() and not steps.is_inference()
