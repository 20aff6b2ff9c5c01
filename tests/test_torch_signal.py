"""The port's signal core against the JAX functions on seeded inputs.

Tolerances (absolute, float32):
- STFT: 1e-4 on spectra of peak ~80 (the FFTs differ in the last bit,
  ~1e-6 relative; measured 1.1e-5).
- iSTFT, PCEN, dB channels from the same spectrum: 1e-5 (measured <= 1.4e-6).
- unwrap from the same phase: bit-equal (the cumulative sum takes its
  additions in the order of XLA's CPU cumsum).
- demod (sin/cos) channels: 2e-4. atan2 differs in the last bit between the
  two libraries, and the unwrapped phase reaches ~1e3 rad, where one float32
  step is ~1e-4; measured 2.4e-5 from the same spectrum on a 1 s clip.
- the whole featurizer from audio: 1e-4 on logmag/PCEN (near-silent bins
  amplify the FFT's last-bit difference in log10; measured 2.6e-5), 5e-4 on
  demod (measured 1.5e-4).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.config import FeaturizerConfig as TorchFeaturizerConfig
from tinyrecurrentunet_torch.signal import Featurizer as TorchFeaturizer
from tinyrecurrentunet_tpu.config import FeaturizerConfig as JaxFeaturizerConfig
from tinyrecurrentunet_tpu.signal import Featurizer as JaxFeaturizer

torch.set_num_threads(2)  # beside JAX's pools under several test workers

# the JAX signal package re-exports functions under its modules' names
jstft = importlib.import_module("tinyrecurrentunet_tpu.signal.stft")
jphase = importlib.import_module("tinyrecurrentunet_tpu.signal.phase")
jpcen = importlib.import_module("tinyrecurrentunet_tpu.signal.pcen")
tstft = importlib.import_module("tinyrecurrentunet_torch.signal.stft")
tphase = importlib.import_module("tinyrecurrentunet_torch.signal.phase")
tpcen = importlib.import_module("tinyrecurrentunet_torch.signal.pcen")

SR = 16000


def _audio(seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1234.5 * t)
    return (x + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, None), (512, 50, 240), (1024, 120, 600)])
def test_stft_matches_jax(n_fft, hop, win):
    x = _audio(0.5)
    jwin = None if win is None else jstft.hann_window(win)
    twin = None if win is None else _t(jwin)
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop, window=jwin))
    got = tstft.stft(_t(x), n_fft=n_fft, hop_length=hop, window=twin).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_stft_batched_leading_axes():
    x = np.stack([_audio(0.25, s) for s in range(3)])
    ref = np.asarray(jstft.stft(jnp.asarray(x)))
    got = tstft.stft(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("length", [None, 8064])
def test_istft_matches_jax(length):
    spec = np.asarray(jstft.stft(jnp.asarray(_audio(0.5))))
    ref = np.asarray(jstft.istft(jnp.asarray(spec), length=length))
    got = tstft.istft(_t(spec), length=length).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_istft_hann_envelope_guard():
    """A short hann window leaves near-zero envelope at the edges: the
    env > 1e-11 guard must behave as in JAX (no inf/nan)."""
    win = jstft.hann_window(240)
    spec = np.asarray(jstft.stft(jnp.asarray(_audio(0.25)), n_fft=512, hop_length=50, window=win))
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft=512, hop_length=50, window=win))
    got = tstft.istft(_t(spec), n_fft=512, hop_length=50, window=_t(win)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 16, 17, 300, 1500])
def test_unwrap_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    p = rng.uniform(-np.pi, np.pi, (n, 33)).astype(np.float32)
    ref = np.asarray(jphase.unwrap(jnp.asarray(p), axis=0))
    got = tphase.unwrap(_t(p), dim=0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_unwrap_tie_rule():
    """dd == +pi exactly keeps its sign (phase.py:43), dd == -pi too."""
    pi = np.float32(np.pi)
    p = np.array([0.0, pi, 0.0, -pi, 0.0, 2.5, -2.5, 3.0], np.float32)
    ref = np.asarray(jphase.unwrap(jnp.asarray(p)))
    np.testing.assert_array_equal(tphase.unwrap(_t(p)).numpy(), ref)


def test_blocked_cumsum_matches_sequential_in_float64():
    x = np.random.default_rng(0).standard_normal((4, 1000))
    np.testing.assert_allclose(
        tphase.blocked_cumsum(_t(x)).numpy(), np.cumsum(x, axis=-1), rtol=1e-12, atol=1e-9
    )


def test_mod_phase_zero_guard():
    real = np.array([0.0, 0.5, -1.0, 0.0], np.float32)
    imag = np.array([0.0, 0.5, 0.0, -1.0], np.float32)
    ref = np.asarray(jphase.mod_phase(jnp.asarray(real), jnp.asarray(imag)))
    np.testing.assert_allclose(tphase.mod_phase(_t(real), _t(imag)).numpy(), ref, atol=1e-7)
    assert ref[0] == 0.0


@pytest.mark.parametrize("frames", [1, 31, 32, 1250])
def test_pcen_matches_jax(frames):
    """1250 frames is 10 s: the blocked scan has no (1-s)^-t growth."""
    x = np.abs(np.random.default_rng(frames).standard_normal((2, frames, 65))).astype(np.float32)
    ref = np.asarray(jpcen.pcen(jnp.asarray(x)))
    got = tpcen.pcen(_t(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


_ATOL_SAME_SPEC = {"logmag": 1e-5, "pcen": 1e-5, "real_demod": 2e-4, "imag_demod": 2e-4}
_ATOL_FROM_AUDIO = {"logmag": 1e-4, "pcen": 1e-4, "real_demod": 5e-4, "imag_demod": 5e-4}


def _featurizers(channels=None):
    kw = {} if channels is None else {"channels": channels}
    return (JaxFeaturizer(JaxFeaturizerConfig(sample_rate=SR, **kw)),
            TorchFeaturizer(TorchFeaturizerConfig(sample_rate=SR, **kw)))


def test_features_from_same_spec_match_jax():
    jf, tf = _featurizers()
    spec = np.asarray(jf.spectrogram(jnp.asarray(_audio(1.0))))
    ref = np.asarray(jf.features_from_spec(jnp.asarray(spec)))
    got = tf.features_from_spec(_t(spec)).numpy()
    assert got.shape == ref.shape == spec.shape + (4,)
    for i, name in enumerate(tf.config.channels):
        np.testing.assert_allclose(got[..., i], ref[..., i], rtol=0, atol=_ATOL_SAME_SPEC[name],
                                   err_msg=name)


@pytest.mark.parametrize("channels", [None, ("logmag", "real_demod", "imag_demod")])
def test_featurizer_from_audio_matches_jax(channels):
    jf, tf = _featurizers(channels)
    x = _audio(1.0)
    ref = np.asarray(jf(jnp.asarray(x)))
    got = tf(_t(x)).numpy()
    assert got.shape == ref.shape
    for i, name in enumerate(tf.config.channels):
        np.testing.assert_allclose(got[..., i], ref[..., i], rtol=0, atol=_ATOL_FROM_AUDIO[name],
                                   err_msg=name)
