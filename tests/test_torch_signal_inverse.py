"""The last gaps of the port's featurizer and data modules against the JAX
package: the reference-layout helpers, `Featurizer.complex_spec` and
`Featurizer.inverse` (features back to a waveform), and
`load_clean_noisy_dataloader`.

Tolerances: the layout helpers and the loader's batches bit-equal;
complex_spec 1e-5 relative to the largest magnitude (10^(x/20) and
cos/sin of the atan2 phase in float32 by two libraries); the waveform of
`inverse` 1e-5 absolute (the same spectrum through two iSTFTs, peak ~0.3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_datasets import corpus  # noqa: F401  (fixture)
from test_torch_train import SR

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.data import load_clean_noisy_dataloader as tloader
from tinyrecurrentunet_torch.signal import features as tfeatures
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.data import load_clean_noisy_dataloader as jloader
from tinyrecurrentunet_tpu.signal import features as jfeatures

torch.set_num_threads(2)


def _features(seed=0, seconds=0.5):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal(int(SR * seconds))).astype(np.float32)
    fz = jfeatures.Featurizer(jconfig.FeaturizerConfig(sample_rate=SR))
    return audio, np.array(fz(jnp.asarray(audio)))


def test_reference_layout_round_trip_matches_jax():
    _, feats = _features()
    x = torch.from_numpy(feats)
    ref = tfeatures.to_reference_layout(x)
    assert ref.shape == (feats.shape[0], feats.shape[2], feats.shape[1])
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jfeatures.to_reference_layout(jnp.asarray(feats))))
    back = tfeatures.from_reference_layout(ref)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jfeatures.from_reference_layout(jnp.asarray(ref.numpy()))))
    np.testing.assert_array_equal(back.numpy(), feats)


def test_complex_spec_matches_jax():
    _, feats = _features(1)
    port = tfeatures.Featurizer(tconfig.FeaturizerConfig(sample_rate=SR))
    ref = jfeatures.Featurizer(jconfig.FeaturizerConfig(sample_rate=SR))
    ch = [feats[..., i] for i in (0, 2, 3)]  # logmag, real_demod, imag_demod
    got = port.complex_spec(*map(torch.from_numpy, ch)).numpy()
    want = np.asarray(ref.complex_spec(*map(jnp.asarray, ch)))
    assert got.dtype == want.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("length", [None, 7000])
def test_inverse_matches_jax(length):
    audio, feats = _features(2)
    port = tfeatures.Featurizer(tconfig.FeaturizerConfig(sample_rate=SR))
    ref = jfeatures.Featurizer(jconfig.FeaturizerConfig(sample_rate=SR))
    got = port.inverse(torch.from_numpy(feats), length=length).numpy()
    want = np.asarray(ref.inverse(jnp.asarray(feats), length=length))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("subset,shuffle", [("training", None), ("training", False)])
def test_dataloader_batches_are_jax_batches(corpus, subset, shuffle):  # noqa: F811
    """Two epochs of the factory's loader, sharded 2 ways (shard 1), equal
    to the JAX factory's batch by batch."""
    kwargs = dict(subset=subset, batch_size=2, num_shards=2, shard_index=1, shuffle=shuffle)
    port = tloader(tconfig.TrainsetConfig(root=corpus, sample_rate=SR, crop_length_sec=0.25), **kwargs)
    ref = jloader(jconfig.TrainsetConfig(root=corpus, sample_rate=SR, crop_length_sec=0.25), **kwargs)
    assert len(port) == len(ref) == 1
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 1
        for (c, n, ids), (jc, jn, jids) in zip(got, want):
            assert ids == jids
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_equal(n, jn)
