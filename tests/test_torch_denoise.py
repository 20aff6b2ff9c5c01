"""The slice as a whole: the port's offline Denoiser on the CPU against the
JAX Denoiser, both with the shipped flagship weights (artifacts/TRUNet-proc,
config/proc16k.json).

Tolerance: 1e-4 absolute on the waveform (peak ~0.5). The two differ by the
last bit of the FFT and atan2, which the ~1e3 rad unwrapped phase behind the
demod features turns into ~1e-5..1e-4 on a few feature bins; measured 7.7e-6
on this 1 s clip and 4.2e-5 on a 4 s clip.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav
from tinyrecurrentunet_torch.infer import denoise as tdenoise
from tinyrecurrentunet_tpu.config import load_config as jload_config
from tinyrecurrentunet_tpu.infer.denoise import Denoiser as JaxDenoiser
from tinyrecurrentunet_tpu.models import TRUNet as JaxTRUNet
from tinyrecurrentunet_tpu.train.checkpoint import load_pretrained_variables

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "proc16k.json")
ARTIFACT = os.path.join(REPO, "artifacts", "TRUNet-proc")
SR = 16000
ATOL = 1e-4


def _clip(seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
    x = x + 0.1 * np.sin(2 * np.pi * 1500 * t) + 0.1 * rng.standard_normal(t.shape)
    return x  # float64 on purpose: both denoisers cast to float32


@pytest.fixture(scope="module")
def denoisers():
    jcfg = jload_config(CONFIG)
    model = JaxTRUNet(jcfg.network)
    init = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 257, 4)))
    params, stats = load_pretrained_variables(
        ARTIFACT, init["params"], init["batch_stats"], cfg=jcfg)
    jax_den = JaxDenoiser(jcfg, {"params": params, "batch_stats": stats})
    torch_den = tdenoise.Denoiser.from_pretrained(tload_config(CONFIG), ARTIFACT, device="cpu")
    return jax_den, torch_den


def test_flagship_denoise_matches_jax(denoisers):
    jax_den, torch_den = denoisers
    clip = _clip(1.0)
    ref = jax_den(clip)
    got = torch_den(clip)
    assert got.dtype == np.float32 and got.shape == clip.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _silence_led_clip(seed=3):
    """0.5 s of digital silence, then 0.5 s of tone and noise: the silent
    frames' STFT bins are exactly 0."""
    return np.concatenate([np.zeros(SR // 2), _clip(0.5, seed)])


def test_silence_led_clip_matches_jax(denoisers):
    """Bins that are exactly 0 have phase 0 in both packages (with the
    phase of torch.fft.rfft's -0.0, pi, the output lay 4.6e-2 from JAX's)."""
    jax_den, torch_den = denoisers
    clip = _silence_led_clip()
    got = torch_den(clip)
    assert np.isfinite(got).all() and got.shape == clip.shape
    np.testing.assert_allclose(got, jax_den(clip), rtol=0, atol=ATOL)


def test_denoise_odd_length_below_min_bucket(denoisers):
    """777 samples: padded up to the 8-hop minimum bucket, cropped back."""
    jax_den, torch_den = denoisers
    clip = _clip(777 / SR, seed=1)
    np.testing.assert_allclose(torch_den(clip), jax_den(clip), rtol=0, atol=ATOL)


@pytest.mark.parametrize("length", [1, 1024, 1025, 5000, 16000, 64000, 160001])
def test_bucket_ladder_matches_jax(length):
    assert tdenoise.Denoiser._bucket(length, 128) == JaxDenoiser._bucket(length, 128)


def _cli_config(tmp_path):
    with open(CONFIG) as f:
        raw = json.load(f)
    raw["train"]["log"]["directory"] = os.path.join(REPO, "artifacts")
    path = tmp_path / "proc16k_local.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_denoises_a_wav_on_cpu(tmp_path, denoisers):
    _, torch_den = denoisers
    cfg_path = _cli_config(tmp_path)
    wav_in, wav_out = str(tmp_path / "noisy.wav"), str(tmp_path / "clean.wav")
    write_wav(wav_in, _clip(0.5, seed=2), SR)
    tdenoise.main(["-c", cfg_path, "--ckpt_iter", "pretrained", "--input", wav_in,
                   "-o", wav_out, "--device", "cpu"])
    out, sr = read_wav(wav_out)
    audio, _ = read_wav(wav_in)
    assert sr == SR and out.shape == audio.shape
    # the CLI writes 16-bit PCM: one quantisation step is 1/32767
    np.testing.assert_allclose(out, np.clip(torch_den(audio), -1, 1), rtol=0, atol=2 / 32767)


def test_unported_selectors_raise(tmp_path):
    """The `max` and integer selectors read the port's checkpoints
    (tests/test_torch_denoise_dir.py); where the selector names none, as
    under artifacts/, they raise FileNotFoundError, as the JAX Denoiser does,
    and create nothing there."""
    cfg = tload_config(_cli_config(tmp_path))
    for selector in ("max", "1000", None):
        with pytest.raises(FileNotFoundError, match="no checkpoint for selector"):
            tdenoise.Denoiser.from_checkpoint(cfg, selector, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint for selector"):
        tdenoise.denoise_directory(cfg, device="cpu")
    assert not os.path.exists(os.path.join(ARTIFACT, "checkpoint"))
