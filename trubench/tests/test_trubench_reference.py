"""The plain reference agrees with the port on the CPU at a tiny size:
the network, offline denoising over a bucket, streaming hop by hop, and
three float32 train steps."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from trubench.reference import net, serve, signal
from trubench.reference import train as reference
from trubench.tests import tiny
from trubench.traffic import train as train_traffic


@pytest.fixture(scope="module")
def setup():
    from tinyrecurrentunet_torch.config import load_config

    config = tiny.config()
    return load_config(str(tiny.HERE / "tiny16k.json")), config


def test_network_equal(setup):
    from tinyrecurrentunet_torch.models import TRUNet

    cfg, config = setup
    model = TRUNet(cfg.network)
    model.load_state_dict(config["state_dict"])
    model.eval()
    x = torch.randn(2, 7, 257, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, h = model(x)
        y_ref, h_ref = net.trunet(config["state_dict"], config["network"], x)
    assert torch.allclose(y, y_ref, atol=1e-6) and torch.allclose(h, h_ref, atol=1e-6)


@pytest.mark.parametrize("seconds", [0.3, 1.7])
def test_offline_equal(setup, seconds):
    from tinyrecurrentunet_torch.infer.denoise import Denoiser

    cfg, config = setup
    audio = np.random.default_rng(1).standard_normal(int(16000 * seconds)).astype(np.float32) * 0.1
    out = Denoiser(cfg, config["state_dict"], device="cpu")(audio)
    ref = serve.denoise(config["state_dict"], config, audio, "cpu")
    assert np.max(np.abs(out - ref)) < 2e-6 * np.max(np.abs(ref)) + 1e-7


def test_stream_equal(setup):
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser

    cfg, config = setup
    audio = np.random.default_rng(2).standard_normal((3, 128 * 200)).astype(np.float32) * 0.1
    denoiser = MultiStreamDenoiser(cfg, config["state_dict"], 3, 1, device="cpu")
    state, outs = denoiser.init_state(), []
    for k in range(200):
        out, state = denoiser.process_block(state, audio[:, k * 128:(k + 1) * 128])
        outs.append(out.numpy())
    ref = serve.stream(config["state_dict"], config, audio, "cpu", block=64)
    assert np.max(np.abs(np.concatenate(outs, 1) - ref)) < 2e-6 * np.max(np.abs(ref)) + 1e-7


def test_train_steps_equal(setup):
    from tinyrecurrentunet_torch.config import config_from_dict
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    _, config = setup
    raw = json.loads((tiny.HERE / "tiny16k.json").read_text())
    raw["train"]["optimization"].update(train_compute_dtype="", grad_clip_norm=0.5)
    cfg = config_from_dict(raw)
    state = create_train_state(cfg, device="cpu")
    state.model.load_state_dict(config["state_dict"])
    step = make_train_step(cfg)
    trainer = reference.Trainer(config["state_dict"], dict(config, optimization=dataclasses.asdict(cfg)["train"]
                                                           ["optimization"]), "cpu")
    rng = np.random.default_rng(3)
    for k in range(3):
        clean = rng.standard_normal((4, 8000)).astype(np.float32) * 0.1
        noisy = clean + rng.standard_normal((4, 8000)).astype(np.float32) * 0.05
        state, metrics = step(state, torch.from_numpy(clean), torch.from_numpy(noisy))
        spec = signal.offline_spectra(noisy, 512, 128)
        value, grads = trainer.step(torch.from_numpy(clean), torch.from_numpy(noisy),
                                    torch.from_numpy(signal.features(spec, config["featurizer"], False)),
                                    torch.from_numpy(spec))
        assert abs(float(metrics["loss"]) - value) < 1e-5 * value
        if k == 0:  # the clipped gradient, as AdamW's first moment holds it after one step
            first = {n: state.optimizer.state[p]["exp_avg"] / (1 - reference.B1)
                     for n, p in state.model.named_parameters()}
            # the reference makes its own features (NumPy); the loss's log-magnitudes
            # carry their last-bit differences into the gradient at ~0.6% here
            assert max(train_traffic.leaf_gaps(first, grads, list(grads)).values()) < 2e-2


def test_denoise_pool_has_no_ill_conditioned_reflected_frame():
    """The offline mix's clips begin and end in n_fft / 2 + 1 samples of
    silence, so the centred STFT's reflected (even, real-spectrum) frames
    are exactly zero. Seed 30103795's clip 3 had a first-frame bin at
    |X| 4e-7 whose phase features a float32 FFT moved by 0.146; with the
    silent edges no feature of that clip moves by more than 0.01."""
    import scipy.fft

    from trubench import harness
    from trubench.traffic import denoise

    cell, config = harness.load_json("workloads", "large16k-denoise-mixed"), harness.load_json("configs", "large16k")
    fz = config["featurizer"]
    n_fft, hop = fz["n_fft"], fz["hop_length"]
    clips = denoise.pool(30103795, cell["params"], fz["sample_rate"], n_fft)
    assert all(not c[:n_fft // 2 + 1].any() and not c[-(n_fft // 2 + 1):].any() for c in clips)
    clip = clips[3]
    padded = np.zeros(serve.bucket(len(clip), hop), np.float32)
    padded[:len(clip)] = clip
    frames = signal.frames(np.pad(padded, (n_fft // 2, n_fft // 2), mode="reflect"), n_fft, hop)
    wide = signal.features(signal.spectra(frames), fz, streaming=False)
    narrow = signal.features(scipy.fft.rfft(frames.astype(np.float32), axis=-1).astype(np.complex64), fz, streaming=False)
    assert not np.abs(signal.spectra(frames[:1])).any()
    assert np.abs(wide - narrow).max() < 0.01
