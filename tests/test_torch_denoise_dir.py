"""The rest of the port's offline denoising on the CPU: the `max` and
integer checkpoint selectors, the DNS-style pair dataset (against the JAX
package's, item for item), `denoise_directory` and the CLI's
`--random_init`.

Tolerances: a denoiser restored from a checkpoint against one built from
the same state_dict, bit-equal (same weights, same arithmetic); dataset
items against the JAX package's, bit-equal (both are the same numpy and
scipy code on the same `rng`); WAVs written by the CLI against the
denoiser's output, 2/32767 (16-bit PCM).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav
from tinyrecurrentunet_torch.data.dataset import CleanNoisyPairDataset as TPairs
from tinyrecurrentunet_torch.infer import denoise as tdenoise
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.models.blocks import init_parameters
from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager
from tinyrecurrentunet_torch.train.state import TrainState, make_optimizer
from tinyrecurrentunet_tpu.config import load_config as jload_config
from tinyrecurrentunet_tpu.data.dataset import CleanNoisyPairDataset as JPairs

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
FILEIDS = (0, 1, 2, 10)  # "fileid_10.wav" sorts before "fileid_2.wav"


def _wave(samples, seed):
    return (np.random.default_rng(seed).standard_normal(samples) * 0.1).astype(np.float32)


@pytest.fixture
def tree(tmp_path):
    """A config file (tiny16k: the default network at 16 kHz) whose log,
    data and output directories lie under tmp_path, and a DNS-style test
    set: clean/clean_fileid_<i>.wav, noisy/<book>_snr<k>_fileid_<i>.wav."""
    dns = tmp_path / "dns"
    for sub in ("clean", "noisy", "noise"):
        (dns / sub).mkdir(parents=True)
    for i in FILEIDS:
        write_wav(str(dns / "clean" / f"clean_fileid_{i}.wav"), _wave(2000 + 300 * i, i), SR)
        write_wav(str(dns / "noisy" / f"book_{i:05d}_snr{i % 3}_fileid_{i}.wav"), _wave(2000 + 300 * i, 50 + i), SR)
    for j, samples in enumerate((500, 9000)):  # one noise file shorter than the crop: tiled
        write_wav(str(dns / "noise" / f"noise_{j}.wav"), _wave(samples, 90 + j), SR)
    with open(os.path.join(REPO, "config", "tiny16k.json")) as f:
        raw = json.load(f)
    raw["train"]["log"]["directory"] = str(tmp_path / "ckpt")
    raw["trainset"].update(root=str(dns), crop_length_sec=0.25)
    raw["gen"]["output_directory"] = str(tmp_path / "exp")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _save(cfg, step, seed):
    """A checkpoint at `step` of weights drawn from `seed`; returns them."""
    model = TRUNet(cfg.network)
    init_parameters(model, torch.Generator().manual_seed(seed))
    CheckpointManager(cfg.train.log.directory, cfg.train.exp_path).save(
        step, TrainState(model, make_optimizer(cfg, model)))
    return model.state_dict()


def test_from_checkpoint_max_and_integer_selectors(tree):
    cfg = tload_config(tree)
    first, last = _save(cfg, 3, seed=0), _save(cfg, 7, seed=1)
    clip = _wave(1500, 7)
    for selector, weights, step in (("max", last, 7), (None, last, 7), (3, first, 3), ("3", first, 3)):
        den = tdenoise.Denoiser.from_checkpoint(cfg, selector, device="cpu")
        assert den.ckpt_step == step
        np.testing.assert_array_equal(den(clip), tdenoise.Denoiser(cfg, weights, device="cpu")(clip))


def test_missing_checkpoint_raises(tree):
    cfg = tload_config(tree)
    with pytest.raises(FileNotFoundError, match="'max'"):
        tdenoise.Denoiser.from_checkpoint(cfg, "max", device="cpu")
    _save(cfg, 3, seed=0)
    with pytest.raises(FileNotFoundError, match="selector 5"):
        tdenoise.Denoiser.from_checkpoint(cfg, 5, device="cpu")


@pytest.mark.parametrize("subset,mode", [("testing", "mix"), ("training", "mix"), ("training", "pairs")])
def test_pair_dataset_items_match_jax(tree, tmp_path, subset, mode):
    if mode == "pairs":  # noisy/ parallel to clean/ under the same names
        dns = tmp_path / "dns"
        for name in os.listdir(dns / "clean"):
            write_wav(str(dns / "noisy" / name), _wave(1800, len(name)), SR)
    tcfg = dataclasses.replace(tload_config(tree).trainset, mode=mode)
    jcfg = dataclasses.replace(jload_config(tree).trainset, mode=mode)
    tds, jds = TPairs(tcfg, subset), JPairs(jcfg, subset)
    assert len(tds) == len(jds) > 0
    if subset == "testing":
        assert [os.path.basename(c) for c, _ in tds.files] == [
            f"clean_fileid_{i}.wav" for i in sorted(FILEIDS, key=lambda i: f"fileid_{i}.wav")]
    trng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(2):  # the same rng stream across items
        for i in range(len(tds)):
            got, want = tds.get(i, trng), jds.get(i, jrng)
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_denoise_directory_writes_the_reference_layout(tree, tmp_path):
    cfg = tload_config(tree)
    weights = _save(cfg, 7, seed=1)
    results = tdenoise.denoise_directory(cfg, "max", device="cpu")
    out_dir = tmp_path / "exp" / cfg.train.exp_path / "speech" / "7"
    names = [f"enhanced_clean_fileid_{i}.wav" for i in sorted(FILEIDS, key=lambda i: f"fileid_{i}.wav")]
    assert sorted(os.listdir(out_dir)) == sorted(names)
    assert [f"enhanced_{fileid}" for fileid, _ in results] == names
    den = tdenoise.Denoiser(cfg, weights, device="cpu")
    for fileid, enhanced in results:
        i = int(fileid.split("_")[-1][:-4])
        noisy, _ = read_wav(str(tmp_path / "dns" / "noisy" / f"book_{i:05d}_snr{i % 3}_fileid_{i}.wav"))
        np.testing.assert_array_equal(enhanced, den(noisy))
        written, sr = read_wav(str(out_dir / f"enhanced_{fileid}"))
        assert sr == SR
        np.testing.assert_allclose(written, np.clip(enhanced, -1, 1), rtol=0, atol=2 / 32767)


def test_cli_random_init_and_directory_mode(tree, tmp_path, capsys):
    cfg = tload_config(tree)
    wav_in, wav_out = str(tmp_path / "noisy.wav"), str(tmp_path / "clean.wav")
    clip = _wave(3000, 11)
    write_wav(wav_in, clip, SR)
    tdenoise.main(["-c", tree, "--random_init", "--device", "cpu", "--input", wav_in, "-o", wav_out])
    out, sr = read_wav(wav_out)
    assert sr == SR and out.shape == clip.shape and np.isfinite(out).all()
    want = tdenoise.Denoiser(cfg, tdenoise.random_state_dict(cfg), device="cpu")(read_wav(wav_in)[0])
    np.testing.assert_allclose(out, np.clip(want, -1, 1), rtol=0, atol=2 / 32767)

    _save(cfg, 2, seed=3)
    tdenoise.main(["-c", tree, "--ckpt_iter", "2", "--device", "cpu"])
    assert "denoised 4 files" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "exp" / cfg.train.exp_path / "speech" / "2")) == len(FILEIDS)
