"""`train/export_pretrained.py` of the port against the JAX package's
`save_pretrained_params`: a checkpoint of `train()` at the tiny config of
tests/test_torch_train.py becomes a pretrained.npz whose keys and arrays are
bit-equal to what the JAX package writes for the same variables and meta,
which the JAX Denoiser loads and runs as the port's Denoiser does (1e-4,
the waveform tolerance of tests/test_torch_denoise.py)."""

import functools
import json

import numpy as np
import pytest
import torch
from test_torch_train import CLIP_SEC, SR, _batch, _config

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch.data import SyntheticPairDataset
from tinyrecurrentunet_torch.infer.denoise import Denoiser as TDenoiser
from tinyrecurrentunet_torch.models import TRUNet as TTRUNet
from tinyrecurrentunet_torch.train import export_pretrained
from tinyrecurrentunet_torch.train import loop as tloop
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter
from tinyrecurrentunet_torch.weights import variables_from_state_dict
from tinyrecurrentunet_tpu import config as jconfig
from tinyrecurrentunet_tpu.infer.denoise import Denoiser as JDenoiser
from tinyrecurrentunet_tpu.train.checkpoint import artifact_meta, load_pretrained_variables, save_pretrained_params

torch.set_num_threads(2)


@pytest.fixture
def trained(tmp_path, monkeypatch):
    """Two train() steps on synthetic clips, checkpointed at iteration 1."""
    monkeypatch.setattr(tloop, "MetricsWriter", functools.partial(MetricsWriter, use_tensorboard=False))
    cfg = _config(tconfig, tmp_path / "ckpt")
    state, _ = tloop.train(cfg, SyntheticPairDataset(4, CLIP_SEC, SR), max_iters=2, log_dir=str(tmp_path / "logs"),
                           device="cpu")
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(tconfig.config_to_dict(cfg)))
    return str(path), state


def test_export_is_the_jax_npz_and_loads_in_jax(tmp_path, trained):
    cfg_path, state = trained
    written = export_pretrained.main(["-c", cfg_path, "--ckpt_iter", "max", "--out", str(tmp_path / "port"),
                                      "--device", "cpu"])
    jcfg = jconfig.load_config(cfg_path)
    variables = variables_from_state_dict(state.model.state_dict())
    save_pretrained_params(str(tmp_path / "jax"), variables["params"], variables["batch_stats"],
                           meta=artifact_meta(jcfg))
    got, want = np.load(written), np.load(tmp_path / "jax" / "pretrained.npz")
    assert sorted(got.files) == sorted(want.files) and any(k.startswith("meta/") for k in got.files)
    for key in got.files:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    target = variables_from_state_dict(TTRUNet(tconfig.load_config(cfg_path).network).state_dict())
    params, stats = load_pretrained_variables(str(tmp_path / "port"), target["params"], target["batch_stats"],
                                              cfg=jcfg)
    clip = _batch(1, seed=5)[1][0]
    jout = JDenoiser(jcfg, {"params": params, "batch_stats": stats})(clip)
    tout = TDenoiser.from_pretrained(tconfig.load_config(cfg_path), str(tmp_path / "port"), device="cpu")(clip)
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=0, atol=1e-4)


def test_export_of_a_missing_checkpoint_raises(tmp_path, trained):
    cfg_path, _ = trained
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export_pretrained.main(["-c", cfg_path, "--ckpt_iter", "7", "--out", str(tmp_path / "x"), "--device", "cpu"])
