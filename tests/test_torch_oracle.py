"""The port's ideal-mask oracle (`infer/oracle.py`, numpy) against the JAX
package's on a 2-file procedural testset: the same numpy code on the same
arrays, so the bounds and the report are equal (tolerance 1e-9; measured 0).
"""

import json

import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.data import procgen as tprocgen
from tinyrecurrentunet_torch.data.audio_io import read_wav
from tinyrecurrentunet_torch.infer import oracle as toracle
from tinyrecurrentunet_torch.infer.quality import QUALITY_TESTSET_SEED
from tinyrecurrentunet_tpu.infer import oracle as joracle

torch.set_num_threads(2)

SR = 16000


@pytest.fixture(scope="module")
def testset(tmp_path_factory):
    root = tmp_path_factory.mktemp("oracle_testset")
    tprocgen.materialize_dns_testset(str(root), num_files=2, length_sec=1.0, sample_rate=SR,
                                     seed=QUALITY_TESTSET_SEED)
    return root


def _pairs(testset):
    for noisy_path in sorted((testset / "noisy").glob("*.wav")):
        fileid = noisy_path.stem.rsplit("_", 1)[-1]
        clean, _ = read_wav(str(testset / "clean" / f"clean_fileid_{fileid}.wav"))
        noisy, _ = read_wav(str(noisy_path))
        yield clean, noisy


@pytest.mark.parametrize("n_fft,hop,cplx_bound", [(512, 256, 2.0), (512, 128, 2.0), (256, 64, 1.0)])
def test_ideal_mask_bounds_match_jax(testset, n_fft, hop, cplx_bound):
    pairs = list(_pairs(testset))
    assert len(pairs) == 2
    for clean, noisy in pairs:
        got = toracle.ideal_mask_bounds(clean, noisy, SR, n_fft=n_fft, hop=hop, cplx_bound=cplx_bound)
        want = joracle.ideal_mask_bounds(clean, noisy, SR, n_fft=n_fft, hop=hop, cplx_bound=cplx_bound)
        assert got.keys() == want.keys()
        for key in got:
            assert np.isfinite(got[key])
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9, err_msg=key)
        assert got["mag_mask"] > got["baseline"]  # the oracle is a ceiling above the mixture


@pytest.mark.parametrize("hop", [256, 128])
def test_oracle_report_matches_jax(testset, hop):
    got = toracle.oracle_report(str(testset), hop=hop)
    want = joracle.oracle_report(str(testset), hop=hop)
    assert got.keys() == want.keys() and "all" in got and got["all"]["n"] == 2
    for kind in got:
        assert got[kind].keys() == want[kind].keys()
        for key, value in got[kind].items():
            np.testing.assert_allclose(value, want[kind][key], rtol=0, atol=1e-9, err_msg=f"{kind}/{key}")


def test_oracle_cli_writes_the_report(testset, tmp_path, capsys):
    out = tmp_path / "oracle.json"
    report = toracle.main(["--testset", str(testset), "--out", str(out)])
    assert json.loads(out.read_text()) == report == json.loads(capsys.readouterr().out)
    assert report == toracle.oracle_report(str(testset))
