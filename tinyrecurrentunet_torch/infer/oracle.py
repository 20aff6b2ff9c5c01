"""Ideal-mask oracle bounds: the SI-SDR ceiling of T-F masking enhancers.

A copy of `tinyrecurrentunet_tpu/infer/oracle.py` (numpy only, no JAX): the
same testset gives the same numbers (tests/test_torch_oracle.py).

TRU-Net enhances by applying a per-bin mask to the mixture STFT: it can only
re-weight the mixture's own time-frequency cells. That puts a ceiling on
every masking model, reachable only with oracle knowledge of the clean
signal. This module measures that ceiling per item, so quality numbers can
be read against what is attainable:

- ``mag_mask``: ideal magnitude mask (|S_target| / |S_mix| clipped to
  [0, 1], mixture phase), the ceiling of magnitude-masking models.
- ``cplx_mask``: ideal complex mask with |M| <= bound (default 2.0, the
  PHM's attenuation/amplification regime, `models/phm.py`), the ceiling
  of phase-aware masking models like the PHM.

On the procedural reverb condition the wet-vs-early-reflection-target
baseline is already ~11 dB SI-SDR and the magnitude-mask oracle gains only
~+3.4 dB, so a small dereverberation gain can still be a large fraction of
what any masking model could do.

Usage:
    python -m tinyrecurrentunet_torch.infer.oracle --testset DIR [--out oracle.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from numpy.fft import irfft, rfft

from tinyrecurrentunet_torch.infer.metrics import si_sdr

__all__ = ["ideal_mask_bounds", "oracle_report", "main"]


def _stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Center-padded Hann STFT, frames in rows."""
    w = np.hanning(n_fft + 1)[:-1]
    pad = np.pad(x, (n_fft // 2, n_fft // 2))
    frames = np.lib.stride_tricks.sliding_window_view(pad, n_fft)[::hop]
    return rfft(frames * w, axis=-1)


def _istft(spec: np.ndarray, length: int, n_fft: int, hop: int) -> np.ndarray:
    """Windowed overlap-add inverse of `_stft` (COLA-normalized)."""
    w = np.hanning(n_fft + 1)[:-1]
    frames = irfft(spec, n=n_fft, axis=-1) * w
    out = np.zeros(length + n_fft)
    den = np.zeros(length + n_fft)
    for i in range(frames.shape[0]):
        s = i * hop
        out[s : s + n_fft] += frames[i]
        den[s : s + n_fft] += w * w
    out = out[n_fft // 2 : n_fft // 2 + length]
    den = den[n_fft // 2 : n_fft // 2 + length]
    return out / np.maximum(den, 1e-8)


def ideal_mask_bounds(
    target: np.ndarray,
    mixture: np.ndarray,
    sample_rate: int,
    n_fft: int = 512,
    hop: int = 256,
    cplx_bound: float = 2.0,
) -> dict:
    """Oracle SI-SDR ceilings for one (target, mixture) pair.

    Returns a dict with ``baseline`` (mixture scored as-is), ``mag_mask``
    and ``cplx_mask`` oracle SI-SDRs, plus the corresponding ``*_gain``
    deltas, all in dB.
    """
    n = min(len(target), len(mixture))
    t = np.asarray(target[:n], np.float64)
    m = np.asarray(mixture[:n], np.float64)
    base = float(si_sdr(m, t))

    T = _stft(t, n_fft, hop)
    M = _stft(m, n_fft, hop)
    m_abs = np.maximum(np.abs(M), 1e-9)

    # ideal magnitude mask, mixture phase, clipped to [0, 1]
    mag = np.minimum(np.abs(T) / m_abs, 1.0)
    est_mag = _istft(M * mag, n, n_fft, hop)

    # ideal bounded complex mask (the PHM's regime)
    cm = T / np.where(np.abs(M) < 1e-9, 1e-9, M)
    cm_abs = np.maximum(np.abs(cm), 1e-9)
    cm = cm * (np.minimum(cm_abs, cplx_bound) / cm_abs)
    est_cplx = _istft(M * cm, n, n_fft, hop)

    mag_db = float(si_sdr(est_mag, t))
    cplx_db = float(si_sdr(est_cplx, t))
    return {
        "baseline": base,
        "mag_mask": mag_db,
        "cplx_mask": cplx_db,
        "mag_mask_gain": mag_db - base,
        "cplx_mask_gain": cplx_db - base,
    }


def oracle_report(testset_dir: str, n_fft: int = 512, hop: int = 256) -> dict:
    """Per-noise-kind oracle bounds over a materialized DNS-layout testset.

    Walks the clean/noisy tree the quality eval scores (`infer/quality.py`),
    aggregates `ideal_mask_bounds` per condition, and returns
    {kind: {baseline_si_sdr, mag_mask_gain_db, cplx_mask_gain_db, n}} plus an
    "all" row: the denominators for the quality eval's per-kind gains.
    """
    from tinyrecurrentunet_torch.data.audio_io import read_wav
    from tinyrecurrentunet_torch.data.procgen import NOISE_KINDS

    noisy_dir = os.path.join(testset_dir, "noisy")
    clean_dir = os.path.join(testset_dir, "clean")
    per_kind: dict[str, list[dict]] = {}
    for name in sorted(os.listdir(noisy_dir)):
        if not name.endswith(".wav"):
            continue
        stem = name[:-4]
        fileid = stem.rsplit("_", 1)[-1]
        body = stem[len("noisy_") :] if stem.startswith("noisy_") else stem
        kind = next((k for k in sorted(NOISE_KINDS, key=len, reverse=True) if body.startswith(k)), "unknown")
        clean, sr = read_wav(os.path.join(clean_dir, f"clean_fileid_{fileid}.wav"))
        noisy, _ = read_wav(os.path.join(noisy_dir, name))
        bounds = ideal_mask_bounds(clean, noisy, sr, n_fft=n_fft, hop=hop)
        per_kind.setdefault(kind, []).append(bounds)
        per_kind.setdefault("all", []).append(bounds)

    def _agg(rows: list[dict]) -> dict:
        return {
            "baseline_si_sdr": round(float(np.mean([r["baseline"] for r in rows])), 3),
            "mag_mask_gain_db": round(float(np.mean([r["mag_mask_gain"] for r in rows])), 3),
            "cplx_mask_gain_db": round(float(np.mean([r["cplx_mask_gain"] for r in rows])), 3),
            "n": len(rows),
        }

    return {k: _agg(v) for k, v in sorted(per_kind.items())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--testset", required=True, help="materialized DNS-layout testset dir")
    parser.add_argument("--n_fft", type=int, default=512)
    parser.add_argument("--hop", type=int, default=256)
    parser.add_argument("--out", default=None, help="write JSON here")
    args = parser.parse_args(argv)
    report = oracle_report(args.testset, n_fft=args.n_fft, hop=args.hop)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return report


if __name__ == "__main__":
    main()
