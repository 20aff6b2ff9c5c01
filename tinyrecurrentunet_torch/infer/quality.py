"""Quality eval: held-out procedural testset -> denoise -> metrics.

Counterpart of `tinyrecurrentunet_tpu/infer/quality.py`. It materializes
(or reuses) a DNS-layout clean/noisy tree from `data/procgen.py`, denoises
every noisy file through the port's `Denoiser` (featurize -> TRUNet -> PHM ->
iSTFT, on `cuda` unless asked for `cpu`), scores SI-SDR, STOI, fwSegSNR, LLR,
WSS and the PESQ estimate against clean with `evaluate_dns` (on the host),
and reports them beside the unprocessed noisy baseline, per noise kind and
per SNR band. The serving dtype is the config's `network.compute_dtype`:
set it to "bfloat16" to score bf16 serving. `--int8` also scores the int8
weight pack on the same testset. The result also carries the ideal-mask
oracle ceilings per noise kind (`infer/oracle.py`), as the JAX package's does.

Usage:
    python -m tinyrecurrentunet_torch.infer.quality -c config/proc16k.json \
        [--pretrained artifacts/TRUNet-proc] [--ckpt_iter max] \
        [--int8 artifacts/TRUNet-proc/model_int8.trq] [--num_files 60] \
        [--testset DIR] [--out QUALITY.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import tempfile

import numpy as np

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav
from tinyrecurrentunet_torch.data.procgen import NOISE_KINDS, materialize_dns_testset, testset_meta
from tinyrecurrentunet_torch.export.quantize import (
    dequantize_params,
    load_quantized,
    load_quantized_meta,
    restore_batch_stats,
)
from tinyrecurrentunet_torch.infer.denoise import Denoiser
from tinyrecurrentunet_torch.infer.evaluate import evaluate_dns
from tinyrecurrentunet_torch.infer.metrics import si_sdr, stoi
from tinyrecurrentunet_torch.infer.oracle import oracle_report
from tinyrecurrentunet_torch.infer.perceptual import fwsegsnr
from tinyrecurrentunet_torch.infer.pesq_est import pesq_estimate
from tinyrecurrentunet_torch.models import TRUNet
from tinyrecurrentunet_torch.weights import (
    check_artifact_meta,
    state_dict_from_variables,
    variables_from_state_dict,
)

# Far away from every training seed (training corpus seed 0, validation
# 6_000_000), so the testset is held out by construction.
QUALITY_TESTSET_SEED = 7_000_000
SNR_BUCKETS = ((-5, 0), (0, 10), (10, 20), (20, 25))


def denoiser_from_pretrained(cfg: Config, directory: str, device="cuda") -> Denoiser:
    """A Denoiser from a standalone `<directory>/pretrained.npz`."""
    denoiser = Denoiser.from_pretrained(cfg, directory, device=device)
    denoiser.ckpt_step = "pretrained"
    return denoiser


def denoiser_from_int8(cfg: Config, trq_path: str, device="cuda") -> Denoiser:
    """A Denoiser from an int8 .trq pack: its parameters dequantized to
    float32, its BatchNorm statistics as stored."""
    check_artifact_meta(load_quantized_meta(trq_path), cfg, trq_path)
    target = variables_from_state_dict(TRUNet(cfg.network).state_dict())
    quantized, stats = load_quantized(trq_path)
    variables = {
        "params": dequantize_params(quantized, target["params"]),
        "batch_stats": restore_batch_stats(stats, target["batch_stats"]),
    }
    denoiser = Denoiser(cfg, state_dict_from_variables(variables), device=device)
    denoiser.ckpt_step = "int8"
    return denoiser


def _prepare_testset(testset_dir, auto_dir, num_files, length_sec, sr, seed, snr_range):
    """Materialize the testset unless a matching one is there. A directory
    this module derived itself is regenerated on any recipe change; a
    user's populated tree without a recipe stamp is scored as it is (a real
    corpus); a user's tree stamped with another recipe raises."""
    clean_dir = os.path.join(testset_dir, "clean")
    meta_path = os.path.join(testset_dir, "testset_meta.json")
    want_meta = testset_meta(num_files, length_sec, sr, seed, snr_range)
    have_meta = None
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            have_meta = json.load(f)
    populated = os.path.isdir(clean_dir) and len(os.listdir(clean_dir)) >= num_files
    if auto_dir:
        stale = not populated or have_meta != want_meta
    elif populated and have_meta is None:
        stale = False
    elif populated and have_meta != want_meta:
        raise ValueError(
            f"testset at {testset_dir} was generated with a different recipe (found {have_meta}, "
            f"want {want_meta}): pass a fresh --testset path, or delete it yourself to regenerate"
        )
    else:
        stale = not populated
    if stale:
        if auto_dir and os.path.isdir(clean_dir):
            shutil.rmtree(testset_dir)
        materialize_dns_testset(testset_dir, num_files=num_files, length_sec=length_sec, sample_rate=sr,
                                snr_range=snr_range, seed=seed)
        return
    probe = os.path.join(clean_dir, sorted(os.listdir(clean_dir))[0])
    if read_wav(probe)[1] != sr:
        raise ValueError(f"testset at {testset_dir} was not materialized at {sr} Hz: pass a fresh --testset dir")


def _kind_of(stem: str) -> str:
    """The noise kind a noisy file's name records (longest match first:
    'noisy_reverb' holds an underscore)."""
    body = stem[len("noisy_"):] if stem.startswith("noisy_") else stem
    return next((k for k in sorted(NOISE_KINDS, key=len, reverse=True) if body.startswith(k)), "unknown")


def _breakdowns(testset_dir, enhanced_dir, noisy_dir, wanted, sr):
    """Per noise kind (SI-SDR, STOI, fwSegSNR and PESQ-estimate gains over
    the noisy input) and per SNR band (SI-SDR gain)."""
    per_kind: dict[str, list] = {}
    per_bucket: dict[str, list[float]] = {}
    for name in sorted(os.listdir(noisy_dir)):
        if not name.endswith(".wav"):
            continue
        stem = name[:-4]
        fileid = stem.rsplit("_", 1)[-1]
        if fileid not in wanted:
            continue
        clean, _ = read_wav(os.path.join(testset_dir, "clean", f"clean_fileid_{fileid}.wav"))
        noisy, _ = read_wav(os.path.join(noisy_dir, name))
        enh, _ = read_wav(os.path.join(enhanced_dir, f"enhanced_fileid_{fileid}.wav"))
        n = min(len(clean), len(noisy), len(enh))
        clean, noisy, enh = clean[:n], noisy[:n], enh[:n]
        delta = float(si_sdr(enh, clean) - si_sdr(noisy, clean))
        try:
            stoi_delta = float(stoi(clean, enh, sr) - stoi(clean, noisy, sr))
        except ValueError:  # clip too short or silent for STOI's framing
            stoi_delta = float("nan")
        fwseg_delta = float(fwsegsnr(clean, enh, sr) - fwsegsnr(clean, noisy, sr))
        try:
            pesq_delta = float(pesq_estimate(clean, enh, sr) - pesq_estimate(clean, noisy, sr))
        except ValueError:  # clip outside the estimator's framing
            pesq_delta = float("nan")
        per_kind.setdefault(_kind_of(stem), []).append((delta, stoi_delta, fwseg_delta, pesq_delta))
        snr_m = re.search(r"snr(-?\d+)db", stem)
        if snr_m:
            snr = int(snr_m.group(1))
            for lo, hi in SNR_BUCKETS:
                last = hi == SNR_BUCKETS[-1][1]
                if lo <= snr < hi or (last and snr == hi):
                    label = f"[{lo},{hi}]" if last else f"[{lo},{hi})"
                    per_bucket.setdefault(label, []).append(delta)
                    break
    kinds = {
        k: {
            "si_sdr_gain_db": round(float(np.mean([d for d, *_ in v])), 3),
            "min": round(float(np.min([d for d, *_ in v])), 3),
            "max": round(float(np.max([d for d, *_ in v])), 3),
            "stoi_gain": round(float(np.nanmean([s for _, s, *_ in v])), 4),
            "fwsegsnr_gain_db": round(float(np.mean([f for _, _, f, _ in v])), 3),
            "pesq_est_gain": round(float(np.nanmean([p for _, _, _, p in v])), 3),
            "n": len(v),
        }
        for k, v in sorted(per_kind.items())
    }
    buckets = {
        k: {"si_sdr_gain_db": round(float(np.mean(v)), 3), "min": round(float(np.min(v)), 3), "n": len(v)}
        for k, v in sorted(per_bucket.items())
    }
    return kinds, buckets


def run_quality_eval(
    cfg: Config,
    denoiser: Denoiser,
    testset_dir: str | None = None,
    num_files: int = 60,
    length_sec: float = 4.0,
    seed: int = QUALITY_TESTSET_SEED,
    snr_range: tuple[float, float] = (-5.0, 25.0),
    out_json: str | None = None,
    enhanced_dir: str | None = None,
) -> dict:
    """Materialize (if needed), denoise and score the first `num_files`
    files; returns the metrics dict (and writes it to `out_json`)."""
    sr = cfg.trainset.sample_rate
    auto_dir = testset_dir is None
    if auto_dir:
        testset_dir = os.path.join(tempfile.gettempdir(), f"trunet_quality_testset_{sr}_{num_files}_{seed}")
    _prepare_testset(testset_dir, auto_dir, num_files, length_sec, sr, seed, snr_range)
    wanted = {str(i) for i in range(num_files)}
    if enhanced_dir is None:
        enhanced_dir = os.path.join(cfg.gen.output_directory, cfg.train.exp_path, "quality_enhanced")
    os.makedirs(enhanced_dir, exist_ok=True)
    noisy_dir = os.path.join(testset_dir, "noisy")
    for name in sorted(os.listdir(noisy_dir)):
        fileid = name[:-4].rsplit("_", 1)[-1]
        if not name.endswith(".wav") or fileid not in wanted:
            continue
        noisy, _ = read_wav(os.path.join(noisy_dir, name))
        write_wav(os.path.join(enhanced_dir, f"enhanced_fileid_{fileid}.wav"), denoiser(noisy), sr)

    scored = evaluate_dns(testset_dir, enhanced_dir, sample_rate=sr, fileids=wanted)
    baseline = evaluate_dns(testset_dir, target="noisy", sample_rate=sr, fileids=wanted)
    per_kind, per_bucket = _breakdowns(testset_dir, enhanced_dir, noisy_dir, wanted, sr)
    result = {
        "testset": {
            "kind": "procedural-dns-layout", "num_files": num_files, "length_sec": length_sec,
            "sample_rate": sr, "seed": seed, "snr_range_db": list(snr_range), "reverb_target": "early50ms",
        },
        "enhanced": {k: v for k, v in scored.items() if isinstance(v, float)},
        "noisy_baseline": {k: v for k, v in baseline.items() if isinstance(v, float)},
        "per_noise_kind": per_kind,
        "per_snr_bucket": per_bucket,
    }
    # the ideal-mask ceilings per condition: the denominator the per-kind
    # gains are read against (the reverb row's magnitude-mask oracle is ~+3.4
    # dB on this testset, the additive rows' ~+7..10 dB)
    result["oracle"] = oracle_report(testset_dir, n_fft=cfg.featurizer.n_fft, hop=cfg.featurizer.hop_length)
    result["improvement"] = {
        k: result["enhanced"][k] - result["noisy_baseline"][k]
        for k in result["enhanced"] if k in result["noisy_baseline"]
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--pretrained", default=None, help="directory with pretrained.npz (overrides --ckpt_iter)")
    parser.add_argument("--ckpt_iter", default=None, help="max | iteration")
    parser.add_argument("--num_files", type=int, default=60)
    parser.add_argument("--length_sec", type=float, default=4.0)
    parser.add_argument("--testset", default=None, help="reuse or create the testset here")
    parser.add_argument("--int8", default=None, help="also score this int8 .trq pack on the same testset")
    parser.add_argument("--out", default="QUALITY.json")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)

    if args.pretrained:
        denoiser = denoiser_from_pretrained(cfg, args.pretrained, device=args.device)
    else:
        denoiser = Denoiser.from_checkpoint(cfg, args.ckpt_iter, device=args.device)
    common = dict(testset_dir=args.testset, num_files=args.num_files, length_sec=args.length_sec)
    result = run_quality_eval(cfg, denoiser, **common)
    if args.int8:
        int8 = run_quality_eval(
            cfg, denoiser_from_int8(cfg, args.int8, device=args.device), **common,
            enhanced_dir=os.path.join(cfg.gen.output_directory, cfg.train.exp_path, "quality_int8"),
        )
        result["enhanced_int8"] = int8["enhanced"]
        result["int8_improvement"] = int8["improvement"]
        result["int8_pack_kb"] = round(os.path.getsize(args.int8) / 1024, 1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
