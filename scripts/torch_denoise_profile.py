"""Where the time of one flagship denoise call goes on the card.

    python scripts/torch_denoise_profile.py [--seconds 4] [--calls 10]

Runs the port's offline Denoiser (config/proc16k.json, artifacts/TRUNet-proc)
on a seeded clip and prints, per call:
- the host wall time of each stage (STFT, features, TRUNet, PHM head +
  iSTFT), each ended by torch.cuda.synchronize();
- under torch.profiler: the host wall time, the summed device time of the
  kernels, the device's idle share (1 - device time / wall time), the
  kernel count, and the kernels by device time.
The last line is all of it as one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tinyrecurrentunet_torch.config import load_config  # noqa: E402
from tinyrecurrentunet_torch.infer.denoise import Denoiser  # noqa: E402
from tinyrecurrentunet_torch.models.phm import denoise_output_to_audio  # noqa: E402


def stage_ms(den: Denoiser, audio: torch.Tensor, calls: int) -> dict:
    """Host wall ms of each stage of Denoiser.run, synchronised after each."""
    totals = {"stft": 0.0, "features": 0.0, "trunet": 0.0, "head_istft": 0.0}
    with torch.inference_mode():
        for _ in range(calls):
            t0 = time.perf_counter()
            spec = den.featurizer.spectrogram(audio)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            feats = den.featurizer.features_from_spec(spec)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out, _ = den.model(feats)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            denoise_output_to_audio(out, den.featurizer, den.cfg.network,
                                    length=audio.shape[-1], mixture_spec=spec)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for key, dt in zip(totals, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                totals[key] += dt * 1e3 / calls
    return totals


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--calls", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = load_config(os.path.join(REPO, "config", "proc16k.json"))
    den = Denoiser.from_pretrained(cfg, os.path.join(REPO, "artifacts", "TRUNet-proc"), "cuda")
    rng = np.random.default_rng(0)
    clip = (0.1 * rng.standard_normal(int(args.seconds * 16000))).astype(np.float32)
    for _ in range(3):
        den(clip)
    torch.cuda.synchronize()
    bucket = den._bucket(len(clip), cfg.featurizer.hop_length)
    audio = torch.from_numpy(np.pad(clip, (0, bucket - len(clip)))).cuda()
    stages = stage_ms(den, audio, args.calls)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            den(clip)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.calls

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host-side rows; their device time is the kernels' below
        rows.append({"name": evt.key,
                     "device_ms_per_call": evt.self_device_time_total / 1e3 / args.calls,
                     "count_per_call": evt.count / args.calls})
    rows.sort(key=lambda r: -r["device_ms_per_call"])
    device_ms = sum(r["device_ms_per_call"] for r in rows)
    result = {
        "device": torch.cuda.get_device_name(0), "clip_s": args.seconds, "calls": args.calls,
        "stage_wall_ms": stages,
        "wall_ms_per_call": wall_ms, "device_ms_per_call": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernels_per_call": sum(r["count_per_call"] for r in rows), "top": rows[:25],
    }
    print(json.dumps({k: v for k, v in result.items() if k != "top"}))
    for r in rows[:25]:
        print(f"{r['device_ms_per_call']:9.4f} ms  x{r['count_per_call']:6.1f}  {r['name'][:100]}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
