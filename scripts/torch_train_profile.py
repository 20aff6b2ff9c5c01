"""Where the time of one flagship training step goes on the card.

    python scripts/torch_train_profile.py [--steps 3] [--batch 64]

Runs the port's train step (`train.step.make_train_step`) on config/proc16k.json
in float32 (train_compute_dtype cleared), on one seeded batch of 2 s
synthetic clips, and prints per step:
- the host wall time of the step, ended by torch.cuda.synchronize();
- under torch.profiler: the host wall time, the summed device time of the
  kernels, the device's idle share (1 - device time / wall time), the kernel
  count, the device time by kind of kernel (the port's GRU kernels, cuDNN
  convolutions, matrix products, FFTs, reductions, elementwise and copies)
  and the kernels by device time;
- the card's name and power limit as nvidia-smi reports them.
The last line is all of it as one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tinyrecurrentunet_torch.config import load_config  # noqa: E402
from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset  # noqa: E402
from tinyrecurrentunet_torch.train.state import create_train_state  # noqa: E402
from tinyrecurrentunet_torch.train.step import make_train_step  # noqa: E402

# kind of kernel, first match on the kernel's name
KINDS = (
    ("gru_kernels", r"gru_"),
    ("fft", r"fft|FFT|regular_fft|vector_fft"),
    ("convolution", r"conv|cudnn|implicit|wgrad|dgrad|fprop|Conv"),
    ("matmul", r"gemm|cutlass|sm90_xmma|ampere_sgemm|Kernel2"),
    ("reduction", r"reduce|Reduce|norm|Norm"),
    ("copy", r"copy|Copy|cat|transpose|Transpose|im2col|col2im|fill"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise|foreach"),
)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--batch", type=int, default=None, help="default: the config's (64)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = load_config(os.path.join(REPO, "config", "proc16k.json"))
    opt = dataclasses.replace(cfg.train.optimization, train_compute_dtype="",
                              batch_size_per_device=args.batch or cfg.train.optimization.batch_size_per_device)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt))
    batch = opt.batch_size_per_device
    dataset = SyntheticPairDataset(num_items=batch, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    items = [dataset.get(i) for i in range(batch)]
    clean, noisy = (torch.from_numpy(np.stack([x[k] for x in items])).cuda() for k in (0, 1))
    state = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    for _ in range(2):
        step(state, clean, noisy)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(state, clean, noisy)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, clean, noisy)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host-side rows; their device time is the kernels' below
        rows.append({"name": evt.key, "kind": kind_of(evt.key),
                     "device_ms_per_step": evt.self_device_time_total / 1e3 / args.steps,
                     "count_per_step": evt.count / args.steps})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in rows)
    by_kind = {}
    for r in rows:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["device_ms_per_step"]
    audio_s = batch * cfg.trainset.crop_length_sec
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi.splitlines()[0],
        "batch": batch, "clip_s": cfg.trainset.crop_length_sec,
        "steps": args.steps, "step_ms_host_clock": step_ms, "audio_s_per_s": audio_s / (step_ms / 1e3),
        "wall_ms_per_step_profiled": wall_ms, "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernels_per_step": sum(r["count_per_step"] for r in rows),
        "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top": rows[:30],
    }
    print(json.dumps({k: v for k, v in result.items() if k != "top"}))
    for r in rows[:30]:
        print(f"{r['device_ms_per_step']:9.3f} ms  x{r['count_per_step']:6.1f}  {r['kind']:12s} {r['name'][:90]}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
