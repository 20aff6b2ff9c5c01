"""Sustained real-time soak of the native duplex stream host.

Counterpart of `tinyrecurrentunet_tpu/infer/soak.py`: a wall-clock-paced
producer/consumer run through the C++ SPSC rings driving the streaming step.

- a producer thread feeds one hop of audio into the native input ring
  every hop/sr seconds on an absolute schedule, like an audio callback
  (drift does not accumulate), and drains the output ring;
- the consumer loop polls the input ring, runs `StreamingDenoiser` on the
  block (on a card fenced by `torch.cuda.synchronize`) and pushes the
  denoised block, copied to the host, to the output ring (full duplex);
- xruns come from the native host's own counters (input underruns: the
  consumer starved the real-time boundary; output overruns: it flooded
  it), latency and jitter from per-block wall timing.

The JAX package's soak pushes the input block instead, because its TPU rig
paid ~26 ms for each device-to-host copy; on a card the copy of one hop is
part of the work a real stream does, so here the denoised block goes out.

    python -m tinyrecurrentunet_torch.infer.soak -c config/proc16k.json --duration 60 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch


def run_soak(cfg, state_dict: dict, duration_s: float = 60.0, warmup_blocks: int = 20, device="cuda") -> dict:
    """Run the wall-clock soak; returns a stats dict (streaming_soak_*)."""
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser
    from tinyrecurrentunet_torch.runtime import StreamHost

    sr = cfg.featurizer.sample_rate
    hop = cfg.featurizer.hop_length
    block_s = hop / sr

    sd = StreamingDenoiser(cfg, state_dict, device=device)
    on_card = sd.device.type == "cuda"
    state = sd.init_state()
    host = StreamHost(block_size=hop, capacity_blocks=64)

    # speech-ish looping source signal, synthesized up front
    rng = np.random.default_rng(0)
    t = np.arange(sr) / sr
    src = (0.1 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(sr)).astype(np.float32)

    # warm the step (and build the kernels) before the clock starts
    for _ in range(warmup_blocks):
        out, state = sd.process_block(state, src[:hop])
    out.cpu()

    n_blocks = int(duration_s / block_s)
    stop = threading.Event()

    def producer():
        """Audio-callback stand-in: absolute-schedule feed and drain."""
        t0 = time.perf_counter()
        for i in range(n_blocks):
            target = t0 + i * block_s
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            lo = (i * hop) % sr
            chunk = src[lo : lo + hop]
            if len(chunk) < hop:
                chunk = np.concatenate([chunk, src[: hop - len(chunk)]])
            host.feed(chunk)
            host.collect(hop)  # drain the playback side
            if stop.is_set():
                return

    prod = threading.Thread(target=producer, daemon=True)
    latencies = []
    last = None
    processed = 0
    started = time.perf_counter()
    prod.start()
    try:
        while processed < n_blocks:
            block = host.pull_block(starved=False)
            if block is None:
                if not prod.is_alive():
                    break  # producer done and ring drained
                time.sleep(block_s / 16)
                continue
            t_start = time.perf_counter()
            out, state = sd.process_block(state, block)
            if on_card:
                torch.cuda.synchronize()
            last = out.cpu().numpy()
            host.push_block(last)
            elapsed = time.perf_counter() - t_start
            host.add_busy(elapsed)
            latencies.append(elapsed)
            processed += 1
    finally:
        stop.set()
        prod.join(timeout=5.0)
    wall = time.perf_counter() - started
    if last is None or not np.all(np.isfinite(last)):
        raise RuntimeError(f"soak: {processed} blocks processed, last output finite: {last is not None}")

    lat = np.asarray(latencies)
    stats = host.stats()
    return {
        "streaming_soak_seconds": round(wall, 2),
        "streaming_soak_blocks": processed,
        "streaming_soak_sample_rate": sr,
        "streaming_soak_xruns": int(stats["input_underruns"] + stats["output_overruns"]),
        "streaming_soak_deadline_misses": int(np.sum(lat > block_s)),
        "streaming_soak_median_ms": round(float(np.median(lat)) * 1000, 4),
        "streaming_soak_p99_ms": round(float(np.percentile(lat, 99)) * 1000, 4),
        "streaming_soak_max_ms": round(float(np.max(lat)) * 1000, 4),
        "streaming_soak_jitter_ms": round(float(np.percentile(lat, 99) - np.median(lat)) * 1000, 4),
        "streaming_soak_duty_cycle": round(stats["busy_seconds"] / max(wall, 1e-9), 4),
        "streaming_soak_device": str(sd.device),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--config", default="config/proc16k.json")
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--out", default=None, help="write stats JSON here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.denoise import random_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args.config)
    stats = run_soak(cfg, random_state_dict(cfg), duration_s=args.duration, device=args.device)
    line = json.dumps(stats)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
