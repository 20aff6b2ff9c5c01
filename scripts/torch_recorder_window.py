"""The program's recorder (`tinyrecurrentunet_torch/utils/profiling.py`) on a
card: what it reads over a benchmark cell's untraced window, what it costs,
and how its device intervals lie on the host clock.

    python scripts/torch_recorder_window.py window --workload <cell> --seeds 1,2 [--seconds 20] [--sides on,off]
    python scripts/torch_recorder_window.py cost [--seconds 60]
    python scripts/torch_recorder_window.py probe [--seconds 45]

- `window`: runs the cell's traffic (`trubench/traffic/<mix>.py`, untraced)
  in this process, once a seed a side, the recorder on and off
  (`profiling.enable(False)`) in turns. A JSON line a run: the end-to-end
  metrics and whether the checks held; on the "on" side also the recorder's
  five benchmark metrics and, for the serving cells, the window calls' idle
  time between their device intervals by the program span open on the host
  (`profiling.idle_by_span`), the median from a call's span start to its
  device end beside the median host time of a call, and each child span's
  median.
- `cost`: 256 live flagship streams (config/proc16k.json), blocks of 250
  calls in turns with the recorder off, with its spans alone (no device
  intervals), and on in full; p50 and p95 of a call's host time in each.
- `probe`: 256 live flagship streams for `--seconds`, the recorder on; at
  the start and at the end 100 probe calls, each a device interval on an
  idle card between two host stamps taken after a synchronize: where the
  mapped interval lies against the stamps (µs).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tinyrecurrentunet_torch.utils import profiling  # noqa: E402

METRICS = ("untraced_idle_share.stream", "hop_device_ms.p50", "untraced_idle_share.denoise",
           "pad_share.denoise", "capture_s")
CALLS = {"stream": ("trunet.stream.call", "call_ms"), "denoise": ("trunet.denoise.call", "ms_per_audio_s")}


def window(args):
    sys.path.insert(0, str(ROOT / "trubench"))
    import run  # trubench/run.py: the cell's context

    from trubench import harness

    run._caches()
    sides = args.sides.split(",")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for side in sides if i % 2 == 0 else sides[::-1]:
            profiling.reset()
            profiling.enable(side == "on")
            ctx = run.context(args.workload, seed, args.seconds, False)
            ctx.t0 = time.monotonic()
            out = harness.load_module("traffic", ctx.cell["traffic"]).run(ctx)
            line = {"side": side, "seed": seed, "end_to_end": out.end_to_end,
                    "correct": all(c.ok for c in out.checks) and out.failed == 0}
            if "call_ms" in out.facts:
                line["call_ms.p50"] = statistics.median(out.facts["call_ms"])
            if side == "on":
                reading = {"facts": out.facts, "slice": None}
                t = time.perf_counter()
                profiling.calls(last=1)
                line["first_read_s"] = time.perf_counter() - t  # every pair of the ring settled
                line["metrics"] = {m: harness.load_module("metrics", m).read(reading) for m in METRICS}
                if ctx.cell["traffic"] in CALLS:
                    name, fact = CALLS[ctx.cell["traffic"]]
                    calls = profiling.calls(name, last=len(out.facts[fact]))
                    line["idle_by_span_s"] = profiling.idle_by_span(calls)
                    line["span_start_to_device_end_ms.p50"] = statistics.median(
                        (c.device[1] - c.start) / 1e6 for c in calls if c.device)
                    children = {}
                    for c in calls:
                        for s in c.spans[1:]:
                            children.setdefault(s.name, []).append((s.end - s.start) / 1e6)
                    line["child_span_ms.p50"] = {k: statistics.median(v) for k, v in children.items()}
            print(json.dumps(line), flush=True)
    profiling.enable(True)


def _streams(seed: int):
    """A call of 256 live flagship streams on seeded hops, its host ms."""
    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
    from tinyrecurrentunet_torch.weights import load_pretrained

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(str(ROOT / "config/proc16k.json"))
    den = MultiStreamDenoiser(cfg, load_pretrained(str(ROOT / "artifacts/TRUNet-proc"), cfg), 256, device="cuda")
    hops = (0.1 * np.random.default_rng(seed).standard_normal((64, 256, den.hop))).astype(np.float32)
    state, k = den.init_state(), 0

    def call() -> float:
        nonlocal state, k
        t = time.perf_counter()
        out, state = den.process_block(state, hops[k % 64])
        out.cpu().numpy()
        k += 1
        return (time.perf_counter() - t) * 1e3

    for _ in range(300):
        call()
    return call


def cost(args):
    call = _streams(11)
    rec = profiling.RECORDER
    full = (rec.device_begin, rec.device_end)

    def mode(m):
        profiling.enable(m != "off")
        rec.device_begin, rec.device_end = full if m == "full" else (lambda: None, lambda: None)

    order = ["off", "spans", "full", "full", "spans", "off"]
    ms = {m: [] for m in order}
    t0, i = time.perf_counter(), 0
    while time.perf_counter() - t0 < args.seconds:
        mode(order[i % len(order)])
        ms[order[i % len(order)]] += [call() for _ in range(250)]
        i += 1
    mode("full")
    out = {m: {"calls": len(v), "p50_ms": float(np.percentile(v, 50)), "p95_ms": float(np.percentile(v, 95))}
           for m, v in ms.items()}
    for m in ("spans", "full"):
        for q in ("p50", "p95"):
            out[m][f"{q}_over_off_pct"] = 100 * (out[m][f"{q}_ms"] / out["off"][f"{q}_ms"] - 1)
    print(json.dumps(out), flush=True)


def probe(args):
    call = _streams(13)
    x = torch.zeros(16, device="cuda")
    stamps = {}

    def probes(name):
        for _ in range(100):
            with profiling.span(name):
                torch.cuda.synchronize()
                h0 = time.perf_counter_ns()
                profiling.device_begin()
                x.add_(1)
                profiling.device_end()
                torch.cuda.synchronize()
                h1 = time.perf_counter_ns()
            stamps.setdefault(name, []).append((h0, h1))
            for _ in range(5):
                call()

    torch.cuda.synchronize()
    profiling.reset()
    t0 = time.perf_counter()
    probes("probe.first")
    while time.perf_counter() - t0 < args.seconds - 1.0:
        call()
    probes("probe.last")
    out = {"seconds": time.perf_counter() - t0, "card": torch.cuda.get_device_name()}
    rec, chains = profiling.RECORDER, set()
    for name in ("probe.first", "probe.last"):
        got = profiling.calls(name)
        chains |= {rec._chain_of[c.id & rec._cmask] for c in got}
        after = [(c.device[0] - h0) / 1e3 for c, (h0, _) in zip(got, stamps[name])]
        before = [(h1 - c.device[1]) / 1e3 for c, (_, h1) in zip(got, stamps[name])]
        out[name] = {"n": len(got), "pcts": [0, 5, 50, 95, 100],
                     "start_after_first_stamp_us": np.percentile(after, [0, 5, 50, 95, 100]).round(2).tolist(),
                     "end_before_second_stamp_us": np.percentile(before, [0, 5, 50, 95, 100]).round(2).tolist()}
    out["chains"] = sorted(chains)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    w = sub.add_parser("window")
    w.add_argument("--workload", required=True)
    w.add_argument("--seeds", required=True)
    w.add_argument("--seconds", type=float, default=20.0)
    w.add_argument("--sides", default="on,off")
    for name, seconds in (("cost", 60.0), ("probe", 45.0)):
        sub.add_parser(name).add_argument("--seconds", type=float, default=seconds)
    args = ap.parse_args()
    {"window": window, "cost": cost, "probe": probe}[args.what](args)


if __name__ == "__main__":
    main()
