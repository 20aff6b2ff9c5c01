"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 trubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell (`trubench/workloads/<cell>.json`),
its configuration and its traffic mix by name, makes its inputs and weights
from the seed, warms up (set-up), measures for `--seconds`, checks what the
timed path produced against the plain reference, and prints as the last
line of standard output one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`), `device`, with `--trace 1` `breakdown`, and
last `checks`, each compared number beside its limit, which also end
standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), without the program beside it, or where JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds go to build/trunet_torch_kernels)."""
    os.environ.setdefault("TORCH_KERNEL_CACHE_PATH", str(ROOT / "build" / "torch_kernels"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))


def _applies(entry: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def context(workload: str, seed: int, seconds: float, trace: bool):
    from trubench import harness

    cell = harness.load_json("workloads", workload)
    config = harness.load_json("configs", cell["config"])
    return harness.Context(workload, seed, seconds, trace, cell, config, t0=T0, root=ROOT)


def check_card(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.exit(f"trubench: the cell needs {chips} CUDA card(s), found {found}")


def report(ctx, outcome, benchmark: dict) -> dict:
    """The result line of a finished run."""
    import torch

    from trubench import harness

    if ctx.trace:
        reading = {"facts": outcome.facts, "slice": outcome.slice}
        reported = {m["name"] for m in benchmark["end_to_end"] if _applies(m, ctx.workload)}
        metrics = {}
        for entry in benchmark["per_layer"]:
            if _applies(entry, ctx.workload, reported):
                value = harness.load_module("metrics", entry["name"]).read(reading)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in benchmark["end_to_end"] if _applies(m, ctx.workload)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ctx.cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes, "power_limit": harness.power_limit()}
    result = {"correct": all(c.ok for c in outcome.checks) and outcome.failed == 0,
              "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics, "device": device}
    if ctx.trace:
        sl = outcome.slice
        # averaged over the cards where a run reads several
        device.update(busy_s=outcome.facts.get("busy_s", sl.busy_s()),
                      window_s=outcome.facts.get("traced_window_s", sl.seconds))
        result["breakdown"] = {"device_ops": sl.device_ops(), "idle_gaps": sl.named_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from trubench import harness

    with open(ROOT / "BENCHMARK.json") as f:
        benchmark = json.load(f)
    ctx = context(args.workload, args.seed % 2**63, args.seconds, bool(args.trace))
    check_card(ctx.cell["chips"])
    import tinyrecurrentunet_torch  # noqa: F401  the program under test; without it the run ends here

    outcome = harness.load_module("traffic", ctx.cell["traffic"]).run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"trubench: loaded in the process that reports: {found}", file=sys.stderr)
        return 4
    result = report(ctx, outcome, benchmark)
    print(f"failed {outcome.failed} of {outcome.attempted}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
