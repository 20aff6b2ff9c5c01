"""Readings behind the limits and bounds of a cell, several seeds in one
process (set-up's import and the card's start paid once):

    python3 trubench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s> [--trace 1] [--control 1]

Each seed is a whole run of the cell as `run.py` makes it, printed as one
JSON line: the end-to-end (or, traced, per-layer) metrics, the numbers the
check compares, and with `--control 1` the same numbers with the control
(the reference in the nearest lower precision) and, for training, the
reference that leaves half of the batch out, each in the program's place,
and `control_correct`, whether the control passes the cell's limits.
The benchmark's own runs never read the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import run  # noqa: E402

from trubench import harness  # noqa: E402

CALIBRATION = ("program", "control", "half_batch", "unmoved", "excluded_leaves", "worst_leaves",
               "reference_peak_bytes")  # facts a traffic mix reads for calibration


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--control", type=int, default=0)
    args = parser.parse_args(argv)
    run._caches()
    with open(run.ROOT / "BENCHMARK.json") as f:
        benchmark = json.load(f)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.context(args.workload, seed, args.seconds, bool(args.trace))
        run.check_card(ctx.cell["chips"])
        ctx.calibrate = bool(args.control)
        ctx.t0 = run.time.monotonic()
        outcome = harness.load_module("traffic", ctx.cell["traffic"]).run(ctx)
        line = run.report(ctx, outcome, benchmark)
        line.update(seed=seed, e2e=outcome.end_to_end,
                    calibration={k: outcome.facts[k] for k in CALIBRATION
                                 if k in outcome.facts})
        if "control_checks" in outcome.facts:  # the control held to the cell's limits in the program's place
            line["control_correct"] = all(c.ok for c in outcome.facts["control_checks"])
        print(json.dumps(line), flush=True)
    print("forbidden modules:", harness.forbidden_modules(), file=sys.stderr)


if __name__ == "__main__":
    main()
