"""The benchmark finds its cells, configurations, traffic mixes and metrics
by name, and a new cell, mix or metric needs only new files."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from trubench import harness
from trubench.tests.tiny import ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCHMARK[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(e["name"] for e in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"])) == \
        len(BENCHMARK["end_to_end"]) + len(BENCHMARK["per_layer"])
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"])
    assert all(1 <= len(w["why"]) <= 200 and "\n" not in w["why"] for w in BENCHMARK["workloads"])
    assert any(m["name"] == "setup_s" for m in BENCHMARK["end_to_end"])
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == cell)
    w = harness.load_json("workloads", cell)
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == \
        (entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert callable(harness.load_module("traffic", w["traffic"]).run)
    config = next(c for c in BENCHMARK["configs"] if c["name"] == w["config"])
    assert harness.load_json("configs", w["config"])["reduced"] == config["reduced"]
    assert (ROOT / config["file"]).is_file()
    reported = [m for m in BENCHMARK["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    assert {m["name"] for m in reported} > {"setup_s"}
    assert any(cell in m["workloads"] for m in BENCHMARK["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCHMARK["per_layer"]])
def test_metric_declares_what_the_manifest_says(metric):
    entry = next(m for m in BENCHMARK["per_layer"] if m["name"] == metric)
    module = harness.load_module("metrics", metric)
    assert (module.LAYER, module.UNIT, module.MOVES, module.WORKLOADS) == \
        (entry["layer"], entry["unit"], entry["moves"], entry["workloads"])
    assert module.read({"facts": {}, "slice": None}) is None  # nothing to read: nothing reported


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix and a metric by
    adding files (and manifest entries); the harness reports the new metric
    in the new cell without a file that was there being edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "trubench", copy / "trubench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    (copy / "trubench/traffic/echo.py").write_text(
        "from trubench import harness\n\n\ndef run(ctx):\n"
        "    return harness.Outcome({'echo_s': 1.0, 'setup_s': 0.5}, 3, 0, [], 0, {'calls': ctx.params['calls']})\n")
    (copy / "trubench/workloads/proc16k-echo.json").write_text(json.dumps(
        {"config": "proc16k", "traffic": "echo", "chips": 1, "why": "a test cell", "params": {"calls": 3},
         "limits": {}}))
    (copy / "trubench/metrics/echo_calls.py").write_text(
        "LAYER = 'echo'\nUNIT = 'calls'\nMOVES = 'echo_s'\nWORKLOADS = ['proc16k-echo']\n\n\n"
        "def read(reading):\n    return reading['facts'].get('calls')\n")
    manifest = json.loads(json.dumps(BENCHMARK))
    manifest["workloads"].append({"name": "proc16k-echo", "config": "proc16k", "traffic": "echo", "chips": 1,
                                  "why": "a test cell"})
    manifest["end_to_end"].append({"name": "echo_s", "unit": "s", "better": "lower", "bound": 0.1,
                                   "source": "host_clock", "workloads": ["proc16k-echo"]})
    manifest["per_layer"].append({"name": "echo_calls", "unit": "calls", "better": "higher",
                                  "source": "program_counter", "layer": "echo", "moves": "echo_s",
                                  "workloads": ["proc16k-echo"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    script = (
        "import json, sys, types\n"
        f"sys.path.insert(0, {str(copy)!r})\n"
        "sys.modules['torch'] = types.SimpleNamespace(cuda=types.SimpleNamespace(get_device_name=lambda i: 'test'))\n"
        "from trubench import run, harness\n"
        "run.ROOT = harness.HERE.parent\n"
        "bench = json.loads((run.ROOT / 'BENCHMARK.json').read_text())\n"
        "for trace in (False, True):\n"
        "    ctx = run.context('proc16k-echo', 1, 1.0, trace)\n"
        "    out = harness.load_module('traffic', ctx.cell['traffic']).run(ctx)\n"
        "    out.slice = type('S', (), {'busy_s': lambda s: 1.0, 'seconds': 2.0, 'device_ops': lambda s: [],\n"
        "                               'named_gaps': []})()\n"
        "    print(json.dumps(run.report(ctx, out, bench)['metrics']))\n")
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    plain, traced = (json.loads(line) for line in done.stdout.strip().splitlines())
    assert plain == {"echo_s": {"value": 1.0, "unit": "s"}, "setup_s": {"value": 0.5, "unit": "s"}}
    assert traced == {"echo_calls": {"value": 3, "unit": "calls"}}
    after = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*")
             if p.is_file() and "__pycache__" not in str(p)}
    assert all(after[k] == v for k, v in before.items())  # no file that was there changed
