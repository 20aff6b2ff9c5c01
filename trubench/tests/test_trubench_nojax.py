"""Nothing of the benchmark loads JAX or the JAX package: every module of
trubench imported, and a cell's CPU pieces run, in a fresh process; each
loaded module's top-level name compared whole (the port's name begins with
the JAX package's)."""

from __future__ import annotations

import subprocess
import sys

from trubench import harness
from trubench.tests.tiny import ROOT

SCRIPT = """
import pathlib, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from trubench import harness
for path in sorted(pathlib.Path({root!r}, "trubench").rglob("*.py")):
    rel = path.relative_to({root!r})
    if rel.parts[1] in ("traffic", "metrics"):
        harness.load_module(rel.parts[1], path.stem)
    elif rel.parts[1] != "tests" and path.name != "calibrate.py":
        __import__(".".join(rel.with_suffix("").parts))
from trubench.inputs import procgen
from trubench.reference import net, serve, signal, weights
from trubench.work import model
from trubench.tests import tiny
config = tiny.config()
audio = procgen.noisy_pair(np.random.default_rng(0), 8000, 16000, "babble")[1]
serve.denoise(config["state_dict"], config, audio, "cpu")
harness.load_module("traffic", "stream").Streams(1, tiny.PARAMS["stream"], 16000, 128).block(3)
print("forbidden:" + ",".join(harness.forbidden_modules()))
print("loaded:" + ",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_loaded():
    done = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT))], capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    forbidden, loaded = (line.split(":", 1)[1] for line in done.stdout.strip().splitlines()[-2:])
    assert forbidden == ""
    assert "tinyrecurrentunet_torch" in loaded.split(",")  # the port, whose name begins with the JAX package's
    assert not set(loaded.split(",")) & set(harness.FORBIDDEN)


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tinyrecurrentunet_tpux", object())
    monkeypatch.setitem(sys.modules, "jaxish.sub", object())
    assert harness.forbidden_modules() == [] or set(harness.forbidden_modules()) <= set(harness.FORBIDDEN) - {
        "tinyrecurrentunet_tpu", "jax"}
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
