"""What every run of every cell shares: finding the cell's files by name,
the card, the program's configuration, the window, the checks and the
result line.

A cell is `workloads/<cell>.json` (its configuration, its traffic mix and
the mix's parameters, its chips and its checks' limits). The configuration
is `configs/<config>.json`, the mix `traffic/<mix>.py` (a module with
`run(ctx) -> Outcome`), each per-layer metric `metrics/<metric>.py` (a
module with `read(reading) -> float | None`). `BENCHMARK.json` at the root
of the checkout lists which metrics a cell reports.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tinyrecurrentunet_tpu")


def load_json(kind: str, name: str, root: pathlib.Path = HERE) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: pathlib.Path = HERE):
    """`<root>/<kind>/<name>.py` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"trubench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def span(name: str, on: bool):
    """A record_function span named `bench.<name>` where `on`, else nothing."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(f"bench.{name}"):
        yield


@dataclasses.dataclass
class Check:
    """One number compared for `correct`, beside its limit (passes when <=)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def checks(numbers: dict, ctx: "Context", names) -> list:
    """`numbers[name]` beside the cell's limit, for each of `names`: the
    program's checks, or the control's, read in the program's place."""
    return [Check(name, numbers[name], ctx.limit(name)) for name in names]


@dataclasses.dataclass
class Outcome:
    """What a traffic mix's run hands back."""

    end_to_end: dict  # e2e metric name -> value, measured in the window
    attempted: int
    failed: int
    checks: list  # of Check
    memory_peak_bytes: int
    facts: dict = dataclasses.field(default_factory=dict)  # what per-layer readers read beside the slice
    slice: object = None  # trace.Slice of the traced run


@dataclasses.dataclass
class Context:
    """A run: its arguments, the cell, its configuration, and the clock."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    device: str = "cuda"
    t0: float = 0.0
    root: pathlib.Path = HERE.parent
    calibrate: bool = False  # also read the control, in the program's place, on the same inputs
    fault: object = None  # fault(program): breaks the timed path underneath, for the harness's tests

    @property
    def params(self) -> dict:
        return self.cell["params"]

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])

    def setup_s(self) -> float:
        return time.monotonic() - self.t0

    def program_config(self):
        """The port's Config from the repository's config file the
        configuration names, held to the values the configuration states."""
        from tinyrecurrentunet_torch.config import load_config

        cfg = load_config(str(self.root / self.config["repo_config"]))
        stated = dataclasses.asdict(cfg)
        mismatch = [f"{section}.{key}" for section, key, got in (
            *(("network", k, stated["network"][k]) for k in self.config["network"]),
            *(("featurizer", k, stated["featurizer"][k]) for k in self.config["featurizer"]),
            *(("train.loss_config", k, stated["train"]["loss_config"][k]) for k in self.config["loss"]),
            *(("train.optimization", k, stated["train"]["optimization"][k]) for k in self.config["optimization"]),
        ) if _plain(got) != _plain(_stated(self.config, section, key))]
        if mismatch:
            raise ValueError(f"the program's configuration differs from {self.config['name']}'s file: {mismatch}")
        return cfg


def _stated(config: dict, section: str, key: str):
    return config[{"network": "network", "featurizer": "featurizer", "train.loss_config": "loss",
                   "train.optimization": "optimization"}[section]][key]


def _plain(value):
    """Tuples as lists, recursively, for comparing a dataclass with JSON."""
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def errors(pairs) -> dict:
    """Over (output, reference) waveforms, the worst of each: `rms_err_rel`,
    the RMS of the difference over the reference's RMS; `max_err_rel`, the
    largest absolute difference over the reference's largest sample."""
    pairs = [(np.asarray(out, np.float64), np.asarray(ref, np.float64)) for out, ref in pairs]
    return {"rms_err_rel": max(float(np.linalg.norm(o - r) / np.linalg.norm(r)) for o, r in pairs),
            "max_err_rel": max(float(np.max(np.abs(o - r)) / np.max(np.abs(r))) for o, r in pairs)}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def reference_device(device: str):
    """TF32 off for the reference's float32 products and convolutions."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def free_program():
    """Collects what the program left once the caller dropped it (its graphs,
    pools and caches), so the reference that follows finds the card's
    memory free."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def tf32():
    """TF32 on for products and convolutions inside the block: the control
    of a float32 configuration."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def settle(device: str):
    """Set-up's queued work finished before the window opens."""
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    """The process's peak of allocated device memory so far (set-up included)."""
    import torch

    if device != "cuda":
        return 0
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())
