"""A cell at a size the CPU holds: the flagship's STFT and loss with narrow
layers (`tiny16k.json`), run through the same harness on the CPU."""

from __future__ import annotations

import dataclasses
import json
import pathlib

from trubench import harness

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]

PARAMS = {
    "train": {"corpus": 12, "check_steps": 3, "max_steps": 64, "inflight": 2, "slice_steps": 2, "named_steps": 1},
    "train_dp": {"ranks": 4, "corpus": 12, "check_steps": 3, "max_steps": 64, "slice_steps": 2, "named_steps": 1},
    "stream": {"streams": 4, "clips": 2, "clip_s": 0.5, "sample_streams": 2, "slice_calls": 4, "named_calls": 2},
    "denoise": {"pool": 4, "min_s": 0.3, "max_s": 1.2, "sample_every": 2, "sample": 3, "slice_calls": 3,
                "named_calls": 2},
}
OPEN = {"train": {"loss_gap": 1e9, "change_gap": 1e9, "grad_dir_gap": 1e9},
        "train_dp": {"loss_gap": 1e9, "change_gap": 1e9, "grad_dir_gap": 1e9, "replica_gap": 1e9},
        "stream": {"rms_err_rel": 1e9},
        "denoise": {"rms_err_rel": 1e9}}


def config() -> dict:
    """The tiny configuration in the benchmark's form, with seeded weights."""
    import torch

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.models import TRUNet
    from trubench.reference import weights

    cfg = load_config(str(HERE / "tiny16k.json"))
    c = dataclasses.asdict(cfg)
    net = {k: c["network"][k] for k in harness.load_json("configs", "proc16k")["network"]}
    net["encoder"], net["decoder"] = [list(r) for r in net["encoder"]], [list(r) for r in net["decoder"]]
    loss = json.loads(json.dumps(c["train"]["loss_config"]))
    state = weights.seeded(TRUNet(cfg.network).state_dict(), 3, "cpu")
    return {"name": "tiny16k", "repo_config": "trubench/tests/tiny16k.json", "network": net,
            "featurizer": json.loads(json.dumps(c["featurizer"])), "loss": loss,
            "optimization": c["train"]["optimization"], "crop_length_sec": c["trainset"]["crop_length_sec"],
            "train_dtype": "bfloat16", "state_dict": {k: v.to(torch.float32) for k, v in state.items()}}


def context(traffic: str, seed: int = 11, seconds: float = 0.3, limits: dict | None = None, **kw) -> harness.Context:
    cell = {"config": "tiny16k", "traffic": traffic, "chips": 1, "params": PARAMS[traffic],
            "limits": limits or OPEN[traffic]}
    return harness.Context(f"tiny-{traffic}", seed, seconds, False, cell, config(), device="cpu", root=ROOT, **kw)


def run(traffic: str, **kw) -> harness.Outcome:
    ctx = context(traffic, **kw)
    return harness.load_module("traffic", traffic).run(ctx)
