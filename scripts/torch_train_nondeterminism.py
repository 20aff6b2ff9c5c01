"""How far two runs of one training step apart lie on the card, and where.

    python scripts/torch_train_nondeterminism.py [--runs 32] [--dtype float32|bf16] [--after 0,3]

Takes the port's train step (`train.step.make_train_step`) on
config/proc16k.json (float32: train_compute_dtype cleared; bf16: as shipped)
on two batches of 64 seeded 2 s synthetic clips taken in turn, as
chip_smoke.py's `train_graph_vs_body` takes them. For each count of steps
in `--after` it trains the initial weights that many steps (uncaptured),
then runs the next step `--runs` times uncaptured (`replay=False`) and
`--runs` times replayed from its CUDA graph, the model's parameters and
buffers written back before each run (the gradients and grad_norm depend on
nothing else). It does so twice: with PyTorch's cuDNN defaults, as
`train()` runs, and with `torch.backends.cudnn.deterministic = True`.
Prints for each:
- grad_norm of every run, body and graph, and its largest relative spread
  (max - min over the median), over the bodies, the graphs and all runs;
- the loss terms' distinct values;
- the parameters whose gradient differs between any two runs, by the spread
  of their gradient's norm;
- the card's name and power limit as nvidia-smi reports them.
The last line is all of it as one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import CONFIG, TRAIN_BATCH, batches_of, float32_training, nvidia_smi_line  # noqa: E402
from tinyrecurrentunet_torch.config import load_config  # noqa: E402
from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset  # noqa: E402
from tinyrecurrentunet_torch.train.state import create_train_state  # noqa: E402
from tinyrecurrentunet_torch.train.step import make_train_step  # noqa: E402


def spread(values) -> float:
    values = sorted(values)
    return (values[-1] - values[0]) / abs(values[len(values) // 2])


def measure(cfg, batches, after: int, runs: int) -> dict:
    """`after` steps, then the next step `runs` times uncaptured and `runs`
    times replayed, each from the weights the `after` steps left."""
    state = create_train_state(cfg, device="cuda")
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    step = make_train_step(cfg, with_carry=False)
    for i in range(after):
        step(state, *batches[i % len(batches)], replay=False)
    clean, noisy = batches[after % len(batches)]
    initial = [t.detach().clone() for t in (*model.parameters(), *model.buffers())]
    results = {"body": [], "graph": []}
    for kind in results:
        for _ in range(runs):
            with torch.no_grad():
                for t, v in zip((*model.parameters(), *model.buffers()), initial):
                    t.copy_(v)
            state.step = after
            _, metrics = step(state, clean, noisy, replay=kind == "graph")
            torch.cuda.synchronize()
            results[kind].append({"metrics": {k: float(v) for k, v in metrics.items()},
                                  "grads": [p.grad.detach().clone() for p in model.parameters()]})
    every = results["body"] + results["graph"]
    norms = {kind: [r["metrics"]["grad_norm"] for r in rows] for kind, rows in results.items()}
    differing = []
    for j, name in enumerate(names):
        grads = torch.stack([r["grads"][j] for r in every])
        entries = int(((grads.amax(0) - grads.amin(0)) > 0).sum())
        if entries:
            param_norms = [g.double().norm().item() for g in grads]
            differing.append({"param": name, "entries_differing": entries, "entries": grads[0].numel(),
                              "grad_norm": param_norms[0], "norm_spread": max(param_norms) - min(param_norms)})
    differing.sort(key=lambda d: -d["norm_spread"])
    return {
        "grad_norm_body": norms["body"], "grad_norm_graph": norms["graph"],
        "rel_spread_body": spread(norms["body"]), "rel_spread_graph": spread(norms["graph"]),
        "rel_spread_all": spread(norms["body"] + norms["graph"]),
        "loss_terms": {k: sorted({r["metrics"][k] for r in every}) for k in every[0]["metrics"] if k != "grad_norm"},
        "params_differing": len(differing), "params": len(names), "largest": differing[:12],
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=32)
    parser.add_argument("--dtype", choices=("float32", "bf16"), default="float32")
    parser.add_argument("--after", default="0", help="steps taken before the step measured, comma-separated")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    cfg = load_config(CONFIG)
    if args.dtype == "float32":
        cfg = float32_training(cfg)
    dataset = SyntheticPairDataset(num_items=2 * TRAIN_BATCH, length_sec=cfg.trainset.crop_length_sec,
                                   sample_rate=cfg.trainset.sample_rate)
    batches = batches_of(dataset, TRAIN_BATCH, 2)
    out = {"config": "proc16k", "dtype": args.dtype, "batch": TRAIN_BATCH, "runs": args.runs}
    for after in (int(a) for a in args.after.split(",")):
        for setting, deterministic in (("cudnn_default", False), ("cudnn_deterministic", True)):
            torch.backends.cudnn.deterministic = deterministic
            key = f"after_{after}_{setting}"
            out[key] = measure(cfg, batches, after, args.runs)
            gc.collect()  # the step's graph and its pool go before the next one's
            torch.cuda.empty_cache()
            print(key, json.dumps({k: v for k, v in out[key].items() if k != "largest"}), flush=True)
    torch.backends.cudnn.deterministic = False
    out["device"] = nvidia_smi_line()
    print(out["device"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
