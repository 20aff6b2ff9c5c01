"""The users' data-parallel training CLI on several cards, end to end.

    python scripts/torch_dp_cli.py [--layouts cards,hosts] [--items 256] [--timeout 150] \
        [--tree DIR] [--out dp_cli.json]

Builds the kernels, then for each layout runs, in a fresh directory under
build/, the flagship as shipped (config/proc16k.json, bf16) at 16 clips a
rank on the procedural corpus, validation and checkpoints every 2
iterations, twice: `--max_iters 5` (iterations 0-4: checkpoints 2 and 4),
then `--max_iters 6`, which must resume from checkpoint 4
(`chip_smoke.cli_resume_pair`). Layouts, each over every visible card:

- cards: `python -m tinyrecurrentunet_torch.train.loop ... --data_parallel`
  alone, which starts a rank per card;
- hosts: two such processes, each seeing half the cards
  (CUDA_VISIBLE_DEVICES), joined as two hosts through cfg.dist
  (coordinator on a free localhost port, num_processes 2, process_id 0 and
  1): 2 x (cards / 2) ranks;
- torchrun: the CLI under `python -m torch.distributed.run --standalone
  --nproc_per_node <cards>`.

`--tree DIR` runs the CLI of another checkout (an older commit unpacked
with `git archive` under build/), its kernels built there first; the
working directories are then build/dp_cli_<layout>_<DIR's name>.

Each run is held to `chip_smoke.cli_failures`: every launcher exits 0
within `--timeout` and every rank prints its end (`rank r ended`), rank 0
logs as many ranks as there are cards and a global batch of 16 x that, a
validation pass, the checkpoints announced once each by process 0's
launcher, the resume. Prints the card's name and power limit and the
report as one JSON line (also written to `--out`): per run the exit codes,
wall seconds, the seconds to the first logged iteration, seconds a step,
and the seconds from the last step's line to each rank's end and to the
launchers' exit. Exits 1 if any run missed anything.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tinyrecurrentunet_torch.config import load_config  # noqa: E402
from tinyrecurrentunet_torch.ops import build  # noqa: E402


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def layout_commands(layout: str, cfg, workdir: str, cards: int, items: int, tree: str):
    """commands_for(iters) of `layout` (module docstring), the CLI of the
    checkout `tree`."""
    env = {"PYTHONPATH": tree}
    if layout == "hosts":
        half = cards // 2
        visible = [",".join(str(c) for c in range(h * half, (h + 1) * half)) for h in range(2)]

        def commands(iters):
            address = f"127.0.0.1:{free_port()}"
            return [(chip_smoke.cli_command(
                        chip_smoke.cli_config(cfg, os.path.join(workdir, f"host{h}.json"), coordinator_address=address,
                                              num_processes=2, process_id=h), iters, items),
                     {**env, "CUDA_VISIBLE_DEVICES": visible[h]}) for h in range(2)]

        return commands
    cfg_path = chip_smoke.cli_config(cfg, os.path.join(workdir, "proc16k_cli.json"))
    launcher = ("-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(cards)) \
        if layout == "torchrun" else ()
    return lambda iters: [(chip_smoke.cli_command(cfg_path, iters, items, launcher), env)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--layouts", default="cards,hosts", help="comma-separated: cards, hosts, torchrun")
    parser.add_argument("--items", type=int, default=256, help="size of the procedural corpus")
    parser.add_argument("--timeout", type=float, default=chip_smoke.CLI_TIMEOUT_S, help="seconds a run may take")
    parser.add_argument("--tree", default=REPO, help="the checkout whose CLI runs (default this one)")
    parser.add_argument("--out", default=None, help="write the report here too")
    args = parser.parse_args(argv)
    cards = torch.cuda.device_count()
    if cards < 1:
        print("scripts/torch_dp_cli.py needs a card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    if tree == REPO:
        build.build_all()
    else:
        subprocess.run([sys.executable, "-c", "from tinyrecurrentunet_torch.ops import build; build.build_all()"],
                       env={**os.environ, "PYTHONPATH": tree}, cwd=tree, check=True, timeout=600)
    suffix = "" if tree == REPO else f"_{os.path.basename(tree)}"
    cfg = load_config(chip_smoke.CONFIG)
    report = {"cards": cards, "tree": os.path.relpath(tree, REPO), "nvidia_smi": chip_smoke.nvidia_smi_line(),
              "layouts": {}}
    missed = {}
    for layout in args.layouts.split(","):
        workdir = chip_smoke.phase_workdir(f"dp_cli_{layout}{suffix}")
        ckpt_dir = os.path.join(workdir, "ckpt", cfg.train.exp_path, "checkpoint")
        runs, failures = chip_smoke.cli_resume_pair(layout_commands(layout, cfg, workdir, cards, args.items, tree),
                                                    workdir, ckpt_dir, cards, args.timeout)
        report["layouts"][layout] = runs
        if any(failures):
            missed[layout] = failures
        print(f"[{layout}] {json.dumps(runs)}", flush=True)
    report["missed"] = missed
    print(report["nvidia_smi"], flush=True)
    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
