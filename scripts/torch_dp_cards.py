"""The data-parallel step of the flagship with one rank per card, nccl.

    python scripts/torch_dp_cards.py [--batch 16]

Builds the kernels, then runs chip_smoke.py's 2-rank check with as many
ranks as the host has cards, each on its own card (torchrun's LOCAL_RANK,
`--device cuda`) over NCCL: one train() step of config/proc16k.json in
float32 at `--batch` clips a rank, its step captured into one CUDA graph a
rank with the collectives inside and replayed (12 launches of each training
kernel a rank: 3 warm-ups and the replay), held against the single-process
step on the first card on the same clips in rank-major order (loss terms
1e-5 and grad_norm 1e-4 relative, parameters by phase 5's measure, the
replicas bit-equal); then each rank's replayed step and its body
(`replay=False`) timed beside the single-process step. Prints the report as
one JSON line and the card's name and power limit; needs two cards or more.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tinyrecurrentunet_torch.config import load_config  # noqa: E402
from tinyrecurrentunet_torch.ops import build  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16, help="clips a rank")
    args = parser.parse_args(argv)
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"scripts/torch_dp_cards.py needs two cards or more, this host has {cards}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    cfg = chip_smoke.float32_training(load_config(chip_smoke.CONFIG))
    report, _ = chip_smoke.data_parallel_step(cfg, ranks=cards, batch=args.batch, backend="nccl", device="cuda")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
