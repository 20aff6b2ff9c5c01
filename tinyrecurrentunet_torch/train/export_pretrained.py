"""Snapshot a training checkpoint of the port as a standalone pretrained.npz,
counterpart of `tinyrecurrentunet_tpu/train/export_pretrained.py`.

It restores `<log directory>/<exp_path>/checkpoint/<iter>.pt` and writes
the parameters and BatchNorm running statistics, with the config's
decode-critical settings under `meta/`, in the JAX package's key layout
(`train/checkpoint.py save_pretrained_params`): the file both packages'
Denoisers load (`Denoiser.from_pretrained`, the JAX package's
`load_pretrained_variables`), without the optimizer state.

Usage:
    python -m tinyrecurrentunet_torch.train.export_pretrained \
        -c config/proc16k.json [--ckpt_iter max] --out artifacts/TRUNet-proc [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from tinyrecurrentunet_torch.config import load_config
from tinyrecurrentunet_torch.infer.denoise import resolve_device
from tinyrecurrentunet_torch.train.checkpoint import CheckpointManager, save_pretrained_params
from tinyrecurrentunet_torch.train.state import create_train_state
from tinyrecurrentunet_torch.weights import artifact_meta


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--ckpt_iter", default="max", help="max | iteration")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)

    state = create_train_state(cfg, device=resolve_device(args.device))
    mgr = CheckpointManager(cfg.train.log.directory, cfg.train.exp_path)
    state, step, _ = mgr.restore(state, args.ckpt_iter)
    if step < 0:
        raise FileNotFoundError(
            f"no checkpoint for selector {args.ckpt_iter!r} under {cfg.train.log.directory}/{cfg.train.exp_path}"
        )
    save_pretrained_params(args.out, state.model, meta=artifact_meta(cfg))
    path = os.path.join(args.out, "pretrained.npz")
    print(f"wrote {path} ({os.path.getsize(path) / 1024:.1f} KB) from step {step}")
    return path


if __name__ == "__main__":
    main()
