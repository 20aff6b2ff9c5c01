"""Quickstart of the PyTorch port: train -> denoise -> stream -> export, end to
end, no corpus. The port's counterpart of examples/quickstart.py.

Runs on one NVIDIA card (default) or the CPU (`--device cpu`, slow at
this width: use few iterations) on the synthetic dataset of
config/synthetic16k.json.

    python examples/quickstart_torch.py [--iters 500] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=500)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from tinyrecurrentunet_torch.config import LogConfig, load_config
    from tinyrecurrentunet_torch.data import SyntheticPairDataset
    from tinyrecurrentunet_torch.export.export import export_program
    from tinyrecurrentunet_torch.export.quantize import save_quantized
    from tinyrecurrentunet_torch.infer.denoise import Denoiser
    from tinyrecurrentunet_torch.infer.metrics import si_sdr
    from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser
    from tinyrecurrentunet_torch.train.loop import train
    from tinyrecurrentunet_torch.weights import artifact_meta, variables_from_state_dict

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    workdir = tempfile.mkdtemp(prefix="trunet_quickstart_")
    cfg = load_config(os.path.join(repo, "config", "synthetic16k.json"))
    cfg = dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train,
            log=LogConfig(
                directory=f"{workdir}/ckpt",
                iters_per_ckpt=max(args.iters // 2, 1),
                iters_per_valid=max(args.iters // 10, 1),
            ),
        ),
    )

    # 1. train on synthetic clean/noisy pairs, with held-out validation
    train_ds = SyntheticPairDataset(1024, 2.0, 16000, seed=0)
    valid_ds = SyntheticPairDataset(16, 2.0, 16000, seed=999)
    print(f"training {args.iters} iterations on {args.device} (checkpoints under {workdir})...")
    train(cfg, dataset=train_ds, valid_dataset=valid_ds, max_iters=args.iters, log_dir=f"{workdir}/logs",
          device=args.device)

    # 2. offline denoise a held-out clip
    test_ds = SyntheticPairDataset(4, 2.0, 16000, seed=555)
    clean, noisy, _ = test_ds.get(0, np.random.default_rng(0))
    denoiser = Denoiser.from_checkpoint(cfg, "max", device=args.device)
    enhanced = denoiser(noisy)
    print(f"offline:   SI-SDR {si_sdr(noisy, clean):.2f} dB -> {si_sdr(enhanced, clean):.2f} dB")

    # 3. stream the same clip block by block with carried state
    state_dict = denoiser.model.state_dict()
    streamed, _ = StreamingDenoiser(cfg, state_dict, device=args.device).process(noisy)
    print(f"streaming: SI-SDR {si_sdr(streamed[384:], clean[:len(streamed) - 384]):.2f} dB "
          f"(3-hop latency compensated)")

    # 4. export: the forward and streaming-step programs + the int8 pack
    paths = export_program(cfg, state_dict, f"{workdir}/export")
    variables = variables_from_state_dict(state_dict)
    size = save_quantized(f"{workdir}/export/model_int8.trq", variables["params"], variables["batch_stats"],
                          meta=artifact_meta(cfg))
    print(f"exported: {list(paths)} + int8 pack ({size / 1024:.0f} KB) under {workdir}/export")


if __name__ == "__main__":
    main()
