"""The port's config loader parses every shipped config like the JAX one,
and the port stays free of JAX."""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from tinyrecurrentunet_torch.config import load_config as torch_load_config
from tinyrecurrentunet_tpu.config import load_config as jax_load_config

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*.json")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_parses_like_jax(path):
    """Exact equality: both loaders read the same JSON into the same schema."""
    assert dataclasses.asdict(torch_load_config(path)) == dataclasses.asdict(
        jax_load_config(path)
    )


def test_shipped_configs_found():
    assert len(CONFIGS) >= 8


def _port_sources():
    pkg = os.path.join(REPO, "tinyrecurrentunet_torch")
    files = glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)
    files += glob.glob(os.path.join(pkg, "**", "*.cu"), recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


_FORBIDDEN = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+flax|from\s+flax)\b|tinyrecurrentunet_tpu", re.M)


def test_port_sources_never_import_jax_or_the_jax_package():
    """Grep every module of the port and chip_smoke.py. Docstrings may name
    JAX-package files by path, so a path mention is allowed only inside a
    string that names a file (`tinyrecurrentunet_tpu/...`), never as an
    import or a dotted module name."""
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                for m in _FORBIDDEN.finditer(line):
                    if m.group(0) == "tinyrecurrentunet_tpu" and line[m.end():].startswith("/"):
                        continue
                    offenders.append(f"{os.path.relpath(path, REPO)}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, chip_smoke, tinyrecurrentunet_torch.infer.denoise, "
        "tinyrecurrentunet_torch.ops.cuda_gru, tinyrecurrentunet_torch.weights, "
        "tinyrecurrentunet_torch.losses, tinyrecurrentunet_torch.train.loop, "
        "tinyrecurrentunet_torch.train.checkpoint, tinyrecurrentunet_torch.data.dataset, "
        "tinyrecurrentunet_torch.data.loader, tinyrecurrentunet_torch.utils.metrics, "
        "tinyrecurrentunet_torch.infer.streaming, tinyrecurrentunet_torch.infer.multistream, "
        "tinyrecurrentunet_torch.infer.stream, tinyrecurrentunet_torch.infer.soak, "
        "tinyrecurrentunet_torch.runtime, tinyrecurrentunet_torch.infer.quality, "
        "tinyrecurrentunet_torch.export.quantize, tinyrecurrentunet_torch.data.procgen, "
        "tinyrecurrentunet_torch.data, tinyrecurrentunet_torch.infer.oracle, tinyrecurrentunet_torch.parallel, "
        "tinyrecurrentunet_torch.utils.params, tinyrecurrentunet_torch.utils.profiling, "
        "tinyrecurrentunet_torch.train.export_pretrained, tinyrecurrentunet_torch.train.scaling; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tinyrecurrentunet_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
