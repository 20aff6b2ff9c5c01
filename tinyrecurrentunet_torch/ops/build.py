"""Builds the CUDA sources in `ops/csrc/` at first use and loads them.

Each `csrc/<name>.cu` is compiled by nvcc, on its own, into a shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/trunet_torch_kernels/lib<name>-<hash>.so

and loaded with ctypes. The file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
build directory is `build/trunet_torch_kernels/` at the root of the checkout
(`build/` is in .gitignore). Only the sources in the repository are built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "trunet_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def kernel_names() -> list[str]:
    """Names of every CUDA source of the port (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """Where the library built from `csrc/<name>.cu` goes."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Builds the named sources (default: all) in parallel, one nvcc each.

    Returns {name: compiler output} for the sources compiled by this call;
    raises RuntimeError, with the compiler's output, if any build fails.
    """
    names = kernel_names() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            lib,
        )
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built first if needed."""
    lib = library_path(name)
    if not lib.exists():
        build_all([name])
    return ctypes.CDLL(str(lib))
