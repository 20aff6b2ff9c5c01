"""ctypes bindings for the C++ host runtime built from `cpp/`.

A copy of `tinyrecurrentunet_tpu/runtime/native.py` for the port (that
module sits in the JAX package, which the port does not import). The native
layer owns the real-time boundary: lock-free SPSC ring buffers between an
audio producer thread and the inference loop, WAV decode, deadline / xrun
statistics. The ring buffer and the stream host have no Python fallback:
their reason to exist is native wait-free behaviour.

The library is built at first use from `cpp/trunet_host.cc` and
`cpp/wavio.cc` with the flags of `cpp/Makefile`,

    g++ -O2 -fPIC -std=c++17 -shared -o build/trunet_host/libtrunet_host-<hash>.so \
        cpp/trunet_host.cc cpp/wavio.cc

into `build/trunet_host/` at the root of the checkout (`build/` is in
.gitignore). The name carries a hash of the sources and the flags, so an
edited source is rebuilt. Nothing is written into `cpp/`, and the library
that may lie there is never loaded (it may not match this machine's libc).
Without a C++ compiler `load_native` raises; `native_available` says so.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
CPP_DIR = REPO_ROOT / "cpp"
BUILD_DIR = REPO_ROOT / "build" / "trunet_host"
SOURCES = ("trunet_host.cc", "wavio.cc")
HEADERS = ("ringbuffer.h", "wavio.h")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


def library_path() -> pathlib.Path:
    """Where the library built from the current sources goes."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CPP_DIR / name).read_bytes())
    return BUILD_DIR / f"libtrunet_host-{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compiles the library if it is not built yet; returns its path.
    Raises RuntimeError without a compiler or when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found: the native host runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CPP_DIR / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host build failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds each put a whole library in place
    return lib


@functools.cache
def load_native() -> ctypes.CDLL:
    """Load (building first if needed) the native library; raises on failure."""
    lib = ctypes.CDLL(str(build()))
    _configure(lib)
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load_native()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    fp = c.POINTER(c.c_float)
    lib.trunet_rb_create.restype = c.c_void_p
    lib.trunet_rb_create.argtypes = [c.c_size_t]
    lib.trunet_rb_destroy.argtypes = [c.c_void_p]
    for name in ("trunet_rb_push", "trunet_rb_pop"):
        fn = getattr(lib, name)
        fn.restype = c.c_size_t
        fn.argtypes = [c.c_void_p, fp, c.c_size_t]
    for name in ("trunet_rb_available", "trunet_rb_space"):
        fn = getattr(lib, name)
        fn.restype = c.c_size_t
        fn.argtypes = [c.c_void_p]

    lib.trunet_wav_read.restype = c.c_int64
    lib.trunet_wav_read.argtypes = [
        c.c_char_p, fp, c.c_int64, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    lib.trunet_wav_write.restype = c.c_int32
    lib.trunet_wav_write.argtypes = [c.c_char_p, fp, c.c_int64, c.c_int32, c.c_int32]

    lib.trunet_host_create.restype = c.c_void_p
    lib.trunet_host_create.argtypes = [c.c_int32, c.c_int32]
    lib.trunet_host_destroy.argtypes = [c.c_void_p]
    lib.trunet_host_feed.restype = c.c_size_t
    lib.trunet_host_feed.argtypes = [c.c_void_p, fp, c.c_size_t]
    lib.trunet_host_collect.restype = c.c_size_t
    lib.trunet_host_collect.argtypes = [c.c_void_p, fp, c.c_size_t]
    lib.trunet_host_pull_block.restype = c.c_int32
    lib.trunet_host_pull_block.argtypes = [c.c_void_p, fp, c.c_int32]
    lib.trunet_host_push_block.restype = c.c_int32
    lib.trunet_host_push_block.argtypes = [c.c_void_p, fp]
    lib.trunet_host_add_busy.argtypes = [c.c_void_p, c.c_double]
    lib.trunet_host_stats.argtypes = [c.c_void_p, c.POINTER(c.c_double)]
    lib.trunet_now_seconds.restype = c.c_double


class NativeLib:
    """Convenience namespace over the raw CDLL."""

    def __init__(self):
        self.lib = load_native()

    def wav_read(self, path: str):
        sr = ctypes.c_int32()
        ch = ctypes.c_int32()
        n = self.lib.trunet_wav_read(path.encode(), None, 0, ctypes.byref(sr), ctypes.byref(ch))
        if n < 0:
            raise IOError(f"native wav read failed: {path}")
        buf = np.empty(n, np.float32)
        got = self.lib.trunet_wav_read(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            ctypes.byref(sr),
            ctypes.byref(ch),
        )
        if got != n:
            raise IOError(f"native wav re-read mismatch: {path}")
        data = buf.reshape(-1, ch.value).T if ch.value > 1 else buf
        return data, int(sr.value)

    def wav_write(self, path: str, samples: np.ndarray, sample_rate: int, channels: int = 1):
        samples = np.ascontiguousarray(samples, np.float32)
        rc = self.lib.trunet_wav_write(
            path.encode(),
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            samples.size,
            sample_rate,
            channels,
        )
        if rc != 0:
            raise IOError(f"native wav write failed: {path}")


class RingBuffer:
    """SPSC lock-free float ring buffer (native)."""

    def __init__(self, capacity: int):
        self._lib = load_native()
        self._ptr = ctypes.c_void_p(self._lib.trunet_rb_create(capacity))

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        return self._lib.trunet_rb_push(
            self._ptr, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size
        )

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.trunet_rb_pop(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
        )
        return out[:got]

    @property
    def available(self) -> int:
        return self._lib.trunet_rb_available(self._ptr)

    @property
    def space(self) -> int:
        return self._lib.trunet_rb_space(self._ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.trunet_rb_destroy(self._ptr)
            self._ptr = None


class StreamHost:
    """Native full-duplex stream host: input/output rings + xrun stats."""

    def __init__(self, block_size: int, capacity_blocks: int = 64):
        self._lib = load_native()
        self.block_size = block_size
        self._ptr = ctypes.c_void_p(
            self._lib.trunet_host_create(block_size, capacity_blocks)
        )

    # ---- producer (audio/file thread) ----
    def feed(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.float32)
        return self._lib.trunet_host_feed(
            self._ptr,
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            samples.size,
        )

    def collect(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.trunet_host_collect(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
        )
        return out[:got]

    # ---- consumer (inference loop) ----
    def pull_block(self, starved: bool = True):
        out = np.empty(self.block_size, np.float32)
        ok = self._lib.trunet_host_pull_block(
            self._ptr,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            1 if starved else 0,
        )
        return out if ok else None

    def push_block(self, block: np.ndarray) -> bool:
        block = np.ascontiguousarray(block, np.float32)
        if block.size != self.block_size:
            raise ValueError(f"block of {block.size} samples, the host takes {self.block_size}")
        return bool(
            self._lib.trunet_host_push_block(
                self._ptr, block.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
        )

    def add_busy(self, seconds: float):
        self._lib.trunet_host_add_busy(self._ptr, seconds)

    def stats(self) -> dict:
        buf = (ctypes.c_double * 4)()
        self._lib.trunet_host_stats(self._ptr, buf)
        return {
            "blocks_processed": int(buf[0]),
            "input_underruns": int(buf[1]),
            "output_overruns": int(buf[2]),
            "busy_seconds": float(buf[3]),
        }

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.trunet_host_destroy(self._ptr)
            self._ptr = None
