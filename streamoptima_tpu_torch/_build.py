"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: ``nvcc``
compiles every source under ``csrc/`` into one shared library for
``sm_90a`` at first use, into ``build/streamoptima_tpu_torch/`` beside the
package (git-ignored).  The library name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a stale one never loaded.  Nothing
is built or loaded at import time; CPU-only use never reaches this module's
build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "streamoptima_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Build(NamedTuple):
    path: Path
    seconds: float
    cached: bool  # True: a library for these exact sources already existed
    log: str  # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstreamoptima_kernels_{h.hexdigest()[:16]}.so"


def build() -> Build:
    """Compile the kernels unless a library for these exact sources exists."""
    so = _library_path()
    t0 = time.perf_counter()
    if so.exists():
        return Build(so, time.perf_counter() - t0, True, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return Build(so, time.perf_counter() - t0, False, res.stdout + res.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.so_full_search.argtypes = [p, p, i, i, i, i, i, p, p, p, p, p]
    lib.so_full_search.restype = i
    lib.so_pred_fetch.argtypes = [p, p, i, i, i, i, p, p]
    lib.so_pred_fetch.restype = i
    return lib
