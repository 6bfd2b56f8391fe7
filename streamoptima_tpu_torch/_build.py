"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: ``nvcc``
compiles every source under ``csrc/`` (one process per source, all started
together) and links them into one shared library for ``sm_90a`` at first
use, into ``build/streamoptima_tpu_torch/`` beside the
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):  # the sources and the headers they share
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
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for src, obj in zip(_sources(), objs)]
    try:
        log = [p.communicate(timeout=900)[0] for p in procs]
    finally:  # no compiler outlives a failed or timed-out build
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for src, p, out in zip(_sources(), procs, log):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({p.returncode}):\n{out}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return Build(so, time.perf_counter() - t0, False, "".join(log) + res.stdout + res.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    band = [i, i, i, i]  # bandh, band_row0, g_row0, H
    lib.so_full_search.argtypes = [p, p, i, i, i, i, i, *band, p, p, p, p, p]
    lib.so_full_search.restype = i
    lib.so_full_search_vbs.argtypes = [p, p, i, i, i, i, i, *band, p, p, p, p, p, p, p]
    lib.so_full_search_vbs.restype = i
    lib.so_full_search_fme.argtypes = [p, p, i, i, i, i, i, *band, p, p, p, p]
    lib.so_full_search_fme.restype = i
    lib.so_full_search_fme_vbs.argtypes = [p, p, i, i, i, i, i, *band, p, p, p, p, p, p, p]
    lib.so_full_search_fme_vbs.restype = i
    lib.so_pred_fetch.argtypes = [p, p, p, i, i, i, i, i, *band, i, p, p, p]  # ..., quad_margin, ...
    lib.so_pred_fetch.restype = i
    lib.so_window_fetch.argtypes = [p, p, p, i, i, i, i, i, i, p, p]
    lib.so_window_fetch.restype = i
    lib.so_rowscan_pass.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p]
    lib.so_rowscan_pass.restype = i
    lib.so_rowscan_pass_smem.argtypes = [i, i, i]  # nref, bs, fme
    lib.so_rowscan_pass_smem.restype = i
    L = ctypes.c_longlong
    # win, cur, g, X, Y, nb, P, n, fme, vbs, DH, DW, mv, sad, ok, sub_mv, sub_sad, sub_ok, stream
    lib.so_fast_confirm.argtypes = [p, p, p, p, p, i, i, i, i, i, L, L, *[p] * 7]
    lib.so_fast_confirm.restype = i
    lib.so_fast_confirm_smem.argtypes = [i, i, i]  # P, n, fme
    lib.so_fast_confirm_smem.restype = i
    lib.so_dct_scipy.argtypes = [p, p, i, i, i, p]  # in, out, nb, n, inverse, stream
    lib.so_dct_scipy.restype = i
    lib.so_intra_recon.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p]  # rf, rq, split, mv, smv, nbr, nbc, bs, sr, ...
    lib.so_intra_recon.restype = i
    f = ctypes.c_float
    # res_full, res_quads, sad_full, sad_quads, ok_full, ok_quads, qps, eligible, a_full, a_quad, scan_full,
    # scan_quad, nb, n, qp_nominal, lam, frame_type, split, qtc_full, qtc_quads, lens, mae, stream
    lib.so_transform_select.argtypes = [*[p] * 12, i, i, i, f, i, p, p, p, p, p, p]
    lib.so_transform_select.restype = i
    # qf, qq, wide, qps, a_full, a_quad, nb, nbc, n, rf_out, rq_out, pred, pred_q, split, ok, sub_ok, out, stream
    lib.so_residual_recon.argtypes = [p, p, i, p, p, p, i, i, i, *[p] * 9]
    lib.so_residual_recon.restype = i
    # frame, h, w, transpose, bs, sr, canvas_w, vbs, mv, sad, sub_mv, sub_sad, res_full, res_quads, stream
    lib.so_intra_search.argtypes = [p, i, i, i, i, i, i, i, *[p] * 7]
    lib.so_intra_search.restype = i
    # table, frames, nb, n, scan_full, scan_quad, out, out elements, stream
    lib.so_rle_pack.argtypes = [p, i, i, i, p, p, p, ctypes.c_longlong, p]
    lib.so_rle_pack.restype = i
    # buf, frames, nb, n, scan_full, scan_quad, out, stream
    lib.so_rle_unpack.argtypes = [p, i, i, i, p, p, p, p]
    lib.so_rle_unpack.restype = i
    return lib
