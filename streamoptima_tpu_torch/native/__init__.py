"""Native (C++) host runtime: entropy coding + bitstream serialization.

The port's copy of ``streamoptima_tpu.native``.  ``entropy.cpp`` is host
code, not a device kernel: it turns the fixed-shape coefficient and MV
arrays into the reference's variable-length text lines and parses them
back.  It is compiled with ``g++`` at first use into
``build/streamoptima_tpu_torch/`` beside the package (git-ignored), under a
name that carries a hash of the source and flags.  Every caller handles
``available() == False`` and falls back to the Python twins in
``core/zigzag.py`` / ``bitstream.py``: the output is byte-identical either
way.

The binary container's RLE (``rle_encode_blocks``) runs here for host
arrays only: the list package of a ``package=True`` encode, the compat
engine's, and streams read back by ``read_binary`` or ``read_bitstream``.
A ``package=False`` encode's tensors are coded where they lie by the
``rle_pack`` kernel (``core/kernels.py``, ``binstream.coded_frames_of``),
which writes the same lists.  Its decode (``rle_decode_blocks``) runs where
a frame ``read_binary`` returns is densified on the host
(``binstream.CodedResiduals``); the decoders decode the lists on the device
(the ``rle_unpack`` kernel), to the same coefficients.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "entropy.cpp"
BUILD_DIR = _HERE.parent.parent / "build" / "streamoptima_tpu_torch"
# no -march=native: the library's name hashes the source and flags, not the
# CPU, so a build/ copied to another machine must still load there
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _build_lib() -> Path | None:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libentropy_{h}.so"
    if so.exists():
        return so
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    return so


@functools.lru_cache(maxsize=None)
def _load():
    so = _build_lib()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.encode_residual_line.restype = ctypes.c_int64
    lib.encode_residual_line.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.rle_encode_blocks.restype = ctypes.c_int64
    lib.rle_encode_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.rle_decode_blocks.restype = None
    lib.rle_decode_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.encode_mv_line.restype = ctypes.c_int64
    lib.encode_mv_line.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.parse_residual_line.restype = ctypes.c_int64
    lib.parse_residual_line.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.parse_mv_line.restype = ctypes.c_int64
    lib.parse_mv_line.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def encode_residual_line(qtc_full, qtc_quads, split, numpy_repr: bool) -> str | None:
    """Serialize one frame's residual text line from device-shaped arrays.

    qtc_full (nb, bs, bs), qtc_quads (nb, 4, sbs, sbs), split (nb,) bool.
    Returns None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    qf = np.ascontiguousarray(np.asarray(qtc_full), dtype=np.int64)
    qq = np.ascontiguousarray(np.asarray(qtc_quads), dtype=np.int64)
    sp = np.ascontiguousarray(np.asarray(split), dtype=np.uint8)
    nb, bs = qf.shape[0], qf.shape[-1]
    # worst case: every coefficient its own run, 25 bytes/value with np.int64()
    cap = int(nb * (2 * bs * bs * 25 + 16) + 16)
    buf = np.empty(cap, np.uint8)  # not zeroed: only the written prefix is read
    n = lib.encode_residual_line(
        qf.ctypes.data, qq.ctypes.data, sp.ctypes.data,
        ctypes.c_int64(nb), ctypes.c_int32(bs), ctypes.c_int32(1 if numpy_repr else 0),
        buf.ctypes.data, ctypes.c_int64(cap),
    )
    if n < 0:
        return None
    return buf[:n].tobytes().decode("ascii")


def rle_encode_blocks(blocks) -> tuple[np.ndarray, np.ndarray] | None:
    """Batch RLE of (nblocks, n, n) blocks: (the values concatenated, int64;
    offsets (nblocks + 1,), int64).  Returns None when the native library
    is unavailable."""
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(np.asarray(blocks), dtype=np.int64)
    nblocks, n = b.shape[0], b.shape[-1]
    out = np.empty(nblocks * (2 * n * n + 1), dtype=np.int64)
    offs = np.empty(nblocks + 1, dtype=np.int64)
    total = lib.rle_encode_blocks(b.ctypes.data, ctypes.c_int64(nblocks), ctypes.c_int32(n), out.ctypes.data,
                                  offs.ctypes.data)
    return out[:total].copy(), offs


def rle_decode_blocks(data, offsets, n: int) -> np.ndarray | None:
    """Batch RLE decode: block i from ``data[offsets[i]:offsets[i + 1]]``
    into (nblocks, n, n) int64.  Returns None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    d = np.ascontiguousarray(np.asarray(data), dtype=np.int64)
    offs = np.ascontiguousarray(np.asarray(offsets), dtype=np.int64)
    nblocks = len(offs) - 1
    out = np.empty((nblocks, n, n), dtype=np.int64)
    lib.rle_decode_blocks(d.ctypes.data, offs.ctypes.data, ctypes.c_int64(nblocks), ctypes.c_int32(n),
                          out.ctypes.data)
    return out


def encode_mv_line(frame_type: int, mv, split, smv, qps, rc_active: bool,
                   blocks_per_row: int) -> str | None:
    """Serialize one frame's MV-line body from device-shaped arrays (mv
    (nb,[3]), split (nb,), smv (nb,4[,3]); intra forms may be scalar
    component-0 arrays).  Returns None when unavailable or when the QP rows
    are short for an RC stream (the Python path then raises)."""
    lib = _load()
    if lib is None:
        return None
    from streamoptima_tpu_torch.bitstream import widen_mvs

    sp = np.ascontiguousarray(np.asarray(split), dtype=np.uint8)
    nb = sp.shape[0]
    m3, s3 = widen_mvs(frame_type, mv, smv)
    n_rows = -(-nb // blocks_per_row)
    if rc_active and len(qps) < n_rows:
        return None
    qp = np.ascontiguousarray(
        np.asarray(list(qps)[:n_rows] if len(qps) else [0] * n_rows), dtype=np.int32
    )
    cap = int(nb * 420 + 16)
    buf = np.empty(cap, np.uint8)
    n = lib.encode_mv_line(
        ctypes.c_int32(frame_type), ctypes.c_int32(1 if rc_active else 0),
        ctypes.c_int32(blocks_per_row), ctypes.c_int64(nb),
        m3.ctypes.data, s3.ctypes.data, sp.ctypes.data, qp.ctypes.data,
        buf.ctypes.data, ctypes.c_int64(cap),
    )
    if n < 0:
        return None
    return buf[:n].tobytes().decode("ascii")


def parse_residual_line(line: str, nb: int, bs: int):
    """Parse one residual text line into device-shaped arrays.

    Returns (split (nb,) bool, qf (nb, bs, bs) int16, qq (nb, 4, sbs, sbs)
    int16), or None when the native library is unavailable or the line is
    anomalous (truncated, wrong arity, int16 overflow, item count != nb):
    callers then take the Python parser, which raises on corrupt streams."""
    lib = _load()
    if lib is None:
        return None
    sbs = bs // 2
    raw = line.encode("ascii", errors="replace")
    qf = np.empty((nb, bs, bs), np.int16)
    qq = np.empty((nb, 4, sbs, sbs), np.int16)
    sp = np.empty(nb, np.uint8)
    n = lib.parse_residual_line(
        raw, ctypes.c_int64(len(raw)), ctypes.c_int64(nb), ctypes.c_int32(bs),
        qf.ctypes.data, qq.ctypes.data, sp.ctypes.data,
    )
    if n != nb:
        return None
    return sp.astype(bool), qf, qq


def parse_mv_line(line: str, rc_active: bool, blocks_per_row: int, nb: int, n_rows: int):
    """Parse one MV text line into device-shaped arrays.

    Returns (frame_type, mv (nb, 3) int32 [intra: component 0], split (nb,)
    bool, smv (nb, 4, 3) int32, qps list), or None on unavailability or any
    anomaly (the Python parser then runs).  Entries of the form a block does
    not use (mv of a split block, smv of an unsplit one) are zero."""
    lib = _load()
    if lib is None:
        return None
    raw = line.encode("ascii", errors="replace")
    mv = np.empty((nb, 3), np.int32)
    smv = np.empty((nb, 4, 3), np.int32)
    sp = np.empty(nb, np.uint8)
    qps = np.empty(max(n_rows, 1), np.int32)
    nqp = np.zeros(1, np.int64)
    ft = lib.parse_mv_line(
        raw, ctypes.c_int64(len(raw)), ctypes.c_int32(1 if rc_active else 0),
        ctypes.c_int32(blocks_per_row), ctypes.c_int64(nb),
        mv.ctypes.data, smv.ctypes.data, sp.ctypes.data,
        qps.ctypes.data, ctypes.c_int64(qps.shape[0]), nqp.ctypes.data,
    )
    if ft < 0:
        return None
    return int(ft), mv, sp.astype(bool), smv, [int(q) for q in qps[: int(nqp[0])]]
