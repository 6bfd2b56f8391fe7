"""The SOTPB1 binary container, written from a segment's per-frame arrays.

The layout is the port's ``binstream`` format (little-endian)::

    magic  b"SOTPB1\\n"
    u32    height, width, frames, block_size, flags
           (bit 0: rate control, so row QPs follow; bit 1, an ROI map, is never set here)
    per frame:
      u8   frame_type
      u8   split bitmap  (ceil(nb/8) bytes, np.packbits order)
      i16  mv[nb*3]      (intra: component 0, rest 0; split blocks 0)
      u32  n_split
      i16  smv[n_split*4*3]            (split blocks, raster order)
      [i16 row_qps[block_rows]]        (flags bit 0)
      u32  offs_f[n_unsplit+1]; i16 vals_f   (full-block RLE lists)
      u32  offs_q[4*n_split+1]; i16 vals_q   (quad RLE lists, Z order)

The RLE lists are the codec's diagonal-scan run-length code: over each
block's anti-diagonal scan (top-right to bottom-left), a run of k nonzero
values emits ``-k`` and the values, a run of k zeros ``+k``, and a trailing
run of zeros a single ``0``.  ``rle_encode_blocks`` computes the lists for
many blocks at once with numpy: an implementation of its own, not a copy of
the program's C++ or Python encoder.
"""
from __future__ import annotations

import numpy as np

from .zigzag import diag_scan_indices

MAGIC = b"SOTPB1\n"


def rle_encode_blocks(blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, n, n) integer blocks -> (values int64, offsets (B + 1,) int64):
    block b's list is ``values[offsets[b]:offsets[b + 1]]``."""
    blocks = np.asarray(blocks)
    nblk = blocks.shape[0]
    if nblk == 0:
        return np.zeros(0, np.int64), np.zeros(1, np.int64)
    n = blocks.shape[-1]
    length = n * n
    seq = blocks.reshape(nblk, length)[:, diag_scan_indices(n)].astype(np.int64)
    nz = seq != 0
    start = np.ones_like(nz)
    start[:, 1:] = nz[:, 1:] != nz[:, :-1]  # each block starts a run
    flat_start = np.flatnonzero(start.ravel())
    run_len = np.diff(np.append(flat_start, nblk * length))
    run_block = flat_start // length
    run_nz = nz.ravel()[flat_start]
    last_in_block = np.append(run_block[1:] != run_block[:-1], True)
    tokens = 1 + np.where(run_nz, run_len, 0)
    header = np.where(run_nz, -run_len, np.where(last_in_block, 0, run_len))
    run_off = np.concatenate([[0], np.cumsum(tokens)])
    vals = np.empty(int(run_off[-1]), np.int64)
    vals[run_off[:-1]] = header
    elem = np.flatnonzero(nz.ravel())
    run_of_elem = np.cumsum(start.ravel())[elem] - 1
    vals[run_off[run_of_elem] + 1 + (elem - flat_start[run_of_elem])] = seq.ravel()[elem]
    per_block = np.bincount(run_block, weights=tokens, minlength=nblk).astype(np.int64)
    return vals, np.concatenate([[0], np.cumsum(per_block)])


def _i16(a) -> bytes:
    a = np.asarray(a)
    if a.size and (a.min() < -32768 or a.max() > 32767):
        raise ValueError("a value outside int16 in the container")
    return a.astype("<i2").tobytes()


def write_container(h: int, w: int, bs: int, ftypes: list, outs: list, row_qps: list | None = None) -> bytes:
    """The container of a segment.  ``outs``: per frame, numpy arrays "mv"
    ((nb,) intra scalars or (nb, 3)), "sub_mv" ((nb, 4) or (nb, 4, 3)),
    "split" (nb,), "qtc_full" (nb, bs, bs), "qtc_quads" (nb, 4, s, s).
    ``row_qps``: under rate control, each frame's QP of each block row."""
    s = bs // 2
    parts = [MAGIC, np.asarray([h, w, len(ftypes), bs, 0 if row_qps is None else 1], "<u4").tobytes()]
    for i, (ft, o) in enumerate(zip(ftypes, outs)):
        split = np.asarray(o["split"], bool)
        nb = split.shape[0]
        mv, smv = np.asarray(o["mv"], np.int64), np.asarray(o["sub_mv"], np.int64)
        m3, s3 = np.zeros((nb, 3), np.int64), np.zeros((nb, 4, 3), np.int64)
        if ft == 0:  # intra frames carry component 0 only
            m3[:, 0] = mv.reshape(nb, -1)[:, 0]
            s3[:, :, 0] = smv.reshape(nb, 4, -1)[:, :, 0]
        else:
            m3[:] = mv
            s3[:] = smv
        m3[split] = 0
        si = np.flatnonzero(split)
        vals_f, offs_f = rle_encode_blocks(np.asarray(o["qtc_full"])[~split])
        vals_q, offs_q = rle_encode_blocks(np.asarray(o["qtc_quads"])[si].reshape(-1, s, s))
        parts += [np.uint8(ft).tobytes(), np.packbits(split).tobytes(), _i16(m3.reshape(-1)),
                  np.asarray([si.size], "<u4").tobytes(), _i16(s3[si].reshape(-1))]
        if row_qps is not None:
            if len(row_qps[i]) != h // bs:
                raise ValueError(f"frame {i} has {len(row_qps[i])} row QPs for {h // bs} block rows")
            parts.append(_i16(row_qps[i]))
        parts += [offs_f.astype("<u4").tobytes(), _i16(vals_f), offs_q.astype("<u4").tobytes(), _i16(vals_q)]
    return b"".join(parts)
