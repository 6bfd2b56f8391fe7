"""Binary bitstream container (native extension, format "SOTPB1").

The port's copy of the JAX package's ``binstream`` module: the same layout,
byte for byte, so either package reads the other's files.

The reference's two text files are the parity format (bitstream.py,
byte-exact with decoder.py:651-670); this single-file binary container is
the production form the SURVEY planned behind the same serializer interface
(SURVEY.md section 7.4): ~3-7x smaller than the text files and parsed into
the device-shaped array interchange (bitstream.FrameMVArrays /
FrameResArrays) by pure batched NumPy + the C++ RLE runtime — no per-block
text walk at all.  Both engines decode either format identically: the
container stores exactly the arrays the text format round-trips (split
flags, MVs, per-row QPs, diagonal-RLE coefficient lists), so a clip written
as text and as binary reconstructs bit-identically.

Which inputs take which route to the coded lists.  ``write_binary`` writes
frames in the coded interchange (``CodedFrame``: split flags, MVs, the
unsplit blocks' and the split blocks' RLE lists with their u32 offsets) as
they are.  A ``package=False`` encode's per-frame tensors become coded
frames by ``coded_frames_of``: one ``K.rle_pack`` over the whole clip (the
CUDA kernel for tensors on a card, its plain PyTorch twin for CPU tensors)
and one device-to-host copy of the packed buffer (``VideoCodec``'s
``transmit_bitstream_binary`` takes this route).  Host arrays (the list
interchange of ``package=True`` encodes and of the compat engine,
``read_binary``'s and ``read_bitstream``'s array interchange) are coded on
the host, by the C++ runtime ``native`` over int64 blocks, or its Python
twin in ``core/zigzag.py`` where the library does not build.  The tracer's
``rle_frames`` counter counts each route's frames (sites ``device`` and
``host``).  Both routes give the same bytes.

The read mirrors it.  ``read_binary`` leaves each frame's coefficients as
the container codes them (``CodedResiduals``: the split flags and views of
the RLE lists in the file's bytes).  The decoders take those lists to the
device undecoded, in one copy, and one ``K.rle_unpack`` launch writes their
payload there (``engine.pack_stream`` / ``upload_stream``).  Any other
consumer of the array interchange reads a frame's ``qf`` / ``qq``, which
the host RLE (``native``, or its Python twin) decodes on first access.  The
tracer's ``rle_decoded_frames`` counter counts each route's frames (sites
``device`` and ``host``).

Layout (little-endian):

    magic  b"SOTPB1\\n"
    u32    height, width, frames, block_size, flags
           flags bit0 = rc_active, bit1 = has ROI map
    [i16   roi_qp_map[nb]]                  (bit1)
    per frame:
      u8   frame_type
      u8   split bitmap  (ceil(nb/8) bytes, np.packbits order)
      i16  mv[nb*3]                         (intra: component 0, rest 0)
      u32  n_split
      i16  smv[n_split*4*3]                 (split blocks, raster order)
      [i16 row_qps[block_rows]]             (rc_active)
      u32  offs_f[n_unsplit+1]; i16 vals_f  (full-block RLE lists)
      u32  offs_q[4*n_split+1]; i16 vals_q  (quad RLE lists, Z order)

RLE lists are the reference's diagonal-scan run-length code (core/zigzag);
every symbol fits i16 (|qtc| <= 4080 for the orthonormal 16x16 DCT of
+-255 residuals, run headers bounded by the block size — out-of-range
MVs and coefficients raise at write time instead of truncating).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from streamoptima_tpu_torch import native
from streamoptima_tpu_torch.bitstream import FrameMVArrays, FrameResArrays, _reconcile_roi
from streamoptima_tpu_torch.bitstream import widen_mvs as BS_widen
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core.zigzag import rle_decode_block, rle_encode_block
from streamoptima_tpu_torch.engine import list_to_mvs_np, list_to_res_np
from streamoptima_tpu_torch.profiling import to_host, traced, tracer

MAGIC = b"SOTPB1\n"


class CodedFrame(NamedTuple):
    """One frame in the coded interchange: the container's fields, ready to
    write.  split (nb,) bool; mv (nb, 3) int16 (a split block's zero, an
    intra frame's in component 0); sub_mv (n_split, 4, 3) int16, the split
    blocks' in raster order; offs_f (n_unsplit + 1,) and offs_q (4 n_split
    + 1,) u32 and vals_f, vals_q int16: the unsplit blocks' full-block RLE
    lists and the split blocks' quad lists (Z order), concatenated."""
    split: np.ndarray
    mv: np.ndarray
    sub_mv: np.ndarray
    offs_f: np.ndarray
    vals_f: np.ndarray
    offs_q: np.ndarray
    vals_q: np.ndarray


def _offsets(lengths) -> np.ndarray:
    offs = np.zeros(len(lengths) + 1, "<u4")
    np.cumsum(lengths, out=offs[1:])
    return offs


def coded_frames_of(per_frame: list, frame_types, sizes) -> list:
    """A ``package=False`` encode's per-frame tensors (``pkg["per_frame"]``)
    -> one ``CodedFrame`` a frame: one ``K.rle_pack`` over every frame, and
    one copy of its buffer to the host.  ``sizes``: each frame's coded
    length (``pkg["residual size per frame"]``), which sizes the buffer
    before the copy; a frame whose coded lists add up to another length
    raises ``ValueError``, as does an MV outside int16."""
    frames = len(per_frame)
    if frames == 0:
        return []
    cols = [[o[k] for o in per_frame] for k in ("split", "mv", "sub_mv", "qtc_full", "qtc_quads")]
    for ft, mv in zip(frame_types, cols[1]):
        if (mv.dim() == 1) != (int(ft) == 0):
            raise ValueError("an intra frame carries scalar MVs (nb,), an inter frame triples (nb, 3)")
    nb = cols[0][0].shape[0]
    buf = to_host(K.rle_pack(*cols, int(sum(sizes))), "fetch")
    a, s0 = K.rle_pack_layout(frames, nb)
    totals = buf[: 4 * frames].view("<i4").reshape(frames, 2)
    if buf[4 * frames: a].view("<i4")[0] & 1:
        raise ValueError("mv outside int16 range — refusing to truncate")
    if not np.array_equal(totals.sum(1), np.asarray(sizes)):
        raise ValueError(f"the coded lists add up to {totals.sum(1).tolist()} symbols a frame, the package's residual "
                         f"sizes are {list(sizes)}")
    head = buf[a:s0].reshape(frames, K.RLE_HDR * nb)
    out, pos = [], s0
    for f in range(frames):
        h = head[f]
        split = h[:nb] != 0
        lens = h[16 * nb:].reshape(nb, 4)
        end_f, end_q = pos + int(totals[f, 0]), pos + int(totals[f, 0]) + int(totals[f, 1])
        out.append(CodedFrame(split, h[nb: 4 * nb], h[4 * nb: 16 * nb].reshape(nb, 4, 3)[split],
                              _offsets(lens[~split, 0]), buf[pos:end_f], _offsets(lens[split].reshape(-1)),
                              buf[end_f:end_q]))
        pos = end_q
    if tracer.on:
        tracer.rle_frames["device"] += frames
    return out


@traced("binstream.rle_encode")
def _rle_encode_batch(blocks) -> tuple[np.ndarray, np.ndarray]:
    """(nblocks, n, n) -> (values i64, offsets i64) via the C++ runtime,
    Python twin as fallback."""
    if blocks.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(1, np.int64)
    r = native.rle_encode_blocks(blocks)
    if r is not None:
        return r
    vals, offs = [], [0]
    for b in blocks:
        e = rle_encode_block(np.asarray(b))
        vals.extend(int(v) for v in e)
        offs.append(len(vals))
    return np.asarray(vals, np.int64), np.asarray(offs, np.int64)


@traced("binstream.rle_decode")
def _rle_decode_batch(vals, offs, n: int) -> np.ndarray:
    nblocks = len(offs) - 1
    if nblocks == 0:
        return np.zeros((0, n, n), np.int64)
    r = native.rle_decode_blocks(vals.astype(np.int64), offs.astype(np.int64), n)
    if r is not None:
        return r
    return np.stack([
        rle_decode_block(list(vals[offs[i]: offs[i + 1]]), n) for i in range(nblocks)
    ])


class CodedResiduals(FrameResArrays):
    """One frame's residuals as the container codes them (``read_binary``'s):
    the split flags, and the unsplit blocks' and the split blocks' RLE lists
    (``offs_f`` / ``offs_q`` int64, checked; ``vals_f`` / ``vals_q`` int16
    views of the file's bytes).  ``data`` is the file, ``chunk`` the byte
    range of the frame's four fields in it, ``fields`` where each starts in
    that range.  ``qf`` and ``qq`` are decoded on the host on first access
    and kept, so the frame serves wherever the array interchange
    (``FrameResArrays``) does; the decoders take its lists to the device
    undecoded (``engine.pack_stream``)."""

    def __new__(cls, split, data: bytes, chunk: tuple, offs_f, vals_f, offs_q, vals_q, bs: int):
        self = super().__new__(cls, split, None, None)
        self.data, self.chunk, self.bs = data, chunk, bs
        self.offs_f, self.vals_f, self.offs_q, self.vals_q = offs_f, vals_f, offs_q, vals_q
        a = 4 * len(offs_f)
        self.fields = (0, a, a + 2 * len(vals_f), a + 2 * len(vals_f) + 4 * len(offs_q))
        self._dense = None
        return self

    def _arrays(self) -> tuple:
        if self._dense is None:
            nb, bs, sbs = len(self.split), self.bs, self.bs // 2
            qf = np.zeros((nb, bs, bs), np.int16)
            qq = np.zeros((nb, 4, sbs, sbs), np.int16)
            qf[~self.split] = _rle_decode_batch(self.vals_f, self.offs_f, bs).astype(np.int16)
            quads = _rle_decode_batch(self.vals_q, self.offs_q, sbs)
            qq[self.split] = quads.reshape(-1, 4, sbs, sbs).astype(np.int16)
            if tracer.on:
                tracer.rle_decoded_frames["host"] += 1
            self._dense = (qf, qq)
        return self._dense

    qf = property(lambda self: self._arrays()[0])
    qq = property(lambda self: self._arrays()[1])

    def __iter__(self):
        return iter((self.split, self.qf, self.qq))

    def __getitem__(self, key):
        return tuple(self)[key]


def _i16(a, what: str) -> np.ndarray:
    a = np.asarray(a)
    if a.size and (a.min() < -32768 or a.max() > 32767):
        raise ValueError(f"{what} outside int16 range — refusing to truncate")
    return a.astype("<i2")


class _Writer:
    def __init__(self, f):
        self.f = f

    def arr(self, a):
        self.f.write(np.ascontiguousarray(a).data)

    def u32(self, *vs):
        self.arr(np.asarray(vs, "<u4"))


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def arr(self, dtype, count):
        dt = np.dtype(dtype)
        end = self.pos + dt.itemsize * count
        if end > len(self.buf):
            raise ValueError("truncated binary bitstream")
        out = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.pos)
        self.pos = end
        return out

    def u32(self, count=1):
        v = self.arr("<u4", count)
        return int(v[0]) if count == 1 else v


def _code_on_host(ft: int, mvs, res, nb: int, bs: int, sbs: int) -> CodedFrame:
    """One frame of host arrays (the list or array interchange) -> its coded
    frame, by the host RLE (``native`` or the Python twin)."""
    mv, split, smv = list_to_mvs_np(mvs, ft, nb)
    qf, qq = list_to_res_np(res, nb, bs, sbs)
    m3, s3 = BS_widen(ft, mv, smv, dtype=np.int64)
    split = np.asarray(split, bool)
    # canonical form = the text format's information content: a
    # block carries EITHER its full MV or its quad MVs (the array
    # package also holds the unchosen variant's winners; the list
    # package zeroes them) — zero the unchosen slots so both
    # package kinds serialize byte-identically and decode exactly
    # like a text-parsed stream
    m3[split] = 0
    si = np.flatnonzero(split)
    vals_f, offs_f = _rle_encode_batch(np.asarray(qf)[~split].astype(np.int64))
    vals_q, offs_q = _rle_encode_batch(np.asarray(qq)[si].reshape(-1, sbs, sbs).astype(np.int64))
    if tracer.on:
        tracer.rle_frames["host"] += 1
    return CodedFrame(split, _i16(m3, "mv"), _i16(s3[si], "sub_mv"), offs_f.astype("<u4"),
                      _i16(vals_f, "coefficients"), offs_q.astype("<u4"), _i16(vals_q, "coefficients"))


@traced("binstream.write")
def write_binary(path, frame_types, mvs_per_frame, qp_rows_per_frame,
                 residuals_per_frame, cfg) -> None:
    """Write the container.  A frame's ``residuals_per_frame`` entry may be
    a ``CodedFrame`` (``coded_frames_of``: written as it is, its MVs
    included; its ``mvs_per_frame`` entry is not read), or host arrays in
    the array interchange (FrameMVArrays / FrameResArrays, e.g.
    read_binary's or read_bitstream's output) or the list interchange, both
    normalized through engine.list_to_*_np and coded on the host."""
    nb, bs, sbs = cfg.n_blocks, cfg.block_size, cfg.sub_block_size
    n = len(frame_types)
    flags = (1 if cfg.rc_active else 0) | (2 if cfg.roi_qp_map is not None else 0)
    with open(path, "wb") as f:
        w = _Writer(f)
        f.write(MAGIC)
        w.u32(cfg.height, cfg.width, n, bs, flags)
        if cfg.roi_qp_map is not None:
            w.arr(_i16(np.asarray(cfg.roi_qp_map).reshape(-1), "roi_qp_map"))
        for i in range(n):
            ft = int(frame_types[i])
            c = residuals_per_frame[i]
            if not isinstance(c, CodedFrame):
                c = _code_on_host(ft, mvs_per_frame[i], c, nb, bs, sbs)
            f.write(np.uint8(ft).tobytes())
            w.arr(np.packbits(c.split))
            w.arr(c.mv)
            w.u32(len(c.sub_mv))
            w.arr(c.sub_mv)
            if cfg.rc_active:
                q = np.asarray(qp_rows_per_frame[i])
                if q.shape[0] != cfg.block_rows:
                    raise ValueError("rc stream needs one QP per block row")
                w.arr(_i16(q, "row_qps"))
            w.arr(c.offs_f)
            w.arr(c.vals_f)
            w.arr(c.offs_q)
            w.arr(c.vals_q)


@traced("binstream.read")
def read_binary(path, cfg):
    """Read the container -> (frame_types, mvs, qps, residuals) in the array
    interchange (mvs: FrameMVArrays, residuals: FrameResArrays, here their
    ``CodedResiduals``, decoded on first access) — the same contract as
    bitstream.read_bitstream.  ROI is reconciled with cfg exactly like the
    text reader (adopt / loud mismatch).  Dimension or block-size
    disagreement with cfg, and RLE offsets that do not start at 0 or fall,
    raise here."""
    nb, bs = cfg.n_blocks, cfg.block_size
    with open(path, "rb") as f:
        buf = f.read()
    if buf[: len(MAGIC)] != MAGIC:
        raise ValueError("not a SOTPB1 binary bitstream")
    r = _Reader(buf)
    r.pos = len(MAGIC)
    h, w_, n, bs_f, flags = (int(v) for v in r.u32(5))
    if (h, w_, bs_f) != (cfg.height, cfg.width, bs):
        raise ValueError(
            f"stream is {w_}x{h} bs={bs_f} but cfg is {cfg.width}x{cfg.height} bs={bs}"
        )
    if n != cfg.frames:
        raise ValueError(f"stream carries {n} frames but cfg.frames is {cfg.frames}")
    rc = bool(flags & 1)
    if rc != cfg.rc_active:
        raise ValueError("stream and cfg disagree on rate-control activity")
    stream_roi = None
    if flags & 2:
        stream_roi = r.arr("<i2", nb).astype(np.int32).reshape(cfg.block_rows, cfg.blocks_per_row)
    _reconcile_roi(stream_roi, cfg)
    frame_types, mvs, qps, residuals = [], [], [], []
    for _ in range(n):
        ft = int(r.arr("u1", 1)[0])
        split = np.unpackbits(r.arr("u1", -(-nb // 8)))[:nb].astype(bool)
        m3 = r.arr("<i2", nb * 3).astype(np.int32).reshape(nb, 3)
        n_split = r.u32()
        s3 = np.zeros((nb, 4, 3), np.int32)
        si = np.flatnonzero(split)
        if n_split != si.size:
            raise ValueError("split bitmap and sub-MV count disagree")
        s3[si] = r.arr("<i2", n_split * 12).astype(np.int32).reshape(n_split, 4, 3)
        qp = [int(v) for v in r.arr("<i2", cfg.block_rows)] if rc else []
        def _offsets(count):
            # file-derived offsets reach C++ pointer arithmetic — validate
            # shape here (0-start, monotone) and the window bound below once
            # the value count is known, so corruption raises instead of
            # reading out of bounds
            o = r.arr("<u4", count).astype(np.int64)
            if o[0] != 0 or (np.diff(o) < 0).any():
                raise ValueError("corrupt binary bitstream: non-monotone RLE offsets")
            return o

        chunk0 = r.pos
        offs_f = _offsets(nb - n_split + 1)
        vals_f = r.arr("<i2", int(offs_f[-1]))
        offs_q = _offsets(4 * n_split + 1)
        vals_q = r.arr("<i2", int(offs_q[-1]))
        frame_types.append(ft)
        mvs.append(FrameMVArrays(ft, m3, split, s3))
        qps.append(qp)
        residuals.append(CodedResiduals(split, buf, (chunk0, r.pos), offs_f, vals_f, offs_q, vals_q, bs))
    return frame_types, mvs, qps, residuals
