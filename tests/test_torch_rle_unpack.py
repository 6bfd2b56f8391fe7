"""PyTorch port, the container's run-length decoding on the device
(``K.rle_unpack``, ``csrc/rle_unpack.cu``) and the decode route that uses it.

Kernel level, on the CPU: the plain version, over the buffer the decoders
lay out (``engine.CodedPayload``, fields at odd file offsets), equals the
C++ runtime's ``native.rle_decode_blocks`` merged as ``pack_stream`` merges
a split block's quads, and ``pack_stream``'s host payload of the same
frames: bs 8 and 16, no, some and every block split, zero, all-nonzero,
trailing-run and random units, and adversarial lists (runs past the list's
end, an early 0, -32768, symbols past the unit's positions, zero runs past
them, empty lists), which also equal the Python twin
``zigzag.rle_decode_block``.

Container level: ``read_binary``'s frames (``binstream.CodedResiduals``)
give the JAX package's reader's arrays on first access, once, by the host
RLE; a binary decode through the coded route (the plain version on the
CPU) equals the host route's, on one device and on a CPU mesh, and
``rle_decoded_frames`` names the route; corrupt offsets raise before
anything is uploaded.  The kernel itself runs in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import synthetic_clip

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu import binstream as JBIN
from streamoptima_tpu_torch import CodecConfig, binstream, native
from streamoptima_tpu_torch.bitstream import FrameMVArrays, FrameResArrays
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import zigzag as Z
from streamoptima_tpu_torch.engine import CodedPayload, pack_stream, upload_stream
from streamoptima_tpu_torch.parallel import make_mesh
from streamoptima_tpu_torch.profiling import tracer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


# ------------------------------------------------------------ kernel level
def _unit(kind: str, m: int, rng) -> list:
    """One unit's RLE list of ``m`` scan positions."""
    n = int(round(m ** 0.5))
    if kind == "zero":
        block = np.zeros((n, n), np.int64)
    elif kind == "nonzero":
        block = rng.choice([-1, 1], (n, n)) * rng.integers(1, 4081, (n, n))
    elif kind == "trailing":
        block = np.zeros(n * n, np.int64)
        block[Z.diag_scan_indices(n)[:3]] = [-4080, 4080, 1]
        block = block.reshape(n, n)
    elif kind == "random":
        block = np.where(rng.random((n, n)) < rng.random(), rng.integers(-4080, 4081, (n, n)), 0)
    else:  # adversarial lists, not an encoder's
        return {"past_end": [-300, 5, -6, 7], "early_zero": [-2, 9, 9, 0, -3, 1, 2, 3], "min_header": [-32768, 4, 5],
                "min_then_more": [3, -32768, 1, -2, 8], "past_m": [-m, *range(1, m + 1), -4, 1, 2, 3, 4],
                "zeros_past_m": [m - 1, -3, 6, 7, 8, 2, -1, 5], "big_zero_run": [32767, -1, 5], "empty": [],
                "header_last": [2, -1, 4, -5], "positive_only": [1, 1, 1, -1, 9, 1, -2, 3, 4]}[kind]
    return [int(v) for v in Z.rle_encode_block(block)]


KINDS = ("zero", "nonzero", "trailing", "random")
ADVERSARIAL = ("past_end", "early_zero", "min_header", "min_then_more", "past_m", "zeros_past_m", "big_zero_run",
               "empty", "header_last", "positive_only")


def _fields(lists: list) -> tuple[np.ndarray, np.ndarray]:
    offs = np.zeros(len(lists) + 1, "<u4")
    np.cumsum([len(x) for x in lists], out=offs[1:])
    return offs, np.asarray([v for x in lists for v in x], "<i2")


def _coded_frame(split: np.ndarray, lists_f: list, lists_q: list, bs: int, pad: int):
    """A frame's container fields after ``pad`` bytes of a file, read back as
    ``read_binary`` reads them."""
    offs_f, vals_f = _fields(lists_f)
    offs_q, vals_q = _fields(lists_q)
    data = b"\x07" * pad + b"".join(a.tobytes() for a in (offs_f, vals_f, offs_q, vals_q))
    at = np.cumsum([pad, offs_f.nbytes, vals_f.nbytes, offs_q.nbytes])
    view = [np.frombuffer(data, a.dtype, len(a), int(o)) for a, o in zip((offs_f, vals_f, offs_q, vals_q), at)]
    return binstream.CodedResiduals(split, data, (pad, len(data)), view[0].astype(np.int64), view[1],
                                    view[2].astype(np.int64), view[3], bs)


def _native_payload(frames: list, bs: int) -> np.ndarray:
    """``native.rle_decode_blocks`` of each unit, a split block's quads laid out as its 2 x 2 tiles."""
    s = bs // 2
    out = []
    for r in frames:
        pay = np.zeros((len(r.split), bs, bs), np.int64)
        if (~r.split).any():
            pay[~r.split] = native.rle_decode_blocks(r.vals_f, r.offs_f, bs)
        if r.split.any():
            quads = native.rle_decode_blocks(r.vals_q, r.offs_q, s).reshape(-1, 2, 2, s, s)
            pay[r.split] = quads.swapaxes(2, 3).reshape(-1, bs, bs)
        out.append(pay)
    return np.stack(out)


def _cfg(bs: int, frames: int) -> CodecConfig:
    return CodecConfig(height=64, width=96, frames=frames, block_size=bs, search_range=4, qp=4, intra_dur=frames,
                       vbs_enable=True)


@pytest.mark.parametrize("lists", ["encoded", "adversarial"])
@pytest.mark.parametrize("bs", [8, 16])
def test_plain_version_equals_native_and_the_host_payload(bs, lists):
    """Four frames (no, every, half and some blocks split; each after a pad
    of 1, 2, 3, 0 bytes in the file) of each kind's units, through the
    decoders' layout and ``rle_unpack_plain``: == ``native`` merged, ==
    ``pack_stream``'s host payload, and (adversarial) == the Python twin."""
    rng = np.random.default_rng(bs)
    s = bs // 2
    cfg = _cfg(bs, 4)
    nb = cfg.n_blocks
    kinds = KINDS if lists == "encoded" else ADVERSARIAL
    frames = []
    for f, split in enumerate([np.zeros(nb, bool), np.ones(nb, bool), np.arange(nb) % 2 == 1, rng.random(nb) < 0.3]):
        pick = lambda i: kinds[(i + f) % len(kinds)]  # noqa: E731
        lists_f = [_unit(pick(i), bs * bs, rng) for i in range(int((~split).sum()))]
        lists_q = [_unit(pick(i), s * s, rng) for i in range(4 * int(split.sum()))]
        frames.append(_coded_frame(split, lists_f, lists_q, bs, (1, 2, 3, 0)[f]))
    want = _native_payload(frames, bs)
    mvs = [FrameMVArrays(0, np.zeros((nb, 3), np.int32), r.split, np.zeros((nb, 4, 3), np.int32)) for r in frames]
    packed = pack_stream(cfg, [0] * 4, frames, mvs)
    assert isinstance(packed[3], CodedPayload)
    got = upload_stream(packed, "cpu", True, False)[3]
    assert got.dtype == torch.int16 and got.shape == (4, nb, bs, bs)
    np.testing.assert_array_equal(got.numpy(), want)
    host = pack_stream(cfg, [0] * 4, [FrameResArrays(r.split, r.qf, r.qq) for r in frames], mvs)[3]
    np.testing.assert_array_equal(got.numpy(), host)
    if lists == "adversarial":
        for r, pay in zip(frames, want):
            for k in range(int((~r.split).sum())):
                unit = [int(v) for v in r.vals_f[r.offs_f[k]:r.offs_f[k + 1]]]
                np.testing.assert_array_equal(Z.rle_decode_block(unit, bs), pay[~r.split][k])


def test_plain_version_reads_a_buffer_of_the_kernels_layout():
    """``rle_unpack`` on a hand-laid buffer: one frame of two blocks, the
    second split, its fields off 4-byte alignment; and the wrapper's refusals."""
    offs_f = np.array([0, 3], "<u4")
    vals_f = np.array([-2, 5, -7], "<i2")
    offs_q = np.array([0, 1, 3, 3, 4], "<u4")
    vals_q = np.array([0, -1, 9, 1], "<i2")
    fields = b"".join(a.tobytes() for a in (offs_f, vals_f, offs_q, vals_q))
    head = K.rle_unpack_head(1, 2)
    pos = [head + 2, head + 2 + 8, head + 2 + 14, head + 2 + 34]
    buf = np.zeros(head + 2 + len(fields), np.uint8)
    buf[:32] = np.frombuffer(np.array(pos, np.int64).tobytes(), np.uint8)
    buf[32:head] = np.frombuffer(np.array([0, -1], np.int32).tobytes(), np.uint8)
    buf[head + 2:] = np.frombuffer(fields, np.uint8)
    got = K.rle_unpack(torch.from_numpy(buf), 1, 2, 4).numpy()
    want = np.zeros((1, 2, 4, 4), np.int16)
    want[0, 0].reshape(-1)[Z.diag_scan_indices(4)[:2]] = [5, -7]
    want[0, 1, 0, 2] = 9  # quad 1 (top right): its first scan position
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        K.rle_unpack(torch.from_numpy(buf[:head - 1]), 1, 2, 4)
    with pytest.raises(ValueError):
        K.rle_unpack(torch.from_numpy(buf.view(np.int8)), 1, 2, 4)


# ------------------------------------------------------------ container level
def _written(tmp_path, frames=5, **extra):
    kw = dict(height=64, width=96, frames=frames, block_size=16, search_range=3, qp=4, intra_dur=3, lam=0.015,
              vbs_enable=True, fme_enable=True)
    kw.update(extra)
    cfg = CodecConfig(**kw)
    v = VideoCodec(cfg, synthetic_clip(64, 96, frames), device="cpu")
    pkg = v.encode(compute_ssim=False, package=False)
    v.transmit_bitstream_binary(tmp_path / "c.sob")
    return kw, pkg, tmp_path / "c.sob"


def test_reader_frames_decode_on_first_access_to_the_jax_readers_arrays(tmp_path):
    kw, _, path = _written(tmp_path)
    tracer.enable()
    t = binstream.read_binary(path, CodecConfig(**kw))
    assert tracer.snapshot()["rle_decoded_frames"] == {}  # nothing decoded by the read
    j = JBIN.read_binary(path, JaxCodecConfig(**kw))
    assert any(int(r.split.sum()) for r in t[3])
    for tr, jr in zip(t[3], j[3]):
        assert isinstance(tr, binstream.CodedResiduals) and isinstance(tr, FrameResArrays)
        np.testing.assert_array_equal(tr.qf, jr.qf)
        np.testing.assert_array_equal(tr.qq, jr.qq)
        assert tr.qf is tr.qf and tr.qq is tr[2]
        split, qf, qq = tr
        assert split is tr.split and qf is tr.qf and qq is tr.qq
    assert tracer.snapshot()["rle_decoded_frames"] == {"host": kw["frames"]}


@pytest.mark.parametrize("where", ["device", "mesh"])
def test_binary_decode_by_the_coded_route_equals_the_host_route(tmp_path, where):
    """``decode`` of ``read_binary``'s frames (the coded route: one upload of
    the lists, ``rle_unpack``) and of the same frames densified (the host
    route): the same frames, the reconstructions; the counter names each."""
    kw, pkg, path = _written(tmp_path, frames=6)
    cfg = CodecConfig(**kw)

    def decoder():
        return VideoCodec(dataclasses.replace(cfg), **({"mesh": make_mesh(cfg, devices=["cpu"] * 4)}
                                                      if where == "mesh" else {"device": "cpu"}))

    fts, mvs, qps, res = binstream.read_binary(path, dataclasses.replace(cfg))
    tracer.enable()
    coded = decoder().decode(fts, res, qps, mvs)
    assert tracer.snapshot()["rle_decoded_frames"] == {"device": cfg.frames}
    tracer.reset()
    dense = [FrameResArrays(r.split, r.qf, r.qq) for r in res]
    assert tracer.snapshot()["rle_decoded_frames"] == {"host": cfg.frames}
    host = decoder().decode(fts, dense, qps, mvs)
    assert tracer.snapshot()["rle_decoded_frames"] == {"host": cfg.frames}
    np.testing.assert_array_equal(coded, host)
    np.testing.assert_array_equal(coded, pkg["reconstructed frames"])


@pytest.mark.parametrize("corrupt", ["start", "falls"])
def test_corrupt_offsets_raise_before_any_upload(tmp_path, corrupt):
    """An offset array that does not start at 0, or falls, raises in the
    read: nothing is uploaded, nothing decoded."""
    kw, _, path = _written(tmp_path, frames=3)
    cfg = CodecConfig(**kw)
    data = bytearray(path.read_bytes())
    frame = binstream.read_binary(path, dataclasses.replace(cfg))[3][1]
    assert len(frame.offs_f) >= 3
    at = frame.chunk[0] + (0 if corrupt == "start" else 4 * (len(frame.offs_f) // 2))
    data[at: at + 4] = np.array([1 if corrupt == "start" else 2 ** 31], "<u4").tobytes()
    path.write_bytes(bytes(data))
    tracer.enable()
    with pytest.raises(ValueError, match="non-monotone RLE offsets"):
        VideoCodec(dataclasses.replace(cfg), device="cpu").decode_bitstream_binary(path)
    snap = tracer.snapshot()
    assert snap["h2d_bytes"] == {} and snap["rle_decoded_frames"] == {}
