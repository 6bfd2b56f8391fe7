"""PyTorch port, the binary bitstream container (``binstream``, SOTPB1).

Twins of ``tests/test_binstream.py``'s six tests through the port's facade
on the CPU (the mesh decode on the port's 8-device CPU mesh), and the two
packages held to one format: the port's files are byte-identical to the
JAX package's for the same encode, with and without rate control, each
package reads the other's files bit for bit, and the port's C++ RLE
bindings and its Python fallback write the same bytes.  Every comparison is
exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import synthetic_clip

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu import binstream as JBIN
from streamoptima_tpu import native as jnative
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch import binstream as BIN
from streamoptima_tpu_torch import native
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import zigzag as TZ
from streamoptima_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8
RC_TABLES = [
    [9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
    [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170],
]
RC = {"rc_flag": 1, "target_br": "300 kbps", "frame_rate": 30, "qp_rate_tables": RC_TABLES}
ROI = np.zeros((4, 6), np.int32)
ROI[1:3, 2:4] = -2


def _kw(**kw):
    base = dict(height=64, width=96, frames=5, block_size=16, search_range=3, qp=4, intra_dur=3, lam=0.015)
    base.update(kw)
    return base


def _cfg(**kw):
    return CodecConfig(**_kw(**kw))


def _codec(cfg, y=None, **where):
    return VideoCodec(cfg, y, **(where or {"device": "cpu"}))


# ------------------------------------------------- twins of test_binstream.py
@pytest.mark.parametrize("flags", [{}, {"vbs_enable": True, "fme_enable": True}, RC],
                         ids=["plain", "vbs_fme", "rc"])
def test_binary_roundtrip_matches_text(tmp_path, flags):
    y = synthetic_clip(64, 96, 5)
    cfg = _cfg(**flags)
    codec = _codec(cfg, y)
    pkg = codec.encode(package=False)
    codec.transmit_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    codec.transmit_bitstream_binary(tmp_path / "clip.sob")
    dec_txt = _codec(dataclasses.replace(cfg)).decode_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    dec_bin = _codec(dataclasses.replace(cfg)).decode_bitstream_binary(tmp_path / "clip.sob")
    np.testing.assert_array_equal(dec_bin, dec_txt)
    np.testing.assert_array_equal(dec_bin, pkg["reconstructed frames"])
    tsize = (tmp_path / "mv.txt").stat().st_size + (tmp_path / "res.txt").stat().st_size
    bsize = (tmp_path / "clip.sob").stat().st_size
    assert bsize < tsize, (bsize, tsize)


def test_binary_from_list_package_identical(tmp_path):
    y = synthetic_clip(64, 96, 4)
    cfg = _cfg(frames=4, vbs_enable=True)
    c1 = _codec(dataclasses.replace(cfg), y)
    c1.encode(package=True)
    c1.transmit_bitstream_binary(tmp_path / "a.sob")
    c2 = _codec(dataclasses.replace(cfg), y)
    c2.encode(package=False)
    c2.transmit_bitstream_binary(tmp_path / "b.sob")
    assert (tmp_path / "a.sob").read_bytes() == (tmp_path / "b.sob").read_bytes()


def test_binary_roi_self_describing(tmp_path):
    y = synthetic_clip(64, 96, 4)
    cfg = _cfg(frames=4, roi_qp_map=ROI)
    codec = _codec(cfg, y)
    pkg = codec.encode(package=False)
    codec.transmit_bitstream_binary(tmp_path / "roi.sob")
    bare = dataclasses.replace(cfg, roi_qp_map=None)
    dec = _codec(bare).decode_bitstream_binary(tmp_path / "roi.sob")
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])
    wrong = dataclasses.replace(cfg, roi_qp_map=ROI + 1)
    with pytest.raises(ValueError, match="differs"):
        _codec(wrong).decode_bitstream_binary(tmp_path / "roi.sob")


@pytest.mark.parametrize("flags", [{"vbs_enable": True}, {"vbs_enable": True, **RC, "target_br": "640 kbps"},
                                   {"roi_qp_map": ROI[:, :4]}], ids=["vbs", "vbs_rc", "roi"])
def test_binary_mesh_decode(tmp_path, flags):
    """Mesh-encoded clip -> binary container -> sharded decode on the port's
    8-device CPU mesh, bit-exact; and the same bytes as the single-device
    encode's container.  The ROI stream decodes on a mesh built without the
    map: the facade adopts the header and rebuilds its mesh decoder."""
    clip = synthetic_clip(64, 64, 6)
    cfg = CodecConfig(height=64, width=64, frames=6, block_size=16, search_range=4, qp=3, intra_dur=3, **flags)
    mesh = make_mesh(cfg, devices=CPU8)
    assert mesh.devices.shape == (2, 4)
    codec = VideoCodec(dataclasses.replace(cfg), clip, mesh=mesh)
    pkg = codec.encode()
    p = tmp_path / "mesh.sob"
    codec.transmit_bitstream_binary(p)
    bare = dataclasses.replace(cfg, roi_qp_map=None)
    dec_codec = VideoCodec(bare, mesh=make_mesh(bare, devices=CPU8))
    dec = dec_codec.decode_bitstream_binary(p)
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])
    assert (dec_codec._dec_mesh._tiles[0][0].roi is not None) == ("roi_qp_map" in flags)  # rebuilt for ROI
    one = _codec(dataclasses.replace(cfg), clip)
    one.encode()
    one.transmit_bitstream_binary(tmp_path / "one.sob")
    assert (tmp_path / "one.sob").read_bytes() == p.read_bytes()


def test_binary_loud_failures(tmp_path):
    y = synthetic_clip(64, 96, 3)
    cfg = _cfg(frames=3)
    codec = _codec(cfg, y)
    codec.encode(package=False)
    p = tmp_path / "clip.sob"
    codec.transmit_bitstream_binary(p)
    raw = p.read_bytes()
    (tmp_path / "trunc.sob").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="truncated"):
        _codec(dataclasses.replace(cfg)).decode_bitstream_binary(tmp_path / "trunc.sob")
    (tmp_path / "bad.sob").write_bytes(b"NOPE" + raw[4:])
    with pytest.raises(ValueError, match="not a SOTPB1"):
        _codec(dataclasses.replace(cfg)).decode_bitstream_binary(tmp_path / "bad.sob")
    with pytest.raises(ValueError, match="cfg is"):
        _codec(_cfg(height=96, width=64, frames=3)).decode_bitstream_binary(p)
    with pytest.raises(ValueError, match="engine='jax'"):  # the binary container is the native engine's
        _codec(_cfg(frames=3, engine="compat")).decode_bitstream_binary(p)
    with pytest.raises(ValueError, match="frames"):
        _codec(_cfg(frames=5)).decode_bitstream_binary(p)
    with pytest.raises(ValueError, match="rate-control"):
        _codec(_cfg(frames=3, **RC)).decode_bitstream_binary(p)
    with pytest.raises(ValueError, match="mv outside int16 range"):  # an MV the container cannot hold
        BIN.write_binary(tmp_path / "big.sob", [1], [[(0, (40000, 0, 0))] + [(0, (0, 0, 0))] * 23], [[]],
                         [[(0, np.zeros((16, 16), np.int16))] * 24], _cfg(frames=1))


def test_binary_corrupt_offsets_raise(tmp_path):
    """Interior corruption raises ValueError or OverflowError, or decodes
    cleanly: it never reaches unguarded C++ pointer arithmetic."""
    y = synthetic_clip(64, 96, 3)
    cfg = _cfg(frames=3)
    codec = _codec(cfg, y)
    codec.encode(package=False)
    p = tmp_path / "clip.sob"
    codec.transmit_bitstream_binary(p)
    raw = bytearray(p.read_bytes())
    rng = np.random.default_rng(0)
    hdr = len(BIN.MAGIC) + 20
    for _ in range(40):
        bad = bytearray(raw)
        pos = int(rng.integers(hdr, len(raw) - 4))
        bad[pos: pos + 4] = (0xF0000000).to_bytes(4, "little")
        (tmp_path / "bad.sob").write_bytes(bytes(bad))
        try:
            _codec(_cfg(frames=3)).decode_bitstream_binary(tmp_path / "bad.sob")
        except (ValueError, OverflowError):
            pass  # loud rejection is the contract


# --------------------------------------------- the two packages, one format
@pytest.mark.parametrize("flags", [{}, {"vbs_enable": True, "fme_enable": True}, RC, {**RC, "vbs_enable": True},
                                   {"roi_qp_map": ROI}],
                         ids=["plain", "vbs_fme", "rc", "rc_vbs", "roi"])
def test_files_byte_identical_to_jax_package(tmp_path, flags):
    """The same encode written by each package: the same bytes; each reads
    the other's file into the same reconstructions."""
    y = synthetic_clip(64, 96, 5)
    kw = _kw(**flags)
    jv = JaxVideoCodec(JaxCodecConfig(**kw), y)
    jpkg = jv.encode(package=False)
    jv.transmit_bitstream_binary(tmp_path / "j.sob")
    tv = _codec(CodecConfig(**kw), y)
    tpkg = tv.encode(package=False)
    tv.transmit_bitstream_binary(tmp_path / "t.sob")
    assert (tmp_path / "t.sob").read_bytes() == (tmp_path / "j.sob").read_bytes()
    np.testing.assert_array_equal(tpkg["reconstructed frames"], jpkg["reconstructed frames"])
    bare = {k: v for k, v in kw.items() if k != "roi_qp_map"}  # the ROI header is adopted from the file
    from_jax = _codec(CodecConfig(**bare)).decode_bitstream_binary(tmp_path / "j.sob")
    from_port = JaxVideoCodec(JaxCodecConfig(**bare)).decode_bitstream_binary(tmp_path / "t.sob")
    np.testing.assert_array_equal(from_jax, jpkg["reconstructed frames"])
    np.testing.assert_array_equal(np.asarray(from_port), tpkg["reconstructed frames"])


def test_readers_agree_field_by_field(tmp_path):
    """``read_binary`` of one file in each package: the same frame types,
    MVs, split flags, sub-MVs, row QPs and coefficients."""
    y = synthetic_clip(64, 96, 5)
    kw = _kw(vbs_enable=True, **RC)
    v = _codec(CodecConfig(**kw), y)
    v.encode(package=False)
    v.transmit_bitstream_binary(tmp_path / "t.sob")
    t = BIN.read_binary(tmp_path / "t.sob", CodecConfig(**kw))
    j = JBIN.read_binary(tmp_path / "t.sob", JaxCodecConfig(**kw))
    assert t[0] == j[0] and t[2] == j[2]
    assert any(int(m.split.sum()) for m in t[1])
    for tm, jm, tr, jr in zip(t[1], j[1], t[3], j[3]):
        assert tm.ftype == jm.ftype
        for a, b in ((tm.mv, jm.mv), (tm.split, jm.split), (tm.smv, jm.smv), (tr.qf, jr.qf), (tr.qq, jr.qq)):
            np.testing.assert_array_equal(a, b)


def test_rle_bindings_match_jax_package_and_python_twin():
    rng = np.random.default_rng(3)
    for n in (8, 16):
        blocks = np.where(rng.random((40, n, n)) < 0.15, rng.integers(-300, 301, (40, n, n)), 0)
        blocks[0] = 0
        blocks[1] = rng.integers(1, 9, (n, n))
        vals, offs = native.rle_encode_blocks(blocks)
        jvals, joffs = jnative.rle_encode_blocks(blocks)
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(offs, joffs)
        for i, b in enumerate(blocks):
            assert list(vals[offs[i]:offs[i + 1]]) == [int(x) for x in TZ.rle_encode_block(b)]
        np.testing.assert_array_equal(native.rle_decode_blocks(vals, offs, n), blocks)
        np.testing.assert_array_equal(native.rle_decode_blocks(vals, offs, n), jnative.rle_decode_blocks(vals, offs, n))


def test_python_fallback_writes_and_reads_the_same_bytes(tmp_path, monkeypatch):
    """Without the C++ library the host route (a list package) falls back to
    the Python RLE twin: the same file as the C++ runtime's and as the coded
    route's (a package=False encode's tensors), and the same decode."""
    y = synthetic_clip(64, 96, 4)
    cfg = _cfg(frames=4, vbs_enable=True, **RC)
    v = _codec(cfg, y)
    pkg = v.encode(package=True)
    v.transmit_bitstream_binary(tmp_path / "native.sob")
    coded = _codec(dataclasses.replace(cfg), y)
    coded.encode(package=False)
    coded.transmit_bitstream_binary(tmp_path / "coded.sob")
    monkeypatch.setattr(native, "rle_encode_blocks", lambda blocks: None)
    monkeypatch.setattr(native, "rle_decode_blocks", lambda vals, offs, n: None)
    v.transmit_bitstream_binary(tmp_path / "python.sob")
    assert (tmp_path / "python.sob").read_bytes() == (tmp_path / "native.sob").read_bytes()
    assert (tmp_path / "coded.sob").read_bytes() == (tmp_path / "native.sob").read_bytes()
    dec = _codec(dataclasses.replace(cfg)).decode_bitstream_binary(tmp_path / "native.sob")
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])
