"""PyTorch port, rate control on one device: parity with JaxCodec.

Twins of ``tests/test_two_pass.py`` and of ``tests/test_jax_engine.py``'s
rate-control and ROI tests, each run through the port and held against the
JAX engine on the same seeded clip and config: frame types (scene-change
promotion), ``Qp_per_row_per_frame``, sizes, MVs, coefficients,
reconstructions and the text bitstream bytes, and each engine decoding the
other's package and stream.  Integer outputs exact; PSNR to 1e-4 (float32 in
another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import smooth_clip, synthetic_clip
from test_parallel import _compare_packages

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu import bitstream as JBS
from streamoptima_tpu import rc as jrc
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch import synthetic_clip as tsynthetic_clip
from streamoptima_tpu_torch import bitstream as TBS
from streamoptima_tpu_torch import rc
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.engine import TorchCodec

torch.set_num_threads(1)
TABLES = [
    [9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
    [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170],
]
TWO_PASS = dict(height=64, width=64, frames=4, block_size=16, search_range=4, qp=4, intra_dur=2, rc_flag=1,
                target_br="150 kbps", frame_rate=30, qp_rate_tables=TABLES)  # test_two_pass.py's
ENGINE = dict(block_size=16, search_range=3, qp=4, intra_dur=3, intra_mode=0, lam=0.015)  # test_jax_engine.py's


def _lists(pkg):
    return pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]


def _both(kw, clip):
    """JaxCodec's and TorchCodec's packages of one clip and config."""
    return JaxCodec(JaxCodecConfig(**kw), clip).encode(), TorchCodec(CodecConfig(**kw), clip, device="cpu").encode()


def _assert_parity(kw, jpkg, tpkg, tmp_path):
    """Bit for bit against JaxCodec (frame types and row QPs included), the
    same text bytes, and each engine decoding the other's package."""
    assert tpkg["frame_type_seq"] == jpkg["frame_type_seq"]
    assert tpkg["Qp_per_row_per_frame"] == jpkg["Qp_per_row_per_frame"]
    _compare_packages(jpkg, tpkg)
    jcfg, cfg = JaxCodecConfig(**kw), CodecConfig(**kw)
    for write, p, c, tag in ((JBS.write_bitstream, jpkg, jcfg, "j"), (TBS.write_bitstream, tpkg, cfg, "t")):
        write(tmp_path / f"{tag}mv.txt", tmp_path / f"{tag}res.txt", p["frame_type_seq"], p["MVS per Frame"],
              p["Qp_per_row_per_frame"], p["approx residual"], c)
    for f in ("mv.txt", "res.txt"):
        assert (tmp_path / f"t{f}").read_bytes() == (tmp_path / f"j{f}").read_bytes(), f
    got = TorchCodec(cfg, device="cpu").decode(*_lists(jpkg))
    np.testing.assert_array_equal(torch.stack(got).numpy(), jpkg["reconstructed frames"])
    dec = JaxCodec(jcfg).decode(*_lists(tpkg))
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in dec]), tpkg["reconstructed frames"])


# ------------------------------------------------------------ two-pass
def test_two_pass_round_trips(tmp_path):
    kw = dict(TWO_PASS, two_pass=True)
    jpkg, tpkg = _both(kw, synthetic_clip(h=64, w=64, frames=4, motion=2))
    assert all(len(q) == 4 for q in tpkg["Qp_per_row_per_frame"])
    _assert_parity(kw, jpkg, tpkg, tmp_path)
    # the file decode reads the row QPs from the stream
    dec = VideoCodec(CodecConfig(**kw), device="cpu").decode_bitstream(tmp_path / "tmv.txt", tmp_path / "tres.txt")
    np.testing.assert_array_equal(dec, tpkg["reconstructed frames"])


def test_two_pass_differs_from_single_pass(tmp_path):
    """A busy top half and a flat bottom half: pass 2 gives the busy rows a
    QP no higher than the flat rows', as the JAX engine does."""
    rng = np.random.default_rng(5)
    clip = np.zeros((4, 64, 64), dtype=np.uint8)
    clip[:, :32] = rng.integers(0, 256, size=(4, 32, 64))
    clip[:, 32:] = 128
    one = TorchCodec(CodecConfig(**dict(TWO_PASS, target_br="80 kbps")), clip, device="cpu").encode()
    kw = dict(TWO_PASS, target_br="80 kbps", two_pass=True)
    jpkg, two = _both(kw, clip)
    assert two["Qp_per_row_per_frame"] != one["Qp_per_row_per_frame"]
    for qps in two["Qp_per_row_per_frame"]:
        assert qps[0] <= qps[3]
    assert any(qps[0] < qps[3] for qps in two["Qp_per_row_per_frame"])
    _assert_parity(kw, jpkg, two, tmp_path)


def test_native_rc_uses_per_type_tables():
    """K9 fix: inter frames take the inter table's row QPs."""
    cfg = CodecConfig(**TWO_PASS)
    pkg = TorchCodec(cfg, synthetic_clip(h=64, w=64, frames=4, motion=2), device="cpu").encode()
    seq_intra, seq_inter = rc.row_qp_sequence(cfg, 0), rc.row_qp_sequence(cfg, 1)
    assert seq_intra != seq_inter
    assert (seq_intra, seq_inter) == (jrc.row_qp_sequence(JaxCodecConfig(**TWO_PASS), 0),
                                      jrc.row_qp_sequence(JaxCodecConfig(**TWO_PASS), 1))
    for ft, qps in zip(pkg["frame_type_seq"], pkg["Qp_per_row_per_frame"]):
        assert qps == (seq_intra if ft == 0 else seq_inter)


# ------------------------------------------------- rate control, promotion
def test_rc_and_promotion(tmp_path):
    """A tiny ``intra_thresh`` promotes every inter frame; at a scene cut
    (frame 3 from another clip) a threshold between the sizes promotes that
    frame alone, and the next inter frame predicts from it alone: the
    promotion empties the two-frame FIFO."""
    kw = dict(height=64, width=64, frames=4, rc_flag=2, target_br="150 kbps", qp_rate_tables=TABLES,
              intra_thresh=100, **dict(ENGINE, intra_dur=4))
    jpkg, tpkg = _both(kw, synthetic_clip(64, 64, 4))
    assert tpkg["frame_type_seq"] == [0, 0, 0, 0]
    _assert_parity(kw, jpkg, tpkg, tmp_path)

    cut = np.concatenate([smooth_clip(64, 64, 3, seed=7, motion=1), smooth_clip(64, 64, 2, seed=9, motion=1)])
    kw = dict(kw, frames=5, intra_dur=8, rc_flag=1, intra_thresh=None, n_ref_frames=2)
    sizes = TorchCodec(CodecConfig(**kw), cut, device="cpu").encode()["residual size per frame"]
    kw = dict(kw, rc_flag=2, intra_thresh=(max(sizes[1:3]) + sizes[3]) // 2)
    assert sizes[3] > kw["intra_thresh"] > max(sizes[1:3] + sizes[4:])
    jpkg, tpkg = _both(kw, cut)
    assert tpkg["frame_type_seq"] == [0, 1, 1, 0, 1]
    _assert_parity(kw, jpkg, tpkg, tmp_path)


# ------------------------------------------------------------------- ROI
def test_roi_qp_map(tmp_path):
    roi = np.zeros((4, 4), dtype=np.int32)
    roi[:2, :2] = -3  # higher quality top-left quadrant
    y = synthetic_clip(64, 64, 2)
    kw = dict(height=64, width=64, frames=2, **dict(ENGINE, qp=6), roi_qp_map=roi)
    jpkg, tpkg = _both(kw, y)
    _assert_parity(kw, jpkg, tpkg, tmp_path)
    rec, src = tpkg["reconstructed frames"][0].astype(np.int64), y[0].astype(np.int64)
    assert ((rec - src)[:32, :32] ** 2).mean() < ((rec - src)[32:, 32:] ** 2).mean()


def test_roi_bitstream_self_describing(tmp_path):
    """The ROI header rides the stream: a facade with a default cfg adopts
    it and decodes exactly; a conflicting or missing map raises."""
    roi = np.zeros((4, 4), dtype=np.int32)
    roi[:2, :2] = -3
    y = synthetic_clip(64, 64, 3)
    kw = dict(height=64, width=64, frames=3, **dict(ENGINE, qp=6, intra_dur=2), roi_qp_map=roi)
    jpkg, tpkg = _both(kw, y)
    _assert_parity(kw, jpkg, tpkg, tmp_path)
    mv, res = tmp_path / "tmv.txt", tmp_path / "tres.txt"
    assert open(mv).readline().startswith("roi|")
    bare = CodecConfig(**dict(kw, roi_qp_map=None))
    dec = VideoCodec(bare, device="cpu").decode_bitstream(mv, res)
    assert bare.roi_qp_map is not None
    np.testing.assert_array_equal(dec, tpkg["reconstructed frames"])
    with pytest.raises(ValueError, match="differs"):
        VideoCodec(CodecConfig(**dict(kw, roi_qp_map=roi + 1)), device="cpu").decode_bitstream(mv, res)
    plain_cfg = CodecConfig(**dict(kw, roi_qp_map=None))
    v = VideoCodec(plain_cfg, y, device="cpu")
    v.encode(compute_ssim=False)
    v.transmit_bitstream(tmp_path / "mv2.txt", tmp_path / "res2.txt")
    with pytest.raises(ValueError, match="no ROI header"):
        VideoCodec(CodecConfig(**kw), device="cpu").decode_bitstream(tmp_path / "mv2.txt", tmp_path / "res2.txt")


def test_roi_adoption_not_sticky(tmp_path):
    """One facade decodes an ROI stream, a plain stream, another ROI stream:
    each adoption rebuilds the decoder, none sticks; a user-set map stays
    strict.  The port's streams are the JAX facade's, byte for byte."""
    y = synthetic_clip(64, 64, 2)
    roi_a = np.zeros((4, 4), np.int32)
    roi_a[0, 3] = -3
    roi_b = np.zeros((4, 4), np.int32)
    roi_b[3, 0] = -2
    kw = dict(height=64, width=64, frames=2, **dict(ENGINE, intra_dur=2))
    streams = {}
    for name, roi in (("a", roi_a), ("b", roi_b), ("plain", None)):
        codec = VideoCodec(CodecConfig(**kw, roi_qp_map=roi), y, device="cpu")
        pkg = codec.encode(compute_ssim=False)
        mv, res = tmp_path / f"mv_{name}.txt", tmp_path / f"res_{name}.txt"
        codec.transmit_bitstream(mv, res)
        streams[name] = (mv, res, pkg["reconstructed frames"])
    jv = JaxVideoCodec(JaxCodecConfig(**kw, roi_qp_map=roi_a), y)
    jv.encode(compute_ssim=False)
    jv.transmit_bitstream(tmp_path / "jmv.txt", tmp_path / "jres.txt")
    assert (tmp_path / "jmv.txt").read_bytes() == streams["a"][0].read_bytes()
    assert (tmp_path / "jres.txt").read_bytes() == streams["a"][1].read_bytes()
    dec = VideoCodec(CodecConfig(**kw), device="cpu")
    jdec = JaxVideoCodec(JaxCodecConfig(**kw))
    for name in ("a", "plain", "b", "a", "plain"):
        mv, res, want = streams[name]
        np.testing.assert_array_equal(dec.decode_bitstream(mv, res), want, err_msg=name)
        np.testing.assert_array_equal(jdec.decode_bitstream(mv, res), want, err_msg=name)
    strict = VideoCodec(CodecConfig(**kw, roi_qp_map=roi_a), device="cpu")
    with pytest.raises(ValueError, match="differs"):
        strict.decode_bitstream(*streams["b"][:2])
    with pytest.raises(ValueError, match="no ROI header"):
        strict.decode_bitstream(*streams["plain"][:2])


def test_intra_mode1_roi_lands_on_pixel_blocks(tmp_path):
    """Intra mode 1 numbers blocks in transposed order; ROI offsets still
    land on pixel blocks (a non-square frame, so the transpose cannot
    alias)."""
    h, w, frames = 48, 80, 2
    y = synthetic_clip(h, w, frames)
    roi = np.zeros((h // 16, w // 16), np.int32)
    roi[0, 4] = 6  # heavily degrade pixel block row 0, column 4 only
    base = dict(height=h, width=w, frames=frames, **dict(ENGINE, intra_mode=1, intra_dur=1, qp=1))
    p0 = TorchCodec(CodecConfig(**base), y, device="cpu").encode()
    kw = dict(base, roi_qp_map=roi)
    jpkg, p1 = _both(kw, y)
    _assert_parity(kw, jpkg, p1, tmp_path)

    def block_err(pkg, r, c):
        d = pkg["reconstructed frames"][1].astype(np.int64) - y[1].astype(np.int64)
        return np.abs(d[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16]).mean()

    assert block_err(p1, 0, 4) > block_err(p0, 0, 4) + 1.0
    assert block_err(p1, 2, 0) <= block_err(p0, 2, 0) + 0.5


# ------------------------------------------ with the port's other tools
@pytest.mark.parametrize("extra", [
    dict(fast_me=True, vbs_enable=True, fme_enable=True, search_range=8, n_ref_frames=2, rc_flag=2,
         intra_thresh=2000, two_pass=True),
    dict(vbs_enable=True, fme_enable=True, n_ref_frames=2, search_range=4, rc_flag=1, roi="centre"),
], ids=["fast_vbs_fme_nref2_promotion_two_pass", "vbs_fme_nref2_rc_roi"])
def test_rc_with_the_other_tools(extra, tmp_path):
    """Rate control beside fast ME, VBS, FME and two references, with
    promotion under two-pass (pass 2 keeps pass 1's frame types; a promoted
    frame empties the two-frame FIFO) and with an ROI map over the per-row
    QPs (the clip to [0, 12]), on a smooth clip with a scene cut at frame
    3."""
    extra = dict(extra)
    if extra.pop("roi", None):
        roi = np.full((4, 6), 2, np.int32)
        roi[1:3, 2:4] = -9  # below QP 0: clipped to 0
        roi[0, :3] = 9  # above QP 12: clipped to 12
        extra["roi_qp_map"] = roi
    kw = dict(height=64, width=96, frames=5, qp=4, intra_dur=8, lam=0.015, target_br="60 kbps",
              qp_rate_tables=TABLES, **extra)
    clip = np.concatenate([tsynthetic_clip(64, 96, 3, seed=3), tsynthetic_clip(64, 96, 2, seed=4)])
    jpkg, tpkg = _both(kw, clip)
    assert len({tuple(q) for q in tpkg["Qp_per_row_per_frame"]}) > 1
    if "intra_thresh" in kw:
        assert 0 in tpkg["frame_type_seq"][1:] and 1 in tpkg["frame_type_seq"]
    _assert_parity(kw, jpkg, tpkg, tmp_path)


def test_measure_qp_tables_matches_the_jax_steps():
    """``rc.measure_qp_tables`` on ``TorchCodec``'s steps equals the JAX
    package's measurement (``JaxCodec``'s steps, as its ``rc.measure_qp_tables``
    takes them) at the first, a middle and the last QP."""
    import jax.numpy as jnp

    y = synthetic_clip(32, 48, 3)
    kw = dict(height=32, width=48, frames=3, search_range=4, qp=4, intra_dur=2)
    tables = rc.measure_qp_tables(CodecConfig(**kw), y, sample_frames=2, device="cpu")
    assert [len(t) for t in tables] == [12, 12]
    for qp in (0, 5, 11):
        codec = JaxCodec(dataclasses.replace(JaxCodecConfig(**kw), qp=qp), y)
        intra = [8.0 * float(jnp.mean(codec._intra_step_j(codec._y_dev[i], codec.row_qps,
                                                           codec._y_dev[i])["row_bits"].astype(jnp.float32)))
                 for i in (1, 2)]
        inter = [8.0 * float(jnp.mean(codec._inter_step_j(codec._y_dev[i], codec._y_dev[i - 1:i], codec.row_qps,
                                                           codec._y_dev[i], nref=1, initial_refs=False)
                                      ["row_bits"].astype(jnp.float32)))
                 for i in (1, 2)]
        assert tables[0][qp] == float(np.mean(intra)) and tables[1][qp] == float(np.mean(inter)), qp
