"""PyTorch port, its own copies of the JAX package's JAX-free pieces.

The port keeps copies of the configuration, text bitstream, host serializer,
video I/O, synthetic clips, host SSIM and the rate control's host functions
so that it never imports the JAX package.  Each copy is held here against its original on the same seeded
inputs: exact equality everywhere (the host SSIM runs the same float64
numpy operations in the same order).
"""
import numpy as np
import pytest

from streamoptima_tpu import bitstream as JBS
from streamoptima_tpu import config as JC
from streamoptima_tpu import metrics as JM
from streamoptima_tpu import rc as JRC
from streamoptima_tpu.core import zigzag as JZ
from streamoptima_tpu.io.video import VideoManager as JVM
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu.utils import synthetic_clip as jax_synthetic_clip
from streamoptima_tpu_torch import bitstream as TBS
from streamoptima_tpu_torch import config as TC
from streamoptima_tpu_torch import metrics as TM
from streamoptima_tpu_torch import rc as TRC
from streamoptima_tpu_torch import synthetic_clip
from streamoptima_tpu_torch.core import zigzag as TZ
from streamoptima_tpu_torch.io.video import VideoManager as TVM


@pytest.mark.parametrize("kw", [dict(seed=42), dict(seed=7, motion=1, smooth=False)])
def test_synthetic_clip_matches_jax_package(kw):
    np.testing.assert_array_equal(synthetic_clip(32, 48, 3, **kw), jax_synthetic_clip(32, 48, 3, **kw))


def test_ssim_matches_jax_package():
    rng = np.random.default_rng(0)
    a = synthetic_clip(48, 64, 1, seed=1)[0]
    b = np.clip(a.astype(np.int32) + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    assert TM.ssim(a, b) == JM.ssim(a, b)
    assert TM.ssim(a, a) == JM.ssim(a, a) == 1.0


@pytest.mark.parametrize("numpy_repr", [False, True])
@pytest.mark.parametrize("n", [8, 16])
def test_rle_blocks_match_jax_package(n, numpy_repr):
    rng = np.random.default_rng(n + numpy_repr)
    for density in (0.0, 0.1, 0.6, 1.0):
        block = np.where(rng.random((n, n)) < density, rng.integers(-300, 301, (n, n)), 0)
        enc = TZ.rle_encode_block(block, numpy_repr)
        assert enc == JZ.rle_encode_block(block, numpy_repr)
        assert str(enc) == str(JZ.rle_encode_block(block, numpy_repr))  # the text the bitstream writes
        np.testing.assert_array_equal(TZ.rle_decode_block(enc, n), block)
        np.testing.assert_array_equal(TZ.rle_decode_block(enc, n), JZ.rle_decode_block(enc, n))


@pytest.mark.parametrize("kw", [
    dict(height=64, width=96, frames=4),
    dict(height=64, width=96, frames=4, vbs_enable=True, fme_enable=True, search_range=8),
    dict(height=32, width=48, frames=2, rc_flag=1, target_br="2 mbps", qp_rate_tables=[[1.0] * 12] * 2),
    dict(height=32, width=48, frames=2, engine="compat"),
])
def test_config_matches_jax_package(kw):
    t, j = TC.CodecConfig(**kw), JC.CodecConfig(**kw)
    for name in ("lam", "sub_block_size", "blocks_per_row", "block_rows", "n_blocks", "target_bitrate",
                 "bitrate_per_row", "rc_active", "bitstream_numpy_repr", "compat"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.intra_canvas == j.intra_canvas  # under compat the reference's 288x352 canvas


@pytest.mark.parametrize("kw", [
    dict(height=60, width=96, frames=4),  # not a multiple of the block size
    dict(height=64, width=96, frames=4, intra_mode=2),
    dict(height=64, width=96, frames=4, n_ref_frames=9),
    dict(height=64, width=96, frames=4, fme_enable=True, search_range=64),  # grid range 128 > 127
    dict(height=64, width=96, frames=4, engine="cuda"),
    dict(height=64, width=96, frames=4, two_pass=True),  # two-pass without rate control
])
def test_config_refuses_what_the_jax_package_refuses(kw):
    with pytest.raises(ValueError):
        JC.CodecConfig(**kw)
    with pytest.raises(ValueError):
        TC.CodecConfig(**kw)


def test_config_refuses_promotion_without_a_threshold():
    """``rc_flag > 1`` compares each inter frame's size with
    ``intra_thresh``: the JAX package takes the config and fails at the
    first inter frame with a TypeError; the port refuses it by name."""
    kw = dict(height=64, width=64, frames=3, rc_flag=2, target_br="1 mbps", qp_rate_tables=[[1.0] * 12] * 2)
    with pytest.raises(TypeError):
        JaxCodec(JC.CodecConfig(**kw), synthetic_clip(64, 64, 3)).encode()
    with pytest.raises(ValueError, match="intra_thresh"):
        TC.CodecConfig(**kw)
    TC.CodecConfig(**kw, intra_thresh=400)


@pytest.mark.parametrize("ftype", [0, 1])
def test_serializers_match_jax_package(ftype):
    """The port's serializers (native fast path and Python twin) write the
    JAX package's bytes for one frame's MV and residual lines."""
    rng = np.random.default_rng(ftype)
    nb, nbc = 24, 6
    split = rng.random(nb) < 0.4
    qf = np.where(rng.random((nb, 16, 16)) < 0.1, rng.integers(-40, 41, (nb, 16, 16)), 0).astype(np.int16)
    qq = np.where(rng.random((nb, 4, 8, 8)) < 0.1, rng.integers(-40, 41, (nb, 4, 8, 8)), 0).astype(np.int16)
    shape = (nb, 3) if ftype else (nb,)
    mv = rng.integers(-16, 17, shape).astype(np.int32)
    smv = rng.integers(-16, 17, (nb, 4) + shape[1:]).astype(np.int32)
    if ftype:
        mv[:, 2], smv[:, :, 2] = 0, 0
    m3, s3 = TBS.widen_mvs(ftype, mv, smv)
    jm3, js3 = JBS.widen_mvs(ftype, mv, smv)
    np.testing.assert_array_equal(m3, jm3)
    np.testing.assert_array_equal(s3, js3)
    fm = TBS.FrameMVArrays(ftype, m3, split, s3)
    mv_line = TBS._mv_line(ftype, fm, [], TC.CodecConfig(height=64, width=96, frames=1))
    assert mv_line == TBS.encode_mv_frame(ftype, TBS.mv_arrays_to_list(fm), [], False, nbc)
    assert mv_line == JBS.encode_mv_frame(ftype, JBS.mv_arrays_to_list(JBS.FrameMVArrays(ftype, m3, split, s3)),
                                          [], False, nbc)
    lists = [(1, [qq[i, q] for q in range(4)]) if split[i] else (0, qf[i]) for i in range(nb)]
    res_line = TBS.encode_residual_frame_arrays(qf, qq, split, False)
    assert res_line == TBS.encode_residual_frame(lists, 16, False) == JBS.encode_residual_frame(lists, 16, False)
    ft, mvs, _ = TBS.decode_mv_frame(f"{ftype}|{mv_line}", False, nbc)
    assert (ft, mvs) == JBS.decode_mv_frame(f"{ftype}|{mv_line}", False, nbc)[:2]
    for (sa, a), (sb, b) in zip(TBS.decode_residual_frame(res_line, 16), JBS.decode_residual_frame(res_line, 16)):
        assert sa == sb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_roi_header_and_y_plane_io_match_jax_package(tmp_path):
    roi = np.arange(24, dtype=np.int32) % 5 - 2
    line = TBS.encode_roi_header(roi, 4, 6)
    assert line == JBS.encode_roi_header(roi, 4, 6)
    np.testing.assert_array_equal(TBS.decode_roi_header(line), JBS.decode_roi_header(line))
    clip = synthetic_clip(32, 48, 3)
    TVM.save_y_only(tmp_path / "t.y", clip)
    JVM.save_y_only(tmp_path / "j.y", clip)
    assert (tmp_path / "t.y").read_bytes() == (tmp_path / "j.y").read_bytes()
    np.testing.assert_array_equal(TVM.read_y_only(tmp_path / "t.y", 32, 48, 3), clip)
    yuv = np.random.default_rng(3).integers(0, 256, 3 * 32 * 48 * 3 // 2).astype(np.uint8)
    yuv.tofile(tmp_path / "c.yuv")
    np.testing.assert_array_equal(TVM.read_yuv420_y(tmp_path / "c.yuv", 32, 48, 3),
                                  JVM.read_yuv420_y(tmp_path / "c.yuv", 32, 48, 3))


RC_TABLES = {
    "sweep": [[2e5, 1.2e5, 8e4, 5e4, 3e4, 2e4, 1.2e4, 8e3, 5e3, 3e3, 2e3, 1.2e3]] * 2,
    "two_pass": [[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
                 [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170]],
}


@pytest.mark.parametrize("tables", list(RC_TABLES))
@pytest.mark.parametrize("target_br", ["20 kbps", "150 kbps", "8 mbps", "200 mbps"])
@pytest.mark.parametrize("engine", ["jax", "compat"])
def test_rc_host_functions_match_jax_package(tables, target_br, engine):
    """``rc``'s numpy functions on a grid of budgets and tables: the row QP
    sequences of both frame types, the first-pass shares, the two-pass
    budgets and QPs, and ``pick_qp``.  Budgets below every table entry take
    the largest QP on the native engine (the clamp in place of the
    reference's crash, bug B6) and raise under compat, in both packages."""
    kw = dict(height=720, width=1280, frames=2, rc_flag=1, target_br=target_br, qp_rate_tables=RC_TABLES[tables],
              engine=engine)
    t, j = TC.CodecConfig(**kw), JC.CodecConfig(**kw)
    low = t.bitrate_per_row < min(RC_TABLES[tables][0])
    for ftype in (0, 1):
        if low and engine == "compat":
            with pytest.raises(ValueError, match="B6"):
                TRC.row_qp_sequence(t, ftype)
            with pytest.raises(ValueError, match="B6"):
                JRC.row_qp_sequence(j, ftype)
            continue
        seq = TRC.row_qp_sequence(t, ftype)
        assert seq == JRC.row_qp_sequence(j, ftype)
        if low:
            assert seq == [11] * t.block_rows
    rng = np.random.default_rng(len(target_br))
    for row_bits in (rng.integers(0, 5000, 45), np.zeros(45, np.int64), np.r_[np.zeros(44), 7]):
        cum = np.cumsum(row_bits)
        np.testing.assert_array_equal(TRC.row_wise_stats(cum), JRC.row_wise_stats(cum))
        stats = TRC.row_wise_stats(cum)
        np.testing.assert_array_equal(TRC.two_pass_row_budgets(t, stats), JRC.two_pass_row_budgets(j, stats))
        for ftype in (0, 1):
            fallback = np.full(45, 4, np.int32)
            np.testing.assert_array_equal(TRC.second_pass_row_qps(t, row_bits, ftype, fallback),
                                          JRC.second_pass_row_qps(j, row_bits, ftype, fallback))
    budgets = np.r_[0.0, 1.0, RC_TABLES[tables][1], 1e9]
    assert TRC.row_qp_from_budgets(t, budgets, 1) == JRC.row_qp_from_budgets(j, budgets, 1)
    table = RC_TABLES[tables][0]
    for b in budgets:
        if b > min(table):
            assert TRC.pick_qp(table, b) == JRC.pick_qp(table, b)
        else:
            with pytest.raises(ValueError, match="B6"):
                TRC.pick_qp(table, b)
