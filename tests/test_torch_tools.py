"""PyTorch port, the matrix of coding tools on one device, run on the CPU: parity with JAX.

The configurations the port runs besides the four main paths: VBS alone and
FME alone (full search and fast ME), several reference frames, intra mode 1
and the three parallel modes.  Kernel level: the plain versions of the
whole-pel VBS search, the FME search without VBS and the two new fetch
modes against the JAX package's Pallas kernels in interpret mode (at the
smaller shapes: interpret mode is slow) and its numpy oracles.  Engine
level: ``TorchCodec`` against ``JaxCodec`` at 64x96 on up to 6 frames, the
per-frame outputs (MVs, splits, sub-MVs, both coefficient sets, sizes, row
bits, reconstructions) and the text bitstream bytes, with each engine
decoding the other's stream.  Integer outputs are compared exactly; PSNR and
MAE (float32, reductions in another order) to 1e-4.  Each JAX encode is
shared by a module-scoped fixture.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu.core import me as JME
from streamoptima_tpu.core import me_pallas as MP
from streamoptima_tpu.core import pred as JP
from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as TME
from streamoptima_tpu_torch.engine import TorchCodec, check_slice
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

torch.set_num_threads(1)
BLOCK_KEYS = ("mv", "sad", "ok")
QUAD_KEYS = ("sub_mv", "sub_sad", "sub_ok")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _search_inputs(h, w, nref, content):
    if content == "flat":  # every candidate of every reference ties
        return np.full((h, w), 90, np.uint8), np.full((nref, h, w), 90, np.uint8)
    rng = np.random.default_rng(h + w + nref)
    return rng.integers(0, 256, (h, w)).astype(np.uint8), rng.integers(0, 256, (nref, h, w)).astype(np.uint8)


def _assert_keys(got, ref, keys):
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


# ------------------------------------------------------ the two searches
SEARCH_GRID = [(h, w, nref, sr, content) for h, w in ((32, 48), (64, 96)) for nref in (1, 3) for sr in (4, 8)
               for content in ("random", "flat")]


@pytest.mark.parametrize("h,w,nref,sr,content", SEARCH_GRID)
def test_vbs_search_plain_matches_jax_package(h, w, nref, sr, content):
    """The whole-pel VBS search against the numpy oracle, and against
    ``full_search_pallas(vbs=True)`` in interpret mode at 32x48."""
    cur, refs = _search_inputs(h, w, nref, content)
    got = K.full_search_vbs(_t(cur), _t(refs), sr, 16)
    ref = JME.full_search_materialized(cur.astype(np.int32), refs.astype(np.int32), sr, 16, 8, 1, False, True, np)
    _assert_keys(got, ref, BLOCK_KEYS + QUAD_KEYS)
    if h == 32:
        pal = MP.full_search_pallas(jnp.asarray(cur, jnp.int32), jnp.asarray(refs, jnp.int32), sr, 16, 8, True,
                                    interpret=True, want_pred=False)
        _assert_keys(got, pal, BLOCK_KEYS + QUAD_KEYS)
    if content == "flat":  # the smallest packed key wins: least L1 (1 or 2 at the strict edges), reference 0
        for m in (got["mv"].numpy(), got["sub_mv"].numpy()):
            assert (m[..., 2] == 0).all() and (np.abs(m[..., :2]).sum(-1) <= 2).all()
    elif nref == 3:
        assert (got["sub_mv"].numpy()[..., 2] > 0).any()  # quads pick later references too


def test_vbs_search_quads_are_valid_where_their_block_is_not():
    """One block column (w = bs): x + dx < w - bs holds for no dx, so no block
    has a candidate, while each quad, checked at its own origin and size,
    has some."""
    cur, refs = _search_inputs(48, 16, 1, "random")
    got = K.full_search_vbs(_t(cur), _t(refs), 4, 16)
    ref = JME.full_search_materialized(cur.astype(np.int32), refs.astype(np.int32), 4, 16, 8, 1, False, True, np)
    _assert_keys(got, ref, BLOCK_KEYS + QUAD_KEYS)
    assert not got["ok"].any() and (got["sad"].numpy() == 2**31 - 1).all() and (got["mv"].numpy() == 0).all()
    assert got["sub_ok"].all()
    assert (got["sub_mv"].numpy()[:, 1, 0] < 0).all()  # the right quads must look left


@pytest.mark.parametrize("h,w,nref,sr,content", SEARCH_GRID)
def test_fme_search_plain_matches_jax_package(h, w, nref, sr, content):
    """The FME search without VBS against the numpy oracle on the JAX
    package's upsample, and against ``full_search_pallas_fme(vbs=False)`` in
    interpret mode at 32x48 with one reference."""
    cur, refs = _search_inputs(h, w, nref, content)
    got = K.full_search_fme(_t(cur), TME.fme_parity_planes(_t(refs), True), sr, 16)
    assert set(got) == set(BLOCK_KEYS)
    up = np.stack([JME.fme_upsample(r, np, wrap_row_pass=True) for r in refs])
    ref = JME.full_search_materialized(cur.astype(np.int32), up, 2 * sr, 16, 8, 2, True, False, np)
    _assert_keys(got, ref, BLOCK_KEYS)
    if h == 32 and nref == 1:
        pal = MP.full_search_pallas_fme(jnp.asarray(cur, jnp.int32), jnp.asarray(refs), sr, 16, 8, False,
                                        interpret=True, want_pred=False, wrap_row_pass=True)
        _assert_keys(got, pal, BLOCK_KEYS)
    assert got["ok"].any() and not got["ok"].all()  # the FME margin leaves the edge blocks without a candidate


# ------------------------------------------------------ the two fetches
def _coords(h, w, bs=16):
    ys, xs = np.meshgrid(np.arange(h // bs) * bs, np.arange(w // bs) * bs, indexing="ij")
    bx, by = xs.reshape(-1), ys.reshape(-1)
    offs = np.array([[0, 0], [0, 1], [1, 0], [1, 1]]) * (bs // 2)
    return bx, by, bx[:, None] + offs[None, :, 1], by[:, None] + offs[None, :, 0]


def _mvs(rng, nb, bound, nref):
    mv = np.stack([rng.integers(-bound, bound + 1, nb), rng.integers(-bound, bound + 1, nb),
                   rng.integers(0, nref, nb)], 1).astype(np.int32)
    smv = np.stack([rng.integers(-bound, bound + 1, (nb, 4)), rng.integers(-bound, bound + 1, (nb, 4)),
                    rng.integers(0, nref, (nb, 4))], 2).astype(np.int32)
    return mv, smv


def _plane_of(blocks, h, w, n):
    """(h/n * w/n, n, n) blocks in the (sub)block raster of ``_coords`` -> (h, w)."""
    return blocks.reshape(h // n, w // n, n, n).swapaxes(1, 2).reshape(h, w)


@pytest.mark.parametrize("bound", [4, 40, 5000])
@pytest.mark.parametrize("nref", [1, 3])
def test_whole_pel_quad_fetch_plain_matches_jax_package(nref, bound):
    """``pred_fetch_vbs``: every block and quad at its own MV, windows inside,
    straddling and wholly outside the frame, against the numpy gather."""
    h, w = 48, 64
    rng = np.random.default_rng(nref * bound)
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    mv, smv = _mvs(rng, 12, bound, nref)
    bx, by, qx, qy = _coords(h, w)
    got_f, got_q = K.pred_fetch_vbs(_t(mv), _t(smv), _t(refs), 16)
    assert got_f.dtype == got_q.dtype == torch.int16
    full = JP.gather_predictions(mv, refs.astype(np.int32), bx, by, 16, False, np)
    quads = JP.gather_predictions(smv.reshape(-1, 3), refs.astype(np.int32), qx.reshape(-1), qy.reshape(-1), 8,
                                  False, np)
    np.testing.assert_array_equal(got_f.numpy(), _plane_of(full, h, w, 16))
    # quads in Z order per block -> the quad raster
    q = quads.reshape(h // 16, w // 16, 2, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5).reshape(-1, 8, 8)
    np.testing.assert_array_equal(got_q.numpy(), _plane_of(q, h, w, 8))


def test_whole_pel_quad_fetch_plain_matches_pallas_kernel():
    """In-bounds MVs (what the search and every well-formed stream give)
    through ``pred_fetch_compact`` with VBS in interpret mode."""
    h, w, sr = 48, 64, 4
    rng = np.random.default_rng(3)
    refs = rng.integers(0, 256, (1, h, w)).astype(np.uint8)
    mv, smv = _mvs(rng, 12, sr, 1)
    bx, by, qx, qy = _coords(h, w)
    mv[:, 0] = np.clip(mv[:, 0], -bx, w - 16 - 1 - bx)
    mv[:, 1] = np.clip(mv[:, 1], -by, h - 16 - 1 - by)
    smv[:, :, 0] = np.clip(smv[:, :, 0], -qx, w - 8 - 1 - qx)
    smv[:, :, 1] = np.clip(smv[:, :, 1], -qy, h - 8 - 1 - qy)
    assert MP.fetch_decodable(mv, smv, sr, False, True, h, w, 16, 8)
    tab, pad = MP.build_fetch_table(mv, smv, sr, False, True, h // 16, w // 16, 16)
    pf, pq = MP.pred_fetch_compact(jnp.asarray(mv), jnp.asarray(smv), jnp.asarray(refs), jnp.asarray(tab), pad, 16,
                                   8, True, False, interpret=True)
    got_f, got_q = K.pred_fetch_vbs(_t(mv), _t(smv), _t(refs), 16)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(pf))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(pq))


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("bound", [8, 40, 300])
def test_fme_fetch_without_quads_plain_matches_jax_package(bound, wrap):
    """``pred_fetch_fme``: cases A, B and C against the numpy gather on the
    JAX package's upsample, and equal to ``pred_fetch_fme_vbs``'s block plane."""
    h, w = 48, 64
    rng = np.random.default_rng(bound + wrap)
    refs = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    mv, smv = _mvs(rng, 12, bound, 2)
    mv[5], mv[11] = (1, 1, 0), (0, 0, 1)  # case A at odd displacements; case B at the bottom-right block
    planes = TME.fme_parity_planes(_t(refs), wrap)
    got = K.pred_fetch_fme(_t(mv), planes, 16)
    up = np.stack([JME.fme_upsample(r, np, wrap_row_pass=wrap) for r in refs])
    bx, by, _, _ = _coords(h, w)
    np.testing.assert_array_equal(got.numpy(), _plane_of(JP.gather_predictions(mv, up, bx, by, 16, True, np), h, w,
                                                         16))
    np.testing.assert_array_equal(got.numpy(), K.pred_fetch_fme_vbs(_t(mv), _t(smv), planes, 16)[0].numpy())
    assert (got.numpy()[32:, 48:] == 128).all()


def test_new_wrappers_refuse_what_the_kernels_do_not_take_and_launch_nothing_on_cpu():
    cur, refs = torch.zeros((48, 64), dtype=torch.uint8), torch.zeros((2, 48, 64), dtype=torch.uint8)
    planes = torch.zeros((2, 4, 48, 64), dtype=torch.uint8)
    mv, smv = torch.zeros((12, 3), dtype=torch.int32), torch.zeros((12, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="refs"):
        K.full_search_vbs(cur, refs[:, :32].contiguous(), 4, 16)
    with pytest.raises(ValueError, match="even block size"):
        K.full_search_vbs(torch.zeros((45, 60), dtype=torch.uint8), torch.zeros((1, 45, 60), dtype=torch.uint8), 4,
                          15)
    with pytest.raises(ValueError, match="planes"):
        K.full_search_fme(cur, refs.reshape(2, 1, 48, 64), 4, 16)
    with pytest.raises(ValueError, match="nref"):
        K.full_search_fme(cur, torch.zeros((9, 4, 48, 64), dtype=torch.uint8), 4, 16)
    with pytest.raises(ValueError, match="sub_mv"):
        K.pred_fetch_vbs(mv, mv, refs, 16)
    with pytest.raises(TypeError):
        K.pred_fetch_fme(mv, planes.to(torch.int16), 16)
    with pytest.raises(ValueError, match="blocks"):
        K.pred_fetch_fme(mv[:11].contiguous(), planes, 16)
    counters = (K.full_search_vbs, K.full_search_fme, K.pred_fetch_vbs, K.pred_fetch_fme)
    before = [f.launches for f in counters]
    K.full_search_vbs(cur, refs, 4, 16)
    K.full_search_fme(cur, planes, 4, 16)
    K.pred_fetch_vbs(mv, smv, refs, 16)
    K.pred_fetch_fme(mv, planes, 16)
    assert [f.launches for f in counters] == before  # CPU tensors: the plain versions, no launch


# ------------------------------------------------------------ the engine
BASE = dict(height=64, width=96, frames=6, qp=4, intra_dur=4, lam=0.015)
FAST = dict(fast_me=True, search_range=16)
CASES = {
    "vbs": dict(search_range=8, vbs_enable=True),
    "fme": dict(search_range=8, fme_enable=True),
    "fast_vbs": dict(FAST, vbs_enable=True),
    "fast_fme": dict(FAST, fme_enable=True),
    "nref3": dict(search_range=8, n_ref_frames=3),
    "nref3_fast_vbs_fme": dict(FAST, n_ref_frames=3, vbs_enable=True, fme_enable=True),
    # one GOP of six frames: the last two search a FIFO four deep
    "nref4_vbs_fme": dict(search_range=4, n_ref_frames=4, vbs_enable=True, fme_enable=True, intra_dur=8),
    "intra1_sr8": dict(search_range=8, intra_mode=1),
    "intra1_sr8_vbs": dict(search_range=8, intra_mode=1, vbs_enable=True),
    "intra1_sr16": dict(search_range=16, intra_mode=1),
    "intra1_sr16_vbs": dict(search_range=16, intra_mode=1, vbs_enable=True),
    "pm1": dict(search_range=8, parallel_mode=1),
    "pm2_fast": dict(FAST, parallel_mode=2),
    "pm2_fast_vbs_fme": dict(FAST, parallel_mode=2, vbs_enable=True, fme_enable=True),
    "pm3": dict(search_range=8, parallel_mode=3),
    "pm3_fast": dict(FAST, parallel_mode=3),
}


def _clip(h, w, frames):
    """A smooth texture moving one pixel per frame with a patch of noise in
    every inter frame, so splits occur and some winners are not the motion."""
    fine = synthetic_clip(h + 16, w + 16, 1, seed=21)[0]
    clip = np.stack([fine[i:i + h, i:i + w] for i in range(frames)])
    rng = np.random.default_rng(21)
    for i in range(1, frames):
        clip[i, 18:34, 40:72] = rng.integers(0, 256, (16, 32))
    return clip


@pytest.fixture(scope="module", params=list(CASES))
def encoded(request, tmp_path_factory):
    """Both engines' encodes and text bitstreams of one clip, one case."""
    kw = dict(BASE, **CASES[request.param])
    clip = _clip(kw["height"], kw["width"], kw["frames"])
    d = tmp_path_factory.mktemp(request.param)
    jv = JaxVideoCodec(JaxCodecConfig(**kw), clip)
    jpkg = jv.encode(compute_ssim=False, package=False)
    jv.transmit_bitstream(d / "jmv.txt", d / "jres.txt")
    tv = VideoCodec(CodecConfig(**kw), clip, device="cpu")
    tpkg = tv.encode(package=False)
    tv.transmit_bitstream(d / "tmv.txt", d / "tres.txt")
    return {"name": request.param, "kw": kw, "dir": d, "jpkg": jpkg, "tpkg": tpkg}


@pytest.mark.parametrize("key", ["mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "row_bits", "recon"])
def test_tools_per_frame_outputs_bit_identical(encoded, key):
    for i, (a, b) in enumerate(zip(encoded["tpkg"]["per_frame"], encoded["jpkg"]["per_frame"])):
        np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=f"frame {i} {key}")


def test_tools_package_metrics_and_real_state(encoded):
    """The packages agree, and each case's state is what its tools make."""
    t, j, kw, name = encoded["tpkg"], encoded["jpkg"], encoded["kw"], encoded["name"]
    assert t["frame_type_seq"] == j["frame_type_seq"]
    assert t["residual size per frame"] == j["residual size per frame"]
    np.testing.assert_allclose(t["PSNR per frame"], j["PSNR per frame"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["MAE per Frame"], j["MAE per Frame"], rtol=0, atol=1e-4)
    pf, fts = t["per_frame"], t["frame_type_seq"]
    assert fts == ([1] * 6 if kw.get("parallel_mode") == 1 else [int(i % kw["intra_dur"] != 0) for i in range(6)])
    inter = [o for o, ft in zip(pf, fts) if ft == 1]
    mvs = np.concatenate([o["mv"].numpy() for o in inter])
    splits = sum(int(o["split"].sum()) for o in pf)
    assert (splits > 0) == kw.get("vbs_enable", False)
    if kw.get("fme_enable"):
        assert (mvs[:, :2] % 2 != 0).any()  # half-pel winners
    refs_used = set(mvs[:, 2].tolist())
    assert refs_used == set(range(kw.get("n_ref_frames", 1)))
    if kw.get("parallel_mode") == 2:  # every block searches the 3x3 around zero
        assert np.abs(mvs[:, :2]).max() == 1 and t["fast_me_passes"] == []
    elif kw.get("fast_me") and kw.get("parallel_mode") != 1:
        assert len(t["fast_me_passes"]) == len(inter)
    assert all(int(o["row_bits"].sum()) == int(o["size"]) for o in pf)


def test_tools_text_bitstream_bytes_identical(encoded):
    d = encoded["dir"]
    assert (d / "tmv.txt").read_bytes() == (d / "jmv.txt").read_bytes()
    assert (d / "tres.txt").read_bytes() == (d / "jres.txt").read_bytes()


def test_tools_cross_decode_from_files(encoded):
    d, kw = encoded["dir"], encoded["kw"]
    dec = VideoCodec(CodecConfig(**kw), device="cpu").decode_bitstream(d / "jmv.txt", d / "jres.txt")
    np.testing.assert_array_equal(dec, encoded["jpkg"]["reconstructed frames"])
    jdec = JaxVideoCodec(JaxCodecConfig(**kw)).decode_bitstream(d / "tmv.txt", d / "tres.txt")
    np.testing.assert_array_equal(jdec, encoded["tpkg"]["reconstructed frames"])


# ------------------------------------------------------------- the guards
@pytest.mark.parametrize("kw,feature", [
    ({"rc_flag": 1, "target_br": "1 mbps", "qp_rate_tables": [[1.0] * 12] * 2}, "rc_flag"),
    ({"roi_qp_map": np.zeros(24, np.int32)}, "roi_qp_map"),
    ({"rc_flag": 1, "target_br": "1 mbps", "qp_rate_tables": [[1.0] * 12] * 2, "two_pass": True}, "two_pass"),
])
@pytest.mark.parametrize("tools", ["vbs", "nref3_fast_vbs_fme", "intra1_sr16_vbs", "pm2_fast"])
def test_check_slice_refuses_rc_roi_two_pass_by_name(tools, kw, feature):
    """Rate control, the ROI map and two-pass pass ``check_slice`` and
    construct on one device beside every tool set.  The mesh runs them too,
    and encodes them as one device does; it refuses parallel modes with
    ValueError, as the JAX mesh does."""
    cfg = CodecConfig(**BASE, **CASES[tools], **kw)
    check_slice(cfg)
    TorchCodec(cfg, device="cpu")
    mesh = make_mesh(cfg, devices=["cpu"] * 2)
    if "parallel_mode" in CASES[tools]:
        with pytest.raises(ValueError, match="parallel_mode"):
            ShardedCodec(cfg, mesh)
        return
    clip = synthetic_clip(BASE["height"], BASE["width"], BASE["frames"], seed=3)
    pkg = ShardedCodec(cfg, mesh, clip).encode()
    one = TorchCodec(cfg, clip, device="cpu").encode()
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame", "MVS per Frame"):
        assert pkg[k] == one[k], k
    np.testing.assert_array_equal(pkg["reconstructed frames"], one["reconstructed frames"])


def test_every_tool_combination_passes_check_slice():
    for vbs in (False, True):
        for fme in (False, True):
            for fast in (False, True):
                for pm in (0, 1, 2, 3):
                    for mode in (0, 1):
                        check_slice(CodecConfig(**BASE, search_range=8, vbs_enable=vbs, fme_enable=fme,
                                                fast_me=fast, parallel_mode=pm, intra_mode=mode, n_ref_frames=8))


@pytest.mark.parametrize("mode", [1, 3])
def test_decoder_holds_one_reference_under_parallel_modes_1_and_3(mode):
    """Modes 1 and 3 predict every inter frame from the all-128 plane alone:
    a stream that names a second reference is corrupt even where the FIFO
    would hold more."""
    from streamoptima_tpu_torch import engine as TE

    kw = dict(BASE, frames=4, search_range=4, n_ref_frames=2, parallel_mode=mode)
    pkg = TorchCodec(CodecConfig(**kw), _clip(64, 96, 4), device="cpu").encode(package=False)
    fts = pkg["frame_type_seq"]
    pairs = [TE.frame_arrays_of(o, ft) for o, ft in zip(pkg["per_frame"], fts)]
    dec = TorchCodec(CodecConfig(**kw), device="cpu").decode(fts, [r for _, r in pairs], [[]] * 4,
                                                            [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).numpy(), pkg["reconstructed frames"])
    mvs = [m for m, _ in pairs]
    bad = mvs[2].mv.copy()
    bad[3, 2] = 1
    mvs[2] = mvs[2]._replace(mv=bad)
    with pytest.raises(ValueError, match="corrupt stream"):
        TorchCodec(CodecConfig(**kw), device="cpu").decode(fts, [r for _, r in pairs], [[]] * 4, mvs)
