"""PyTorch port, the 720p VBS + half-pel FME path on the CPU: parity with JAX.

Every test feeds the same seeded numpy inputs to the JAX package (its numpy
oracles, its jnp functions, or its Pallas kernels in interpret mode, as its
own tests run them) and to the port's counterpart on the CPU, where each
kernel wrapper takes its plain PyTorch version.  The codec's arithmetic is
integer: tolerance 0 for every integer output; PSNR and MAE (float32,
reductions in another order) 1e-4.  Interpret-mode Pallas runs are kept to
the smallest shape; the numpy oracles cover the rest.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu import jax_engine as JE
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu.core import blocks as JB
from streamoptima_tpu.core import intra as JI
from streamoptima_tpu.core import me as JME
from streamoptima_tpu.core import me_pallas as MP
from streamoptima_tpu.core import pred as JP
from streamoptima_tpu.core import quant as JQ
from streamoptima_tpu.core import rd as JRD
from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch import engine as TE
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import blocks as TB
from streamoptima_tpu_torch.core import intra as TI
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as TME
from streamoptima_tpu_torch.core import quant as TQ
from streamoptima_tpu_torch.core import rd as TRD
from streamoptima_tpu_torch.engine import TorchCodec

torch.set_num_threads(1)
INT32_MAX = 2**31 - 1
SEARCH_KEYS = ("mv", "sad", "ok", "sub_mv", "sub_sad", "sub_ok")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coords(h, w, bs=16):
    ys, xs = np.meshgrid(np.arange(h // bs) * bs, np.arange(w // bs) * bs, indexing="ij")
    bx, by = xs.reshape(-1), ys.reshape(-1)
    offs = np.array([[0, 0], [0, 1], [1, 0], [1, 1]]) * (bs // 2)
    return bx, by, bx[:, None] + offs[None, :, 1], by[:, None] + offs[None, :, 0]


def _planes(refs, wrap):
    return TME.fme_parity_planes(_t(refs), wrap)


def _np_search(cur, refs, sr, wrap, bs=16):
    """The JAX package's numpy oracle on its own half-pel upsample."""
    up = np.stack([JME.fme_upsample(r, np, wrap_row_pass=wrap) for r in refs])
    return JME.full_search_materialized(cur.astype(np.int32), up, 2 * sr, bs, bs // 2, 2, True, True, np)


def _assert_search(got, ref):
    for k in SEARCH_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


# ------------------------------------------------------------ FME pieces
@pytest.mark.parametrize("wrap", [True, False])
def test_parity_planes_and_upsample_match_jax_package(wrap):
    rng = np.random.default_rng(1)
    refs = rng.integers(0, 256, (2, 32, 48)).astype(np.uint8)
    refs[0, :8] = 255  # row sums of 510: the K17 wrap changes them
    got = _planes(refs, wrap)
    assert got.dtype == torch.uint8 and got.shape == (2, 4, 32, 48)
    for r in range(2):
        np.testing.assert_array_equal(got[r].numpy(), JME.fme_parity_planes(refs[r], np, wrap_row_pass=wrap))
        np.testing.assert_array_equal(TME.fme_upsample(_t(refs[r]), wrap).numpy(),
                                      JME.fme_upsample(refs[r], np, wrap_row_pass=wrap))
        np.testing.assert_array_equal(TME.grid_of_planes(got[r]).numpy(),
                                      JME.fme_upsample(refs[r], np, wrap_row_pass=wrap))


def test_quads_layouts_match_jax_package():
    rng = np.random.default_rng(2)
    blocks = rng.integers(-255, 256, (12, 16, 16)).astype(np.int32)
    np.testing.assert_array_equal(TB.split_quads(_t(blocks)).numpy(), JB.split_quads(blocks, 16))
    np.testing.assert_array_equal(TB.merge_quads(TB.split_quads(_t(blocks))).numpy(), blocks)
    frame = rng.integers(0, 256, (48, 64)).astype(np.int32)
    # the JAX engine's _quads_px layout
    ref = frame.reshape(3, 2, 8, 4, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(12, 4, 8, 8)
    np.testing.assert_array_equal(TB.quads_px(_t(frame), 16).numpy(), ref)
    np.testing.assert_array_equal(TB.unquads_px(_t(ref), 48, 64).numpy(), frame)


@pytest.mark.parametrize("qp", [0, 1, 4, 9])
def test_quads_quantize_at_qp_minus_1(qp):
    assert TQ.qp_minus_1(qp) == JQ.qpm1(qp)
    qps = np.arange(13, dtype=np.int32)
    np.testing.assert_array_equal(TQ.qp_minus_1(_t(qps)).numpy(), np.asarray(JRD.qp_minus_1(jnp.asarray(qps))))
    rng = np.random.default_rng(qp)
    tq = rng.integers(-2048, 2049, (10, 4, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(TQ.quantize(_t(tq), TQ.qp_minus_1(qp)).numpy(), JQ.quantize(tq, JQ.qpm1(qp)))


# ------------------------------------------------------------ the search
def test_fme_vbs_search_plain_matches_pallas_kernel():
    """The plain FME + VBS search against full_search_pallas_fme in interpret
    mode, on random content (smallest shape: interpret mode is slow)."""
    h, w, sr = 48, 64, 4
    rng = np.random.default_rng(3)
    cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
    refs = rng.integers(0, 256, (1, h, w)).astype(np.uint8)
    ref = MP.full_search_pallas_fme(jnp.asarray(cur, jnp.int32), jnp.asarray(refs), sr, 16, 8, True,
                                    interpret=True, want_pred=False, wrap_row_pass=True)
    got = K.full_search_fme_vbs(_t(cur), _planes(refs, True), sr, 16)
    _assert_search(got, ref)
    assert not got["ok"].all() and got["ok"].any()  # edge blocks have no valid candidate


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("h,w,sr,nref", [(48, 64, 4, 1), (64, 96, 8, 1), (64, 80, 4, 2)])
def test_fme_vbs_search_plain_matches_numpy_oracle(h, w, sr, nref, wrap):
    rng = np.random.default_rng(h + w + sr + nref + wrap)
    cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    refs[:, :, :6] = 250  # wrapped row sums on the left edge
    got = K.full_search_fme_vbs(_t(cur), _planes(refs, wrap), sr, 16)
    _assert_search(got, _np_search(cur, refs, sr, wrap))


@pytest.mark.parametrize("case", ["flat", "black_vs_white", "two_refs_tie", "initial_128"])
def test_fme_vbs_search_ties_and_no_candidate(case):
    """Equal SADs everywhere: each winner is the smallest packed key; blocks
    and quads at the bottom and right edges have no valid candidate."""
    h, w, sr = 48, 64, 4
    wrap = case != "initial_128"
    if case == "flat":
        cur, refs = np.full((h, w), 90, np.uint8), np.full((1, h, w), 90, np.uint8)
    elif case == "black_vs_white":
        cur, refs = np.zeros((h, w), np.uint8), np.full((1, h, w), 255, np.uint8)
    elif case == "two_refs_tie":
        cur = np.full((h, w), 10, np.uint8)
        refs = np.stack([np.full((h, w), 12, np.uint8), np.full((h, w), 8, np.uint8)])
    else:  # the all-128 initial reference: no K17 wrap
        cur, refs = synthetic_clip(h, w, 1, seed=5)[0], np.full((1, h, w), 128, np.uint8)
    got = K.full_search_fme_vbs(_t(cur), _planes(refs, wrap), sr, 16)
    _assert_search(got, _np_search(cur, refs, sr, wrap))
    ok = got["ok"].numpy().reshape(3, 4)
    assert not ok[-1].any() and not ok[:, -1].any() and ok[:-1, :-1].all()
    assert (got["sad"].numpy().reshape(3, 4)[-1] == INT32_MAX).all()
    assert (got["mv"].numpy()[~got["ok"].numpy()] == 0).all()
    if case == "flat":
        assert (got["mv"].numpy().reshape(3, 4, 3)[:-1, :-1] == 0).all()


def test_fme_vbs_search_plain_matches_pallas_on_the_initial_reference():
    """wrap_row_pass=False (the all-128 initial reference) through the Pallas
    kernel in interpret mode: ties everywhere the texture is flat."""
    h, w, sr = 48, 64, 4
    cur = synthetic_clip(h, w, 1, seed=6)[0]
    refs = np.full((1, h, w), 128, np.uint8)
    ref = MP.full_search_pallas_fme(jnp.asarray(cur, jnp.int32), jnp.asarray(refs), sr, 16, 8, True,
                                    interpret=True, want_pred=False, wrap_row_pass=False)
    _assert_search(K.full_search_fme_vbs(_t(cur), _planes(refs, False), sr, 16), ref)


# ------------------------------------------------------------- the fetch
def _np_fetch(mv, smv, refs, wrap, h, w, bs=16):
    up = np.stack([JME.fme_upsample(r, np, wrap_row_pass=wrap) for r in refs])
    bx, by, qx, qy = _coords(h, w, bs)
    s = bs // 2
    f = JP.gather_predictions(mv, up, bx, by, bs, True, np)
    q = JP.gather_predictions(smv.reshape(-1, 3), up, qx.reshape(-1), qy.reshape(-1), s, True, np)
    full = f.reshape(h // bs, w // bs, bs, bs).swapaxes(1, 2).reshape(h, w)
    quads = JB.merge_quads(q.reshape(-1, 4, s, s), bs).reshape(h // bs, w // bs, bs, bs).swapaxes(1, 2).reshape(h, w)
    return full, quads


def test_fme_quad_fetch_plain_matches_pallas_kernel():
    """Case-A/B MVs (the encoder's and every well-formed stream's): the plain
    fetch against pred_fetch_compact in interpret mode with its host table,
    and the JAX decoder's case-B mask per block and per quad."""
    h, w, sr = 48, 64, 4
    rng = np.random.default_rng(7)
    nb = (h // 16) * (w // 16)
    refs = rng.integers(0, 256, (1, h, w)).astype(np.uint8)
    mv = np.stack([rng.integers(-2 * sr, 2 * sr + 1, nb), rng.integers(-2 * sr, 2 * sr + 1, nb),
                   np.zeros(nb, int)], 1).astype(np.int32)
    smv = np.stack([rng.integers(-2 * sr, 2 * sr + 1, (nb, 4)), rng.integers(-2 * sr, 2 * sr + 1, (nb, 4)),
                    np.zeros((nb, 4), int)], 2).astype(np.int32)
    bx, by, qx, qy = _coords(h, w)
    # primary bounds hold everywhere (cases A and B): what the kernel serves
    mv[:, 0] = np.clip(mv[:, 0], -2 * bx, 2 * w - 1 - 16 - 1 - 2 * bx)
    mv[:, 1] = np.clip(mv[:, 1], -2 * by, 2 * h - 1 - 16 - 1 - 2 * by)
    smv[:, :, 0] = np.clip(smv[:, :, 0], -2 * qx, 2 * w - 1 - 8 - 1 - 2 * qx)
    smv[:, :, 1] = np.clip(smv[:, :, 1], -2 * qy, 2 * h - 1 - 8 - 1 - 2 * qy)
    mv[5] = (3, -1, 0)  # odd displacements read the p11 plane
    assert MP.fetch_decodable(mv, smv, sr, True, True, h, w, 16, 8)
    tab, pad = MP.build_fetch_table(mv, smv, sr, True, True, h // 16, w // 16, 16)
    pf, pq = MP.pred_fetch_compact(jnp.asarray(mv), jnp.asarray(smv), jnp.asarray(refs), jnp.asarray(tab), pad,
                                   16, 8, True, True, interpret=True, wrap_row_pass=True)
    v2 = MP.fme_caseB_valid2(mv, bx, by, 16, h, w)
    v2q = MP.fme_caseB_valid2(smv, qx, qy, 8, h, w)
    assert not v2.all() and not v2q.all()  # case B occurs
    full = np.where(np.repeat(np.repeat(v2.reshape(3, 4), 16, 0), 16, 1), np.asarray(pf), 128)
    vq = v2q.reshape(3, 4, 2, 2).transpose(0, 2, 1, 3).reshape(6, 8)
    quads = np.where(np.repeat(np.repeat(vq, 8, 0), 8, 1), np.asarray(pq), 128)
    got_f, got_q = K.pred_fetch_fme_vbs(_t(mv), _t(smv), _planes(refs, True), 16)
    assert got_f.dtype == got_q.dtype == torch.int16
    np.testing.assert_array_equal(got_f.numpy(), full)
    np.testing.assert_array_equal(got_q.numpy(), quads)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("bound", [8, 40, 300])
def test_fme_quad_fetch_plain_cases_a_b_c(bound, wrap):
    """MVs that hit cases A, B and C, including MVs far beyond 2sr and
    windows wholly off the grid, against the numpy gather on the upsample."""
    h, w = 48, 64
    rng = np.random.default_rng(bound + wrap)
    nb = (h // 16) * (w // 16)
    refs = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    mv = np.stack([rng.integers(-bound, bound + 1, nb), rng.integers(-bound, bound + 1, nb),
                   rng.integers(0, 2, nb)], 1).astype(np.int32)
    smv = np.stack([rng.integers(-bound, bound + 1, (nb, 4)), rng.integers(-bound, bound + 1, (nb, 4)),
                    rng.integers(0, 2, (nb, 4))], 2).astype(np.int32)
    mv[0] = (-3, -5, 1)  # case C at the top-left corner
    mv[5] = (1, 1, 0)  # case A
    mv[11] = (0, 0, 0)  # bottom-right block: case B
    smv[4, 0] = (5000, -5000, 0)  # off the grid: zeros
    got_f, got_q = K.pred_fetch_fme_vbs(_t(mv), _t(smv), _planes(refs, wrap), 16)
    exp_f, exp_q = _np_fetch(mv, smv, refs, wrap, h, w)
    np.testing.assert_array_equal(got_f.numpy(), exp_f)
    np.testing.assert_array_equal(got_q.numpy(), exp_q)
    assert (got_f.numpy()[32:, 48:] == 128).all()


def test_fme_wrappers_refuse_what_the_kernels_do_not_take():
    cur = torch.zeros((48, 64), dtype=torch.uint8)
    planes = torch.zeros((1, 4, 48, 64), dtype=torch.uint8)
    mv, smv = torch.zeros((12, 3), dtype=torch.int32), torch.zeros((12, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="planes"):
        K.full_search_fme_vbs(cur, torch.zeros((1, 48, 64), dtype=torch.uint8).reshape(1, 1, 48, 64), 4, 16)
    with pytest.raises(ValueError, match="sr"):
        K.full_search_fme_vbs(cur, planes, 64, 16)
    with pytest.raises(TypeError):
        K.full_search_fme_vbs(cur, planes.to(torch.int32), 4, 16)
    with pytest.raises(ValueError, match="sub_mv"):
        K.pred_fetch_fme_vbs(mv, torch.zeros((12, 3), dtype=torch.int32), planes, 16)
    with pytest.raises(ValueError, match="blocks"):
        K.pred_fetch_fme_vbs(torch.zeros((11, 3), dtype=torch.int32), smv, planes, 16)
    before = (K.full_search_fme_vbs.launches, K.pred_fetch_fme_vbs.launches)
    K.full_search_fme_vbs(cur, planes, 4, 16)
    K.pred_fetch_fme_vbs(mv, smv, planes, 16)
    assert (K.full_search_fme_vbs.launches, K.pred_fetch_fme_vbs.launches) == before  # CPU: plain, no launch


# ---------------------------------------------------------- RD and intra
@pytest.mark.parametrize("frame_type", [0, 1])
@pytest.mark.parametrize("with_invalid", [False, True])
def test_transform_and_select_vbs_split(frame_type, with_invalid):
    rng = np.random.default_rng(10 * frame_type + with_invalid)
    nb = 24
    res = rng.integers(-60, 61, (nb, 16, 16)).astype(np.int32)
    res[::3] //= 8  # sparse blocks: zero runs in the coded lengths
    quads = JB.split_quads(res, 16) + rng.integers(-3, 4, (nb, 4, 8, 8)).astype(np.int32)
    quads[1::3] //= 16  # quads that predict far better: these split
    sad = np.abs(res).sum(axis=(1, 2)).astype(np.int32)
    sub_sad = np.abs(quads).sum(axis=(2, 3)).astype(np.int32)
    qps = rng.integers(0, 8, nb).astype(np.int32)
    elig = rng.random(nb) > 0.25
    ok = rng.random(nb) > 0.2 if with_invalid else None
    sub_ok = rng.random((nb, 4)) > 0.1 if with_invalid else None
    ref = JRD.transform_and_select(
        jnp.asarray(res), jnp.asarray(quads), jnp.asarray(sad), jnp.asarray(sub_sad), frame_type, jnp.asarray(qps),
        qp_nominal=4, lam=0.015, vbs_enable=True, vbs_eligible=jnp.asarray(elig), bs=16, sbs=8,
        ok_full=None if ok is None else jnp.asarray(ok), ok_quads=None if sub_ok is None else jnp.asarray(sub_ok),
    )
    got = TRD.transform_and_select(_t(res), _t(quads), _t(sad), _t(sub_sad), frame_type, _t(qps), qp_nominal=4,
                                   lam=0.015, vbs_enable=True, vbs_eligible=_t(elig), bs=16, sbs=8,
                                   ok_full=None if ok is None else _t(ok),
                                   ok_quads=None if sub_ok is None else _t(sub_ok))
    for name, a, b in zip(("split", "qtc_full", "qtc_quads", "lens", "mae"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert 0 < int(got[0].sum()) < int(elig.sum())  # both decisions occur


@pytest.mark.parametrize("h,w,sr", [(48, 64, 4), (64, 96, 8), (48, 96, 16)])
def test_intra_vbs_search_and_residuals(h, w, sr):
    cur = synthetic_clip(h, w, 1, seed=sr)[0].astype(np.int32)
    cur[:16, 20:40] = np.random.default_rng(sr).integers(0, 256, (16, 20))
    ref = JI.intra_search_mode0(jnp.asarray(cur), 16, sr, w, True, jnp)
    got = TI.intra_search_mode0(_t(cur), 16, sr, w, vbs=True)
    for k in ("mv", "sad", "sub_mv", "sub_sad"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    ref_np = JI.intra_search_mode0(cur, 16, sr, w, True, np)
    np.testing.assert_array_equal(got["sub_sad"].numpy(), ref_np["sub_sad"])
    rf_ref, rq_ref = JI.intra_residuals_mode0(jnp.asarray(cur), ref["mv"], ref["sub_mv"], 16, jnp, sr=sr)
    rf, rq = TI.intra_residuals_mode0(_t(cur), got["mv"], 16, sr, got["sub_mv"])
    np.testing.assert_array_equal(rf.numpy(), np.asarray(rf_ref))
    np.testing.assert_array_equal(rq.numpy(), np.asarray(rq_ref))
    _, rq_np = JI.intra_residuals_mode0(cur, ref_np["mv"], ref_np["sub_mv"], 16, np)
    np.testing.assert_array_equal(rq.numpy(), rq_np)


@pytest.mark.parametrize("sr", [4, 8, 12, 16, 20])
def test_intra_reconstruct_variants_with_split_quads(sr):
    """sr < bs takes the wavefront variant, sr >= bs the column scan; with
    split quads both equal the JAX variants and the sequential oracle."""
    h, w, bs = 48, 96, 16
    rng = np.random.default_rng(100 + sr)
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    mv = np.maximum(rng.integers(-sr, 1, (nbr, nbc)), -np.arange(nbc) * bs).astype(np.int32)
    mv[:, 0] = -1
    smv = np.maximum(rng.integers(-sr, 1, (nbr, nbc, 4)), -(np.arange(nbc) * bs)[None, :, None]).astype(np.int32)
    split = rng.random(nb) > 0.4
    split[: nbc] = False  # the border is never split by the encoder
    rf = rng.integers(-40, 41, (nb, bs, bs)).astype(np.int32)
    rq = rng.integers(-40, 41, (nb, 4, bs // 2, bs // 2)).astype(np.int32)
    got = TI.intra_reconstruct_mode0(_t(rf), _t(mv.reshape(-1)), h, w, bs, sr, residual_quads=_t(rq),
                                     split=_t(split), sub_mv=_t(smv.reshape(nb, 4)))
    ref_j = JI.intra_reconstruct_mode0(jnp.asarray(rf), jnp.asarray(rq), jnp.asarray(split),
                                       jnp.asarray(mv.reshape(-1)), jnp.asarray(smv.reshape(nb, 4)), h, w, bs, jnp,
                                       sr=sr)
    ref_np = JI.intra_reconstruct_mode0(rf, rq, split, mv.reshape(-1), smv.reshape(nb, 4), h, w, bs, np)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_j))
    np.testing.assert_array_equal(got.numpy(), ref_np)


# ------------------------------------------------------------ the slice
H, W, FRAMES, SR = 64, 96, 6, 8
KW = dict(height=H, width=W, frames=FRAMES, search_range=SR, qp=4, intra_dur=4, lam=0.015, vbs_enable=True,
          fme_enable=True)


def _halfpel_clip():
    """A smooth texture moving half a pixel per frame (every other pixel of
    a finer texture moving one), so the half-pel candidates win."""
    fine = synthetic_clip(2 * H + 16, 2 * W + 16, 1, seed=11)[0]
    return np.stack([fine[i : i + 2 * H : 2, i : i + 2 * W : 2] for i in range(FRAMES)])


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """Both engines' VBS + FME encodes and text bitstreams of one clip."""
    clip = _halfpel_clip()
    d = tmp_path_factory.mktemp("vbs_fme")
    jv = JaxVideoCodec(JaxCodecConfig(**KW), clip)
    jpkg = jv.encode(compute_ssim=False, package=False)
    jv.transmit_bitstream(d / "jmv.txt", d / "jres.txt")
    tv = VideoCodec(CodecConfig(**KW), clip, device="cpu")
    tpkg = tv.encode(package=False)
    tv.transmit_bitstream(d / "tmv.txt", d / "tres.txt")
    return {"clip": clip, "dir": d, "jpkg": jpkg, "tpkg": tpkg}


@pytest.mark.parametrize("key", ["mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "row_bits", "recon"])
def test_vbs_fme_per_frame_outputs_bit_identical(encoded, key):
    for i, (a, b) in enumerate(zip(encoded["tpkg"]["per_frame"], encoded["jpkg"]["per_frame"])):
        np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=f"frame {i} {key}")


def test_vbs_fme_package_metrics_and_real_vbs_state(encoded):
    t, j = encoded["tpkg"], encoded["jpkg"]
    assert t["frame_type_seq"] == j["frame_type_seq"] == [0, 1, 1, 1, 0, 1]
    assert t["residual size per frame"] == j["residual size per frame"]
    np.testing.assert_allclose(t["PSNR per frame"], j["PSNR per frame"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["MAE per Frame"], j["MAE per Frame"], rtol=0, atol=1e-4)
    pf = t["per_frame"]
    # the state that crosses engines is real VBS + FME state: split blocks
    # with quad coefficients, and displacements on the half-pel grid
    assert sum(int(o["split"].sum()) for o in pf[1:4]) > 0
    assert any(int(o["qtc_quads"].abs().sum()) > 0 for o in pf)
    assert all(bool((o["mv"][:, :2] % 2 != 0).any()) for o in pf[1:4])


def test_vbs_fme_text_bitstream_bytes_identical(encoded):
    d = encoded["dir"]
    assert (d / "tmv.txt").read_bytes() == (d / "jmv.txt").read_bytes()
    assert (d / "tres.txt").read_bytes() == (d / "jres.txt").read_bytes()


def test_vbs_fme_cross_decode_from_files(encoded):
    d = encoded["dir"]
    dec = VideoCodec(CodecConfig(**KW), device="cpu").decode_bitstream(d / "jmv.txt", d / "jres.txt")
    np.testing.assert_array_equal(dec, encoded["jpkg"]["reconstructed frames"])
    jdec = JaxVideoCodec(JaxCodecConfig(**KW)).decode_bitstream(d / "tmv.txt", d / "tres.txt")
    np.testing.assert_array_equal(jdec, encoded["tpkg"]["reconstructed frames"])


def test_vbs_fme_cross_decode_in_memory_per_frame_state(encoded):
    fts = encoded["jpkg"]["frame_type_seq"]
    jstate = TE.from_jax_per_frame([{k: np.asarray(v) for k, v in o.items()} for o in encoded["jpkg"]["per_frame"]],
                                   "cpu")
    pairs = [TE.frame_arrays_of(o, ft) for o, ft in zip(jstate, fts)]
    dec = TorchCodec(CodecConfig(**KW), device="cpu").decode(fts, [r for _, r in pairs], [[]] * FRAMES,
                                                             [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).numpy(), encoded["jpkg"]["reconstructed frames"])
    tstate = TE.to_numpy_per_frame(encoded["tpkg"]["per_frame"])
    jpairs = [JE.frame_arrays_of(o, ft) for o, ft in zip(tstate, fts)]
    jdec = JE.JaxCodec(JaxCodecConfig(**KW)).decode(fts, [r for _, r in jpairs], [[]] * FRAMES,
                                                    [m for m, _ in jpairs])
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in jdec]), encoded["tpkg"]["reconstructed frames"])


def test_vbs_fme_list_package_roundtrip(encoded, tmp_path):
    """package=True (list interchange) decodes in memory and writes the same
    bytes as the array form."""
    v = VideoCodec(CodecConfig(**KW), encoded["clip"], device="cpu")
    pkg = v.encode(compute_ssim=False)
    np.testing.assert_array_equal(v.decode(), pkg["reconstructed frames"])
    v.transmit_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    assert (tmp_path / "mv.txt").read_bytes() == (encoded["dir"] / "jmv.txt").read_bytes()
    assert (tmp_path / "res.txt").read_bytes() == (encoded["dir"] / "jres.txt").read_bytes()


def test_vbs_fme_corrupt_quad_reference_rejected(encoded):
    fts = encoded["tpkg"]["frame_type_seq"]
    pairs = [TE.frame_arrays_of(o, ft) for o, ft in zip(encoded["tpkg"]["per_frame"], fts)]
    mvs = [m for m, _ in pairs]
    smv = mvs[1].smv.copy()
    smv[5, 2, 2] = 1  # a quad names a second reference the decoder does not hold
    mvs[1] = mvs[1]._replace(smv=smv)
    with pytest.raises(ValueError, match="corrupt stream"):
        TorchCodec(CodecConfig(**KW), device="cpu").decode(fts, [r for _, r in pairs], [[]] * FRAMES, mvs)
