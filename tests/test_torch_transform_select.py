"""PyTorch port, the ``transform_select`` and ``residual_recon`` wrappers on
the CPU: parity with the JAX package, and the two kernels' rules.

On the CPU ``kernels.transform_select`` runs its plain version
(``rd.transform_and_select``) and ``kernels.residual_recon`` its plain
version (rescale, ``idct2_int`` and, for an inter frame, the prediction
added and wrapped to uint8).  Every case feeds the same seeded numpy inputs
to the wrapper and to the JAX package's ``rd.transform_and_select`` (jnp),
or ``rescale`` then ``idct2_int`` in jnp, as ``JaxCodec._dequant`` does: bs
8 and 16, VBS on and off, nominal QPs 0, 4 and 11 (the rate tables' largest
row QP) with block QPs up to 12 (ROI's clip), both frame types, ok flags
given or not; ±255 checkerboards, all-zero blocks, blocks without a valid
candidate, and exact RD ties at the default lam = 0.015.

``_select_rule`` and ``_recon_rule`` transcribe ``csrc/transform_select.cu``
and ``csrc/residual_recon.cu`` in numpy int64: each transform pass as one
dot product and one round-half-even (the plain version's operand splits are
identities of integer arithmetic), the coded length as the kernel counts it
(nonzeros plus run starts over the diagonal scan), the RD cost as a float32
multiply and a float32 add rounded apart, and the recon's per-thread pixel
mapping.  Each is held to the plain version on the same inputs, so the rules
the kernels implement are checked here before a card runs them.  Last,
``TorchCodec`` encodes and decodes each tool set as ``JaxCodec`` does, and
every frame step routes through the wrappers.  The arithmetic is integer or
exactly rounded float32: every tolerance is exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu.core import quant as JQ
from streamoptima_tpu.core import rd as JRD
from streamoptima_tpu.core import transform as JT
from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core.blocks import blockify, merge_quads, split_quads, unblockify
from streamoptima_tpu_torch.core.quant import q_exponent_matrix, quantize
from streamoptima_tpu_torch.core.transform import dct2_int, dct_matrix_fixed, idct2_int
from streamoptima_tpu_torch.core.zigzag import diag_scan_indices, rle_length
from streamoptima_tpu_torch.engine import TorchCodec, frame_arrays_of

torch.set_num_threads(1)
LAM = 0.015
NB = 40
QP_TOP = 11  # the largest row QP the rate tables give (QPs 0-11); ROI offsets clip block QPs to 12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _checkers(bs: int) -> list:
    """±255 checkerboards of every period, their negatives, and ±255 flats."""
    i, j = np.indices((bs, bs))
    out = []
    for p in (1, 2, 4):
        c = np.where(((i // p) + (j // p)) % 2 == 0, 255, -255)
        out += [c, -c]
    return out + [np.full((bs, bs), 255), np.full((bs, bs), -255)]


def _tie_blocks(bs: int, frame_type: int, rng) -> tuple:
    """Blocks whose RD costs tie exactly in float32 at lam = 0.015, and a
    twin a hair off the tie: residuals whose quads code 19 (inter) or 22
    (intra) symbols more than the block at the nominal QP 4, so the bits
    differ by 200 and lam * 200 is 3.0000001 in float32, and SADs whose MAEs
    differ by 3.  Returns (res, sad_full, sad_quads) of two blocks: the tie
    (which splits) and one with the block's SAD 1 lower (which does not)."""
    s = bs // 2
    want = 19 if frame_type else 22
    base, base_v = (16, 64) if frame_type else (8, 32)
    lam = np.float32(LAM)
    for dens in (0.05, 0.1, 0.2, 0.02):
        res = (rng.integers(-255, 256, (4000, bs, bs)) * (rng.random((4000, bs, bs)) < dens)).astype(np.int32)
        r = _t(res)
        lf = rle_length(quantize(dct2_int(r), 4)).numpy()
        lq = rle_length(quantize(dct2_int(split_quads(r)), 3)).sum(1).numpy()
        for b in np.flatnonzero(lq - lf == want):
            rd_a = np.float32(lam * np.float32(base + 8 * lf[b]))
            rd_b = np.float32(lam * np.float32(base_v + 8 * lq[b]))
            for q_sum in range(40 * s * s, 200 * s * s * 4, 4):  # the quads' SADs sum to q_sum, a multiple of 4
                f_sad = (q_sum * bs * bs // (4 * s * s)) + 3 * bs * bs
                if f_sad > 255 * bs * bs:
                    break
                mae_full = np.float32(f_sad) / np.float32(bs * bs)
                vbs_mae = np.float32(np.float32(q_sum // 4) / np.float32(s * s))  # four equal quads
                if np.float32(rd_a + mae_full) == np.float32(rd_b + vbs_mae):
                    low = np.float32(f_sad - 1) / np.float32(bs * bs)
                    assert np.float32(rd_a + low) < np.float32(rd_b + vbs_mae)
                    sq = np.full(4, q_sum // 4, np.int32)
                    return res[[b, b]], np.array([f_sad, f_sad - 1], np.int32), np.stack([sq, sq])
    raise AssertionError("no exact RD tie found")


@functools.lru_cache(maxsize=None)
def _select_inputs(bs: int, kind: str, frame_type: int, seed: int = 0) -> dict:
    """NB blocks of residuals (and independent quad residuals), SADs, ok
    flags, block QPs in [0, 12] and eligibility.  ``kind``: "random" (dense
    and sparse residuals in ±255) or "extremes" (checkerboards, zero blocks,
    ok False blocks with INT32_MAX SADs, the exact RD ties)."""
    rng = np.random.default_rng([bs, len(kind), frame_type, seed])
    s = bs // 2
    res = rng.integers(-255, 256, (NB, bs, bs)) * (rng.random((NB, 1, 1)) < rng.random((NB, bs, bs)))
    quads = np.asarray(split_quads(_t(res))).copy()
    noisy = rng.random(NB) < 0.5
    quads[noisy] = rng.integers(-255, 256, quads[noisy].shape)
    sad_full = rng.integers(0, 255 * bs * bs + 1, NB)
    sad_quads = rng.integers(0, 255 * s * s + 1, (NB, 4))
    ok_full = rng.random(NB) < 0.85
    ok_quads = rng.random((NB, 4)) < 0.85
    if kind == "extremes":
        ch = _checkers(bs)
        res[: len(ch)] = ch
        quads[: len(ch)] = np.asarray(split_quads(_t(np.asarray(ch))))
        res[len(ch): len(ch) + 4] = 0
        quads[len(ch): len(ch) + 4] = 0
        quads[len(ch) + 4] = np.asarray(split_quads(_t(-res[len(ch) + 4][None])))[0]
        bad = slice(len(ch) + 5, len(ch) + 8)  # no valid candidate: the searches' INT32_MAX SAD and ok False
        sad_full[bad], sad_quads[bad], ok_full[bad], ok_quads[bad] = 2**31 - 1, 2**31 - 1, False, False
        tie_res, tie_f, tie_q = _tie_blocks(bs, frame_type, rng)
        res[-2:], quads[-2:] = tie_res, np.asarray(split_quads(_t(tie_res)))
        sad_full[-2:], sad_quads[-2:], ok_full[-2:], ok_quads[-2:] = tie_f, tie_q, True, True
    elig = rng.random(NB) < 0.8
    elig[-2:] = True
    qps = rng.integers(0, 13, NB)
    return {"res": res.astype(np.int32), "quads": quads.astype(np.int32), "sad": sad_full.astype(np.int32),
            "sub_sad": sad_quads.astype(np.int32), "ok": ok_full, "sub_ok": ok_quads, "elig": elig,
            "qps": qps.astype(np.int32)}


def _port_select(a: dict, bs: int, vbs: bool, qp: int, ft: int, with_ok: bool):
    ok = (_t(a["ok"]), _t(a["sub_ok"])) if with_ok else (None, None)
    out = K.transform_select(_t(a["res"]), _t(a["quads"]) if vbs else None, _t(a["sad"]),
                             _t(a["sub_sad"]) if vbs else None, ft, _t(a["qps"]), qp_nominal=qp, lam=LAM,
                             vbs_enable=vbs, vbs_eligible=_t(a["elig"]), bs=bs, sbs=bs // 2, ok_full=ok[0],
                             ok_quads=ok[1] if vbs else None)
    return [o.numpy() for o in out]


def _jax_select(a: dict, bs: int, vbs: bool, qp: int, ft: int, with_ok: bool):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    out = JRD.transform_and_select(j["res"], j["quads"] if vbs else None, j["sad"], j["sub_sad"] if vbs else None,
                                   ft, j["qps"], qp_nominal=qp, lam=LAM, vbs_enable=vbs, vbs_eligible=j["elig"],
                                   bs=bs, sbs=bs // 2, ok_full=j["ok"] if with_ok else None,
                                   ok_quads=j["sub_ok"] if with_ok and vbs else None)
    return [np.asarray(o) for o in out]


SELECT_GRID = [(bs, vbs, qp) for bs in (8, 16) for vbs in (False, True) for qp in (0, 4, QP_TOP)]


@pytest.mark.parametrize("kind", ["random", "extremes"])
@pytest.mark.parametrize("bs,vbs,qp", SELECT_GRID)
def test_transform_select_on_cpu_matches_jax_package(bs, vbs, qp, kind):
    for ft in (0, 1):
        a = _select_inputs(bs, kind, ft)
        for with_ok in (False, True):
            got, ref = _port_select(a, bs, vbs, qp, ft, with_ok), _jax_select(a, bs, vbs, qp, ft, with_ok)
            for name, g, r in zip(("split", "qtc_full", "qtc_quads", "lens", "mae"), got, ref):
                assert g.dtype == r.dtype, name
                np.testing.assert_array_equal(g, r, err_msg=f"{name} frame type {ft} ok {with_ok}")


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("ft", [0, 1])
def test_exact_rd_tie_splits_and_its_twin_does_not(bs, ft):
    """At lam = 0.015 the last two "extremes" blocks tie exactly and miss by
    one SAD unit: the tie splits (!(rd_bs < rd_vbs)), the twin does not, in
    both packages."""
    a = _select_inputs(bs, "extremes", ft)
    for split in (_port_select(a, bs, True, 4, ft, True)[0], _jax_select(a, bs, True, 4, ft, True)[0]):
        assert split[-2:].tolist() == [True, False]


# ------------------------------------------------------------ the kernels' rules, in numpy int64
def _rhe(num, k):
    """round-half-even(num / 2^k), k an int or array >= 0, as rhe_shr in csrc/transform_common.cuh."""
    num = np.asarray(num, np.int64)
    k = np.broadcast_to(np.asarray(k, np.int64), num.shape)
    kc = np.maximum(k, 1)
    q = num >> kc
    r = num & ((np.int64(1) << kc) - 1)
    half = np.int64(1) << (kc - 1)
    return np.where(k == 0, num, q + ((r > half) | ((r == half) & (q & 1 == 1))))


def _dct_rule(x):
    a = dct_matrix_fixed(x.shape[-1]).astype(np.int64)
    m1 = _rhe(np.einsum("rp,...pc->...rc", a, x.astype(np.int64)), 6)
    return _rhe(np.einsum("...rp,cp->...rc", m1, a), 28)


def _idct_rule(t):
    a = dct_matrix_fixed(t.shape[-1]).astype(np.int64)
    m1 = _rhe(np.einsum("pr,...pc->...rc", a, t.astype(np.int64)), 11)
    return _rhe(np.einsum("...rp,pc->...rc", m1, a), 23)


def _rle_rule(q):
    """Per block: scan position u adds (v_u != 0) + (u == 0 or (v_u == 0) != (v_{u-1} == 0))."""
    n = q.shape[-1]
    z = q.reshape(q.shape[:-2] + (n * n,))[..., diag_scan_indices(n)] == 0
    start = np.ones_like(z)
    start[..., 1:] = z[..., 1:] != z[..., :-1]
    return (~z).sum(-1) + start.sum(-1)


def _select_rule(a: dict, bs: int, vbs: bool, qp: int, ft: int, with_ok: bool):
    """csrc/transform_select.cu per block, in numpy."""
    s, nb = bs // 2, a["res"].shape[0]
    band, bandq = q_exponent_matrix(bs), q_exponent_matrix(s)
    qps = a["qps"].astype(np.int64)
    qpm1 = np.where(qps > 0, qps - 1, qps)
    tf = _dct_rule(a["res"])
    qf = _rhe(tf, qps[:, None, None] + band)
    inf = np.float32(np.inf)
    mae_full = np.float32(a["sad"].astype(np.float32) / np.float32(bs * bs))
    if with_ok:
        mae_full = np.where(a["ok"], mae_full, inf)
    if not vbs:
        return [np.zeros(nb, bool), qf.astype(np.int32), np.zeros((nb, 4, s, s), np.int32),
                _rle_rule(qf).astype(np.int32), mae_full]
    tq = _dct_rule(a["quads"])
    qq = _rhe(tq, qpm1[:, None, None, None] + bandq)
    len_nom = _rle_rule(_rhe(tf, qp + band))
    len_q_nom = _rle_rule(_rhe(tq, max(qp - 1, 0) + bandq)).sum(1)
    mq = np.float32(a["sub_sad"].astype(np.float32) / np.float32(s * s))
    if with_ok:
        mq = np.where(a["sub_ok"], mq, inf)
    vbs_mae = np.float32(np.float32(np.float32(mq[:, 0] + mq[:, 1]) + mq[:, 2]) + mq[:, 3]) / np.float32(4)
    base, base_v = (8, 32) if ft == 0 else (16, 64)
    lam = np.float32(LAM)
    rd_bs = np.float32(np.float32(lam * (base + 8 * len_nom).astype(np.float32)) + mae_full)
    rd_vbs = np.float32(np.float32(lam * (base_v + 8 * len_q_nom).astype(np.float32)) + vbs_mae)
    split = ~(rd_bs < rd_vbs) & a["elig"]
    lens = np.where(split, _rle_rule(qq).sum(1), _rle_rule(qf))
    return [split, qf.astype(np.int32), qq.astype(np.int32), lens.astype(np.int32),
            np.where(a["elig"], vbs_mae, mae_full).astype(np.float32)]


@pytest.mark.parametrize("kind", ["random", "extremes"])
@pytest.mark.parametrize("bs,vbs,qp", SELECT_GRID)
def test_select_rule_matches_plain(bs, vbs, qp, kind):
    for ft in (0, 1):
        a = _select_inputs(bs, kind, ft)
        for with_ok in (False, True):
            got, plain = _select_rule(a, bs, vbs, qp, ft, with_ok), _port_select(a, bs, vbs, qp, ft, with_ok)
            for name, g, p in zip(("split", "qtc_full", "qtc_quads", "lens", "mae"), got, plain):
                np.testing.assert_array_equal(g, p, err_msg=f"{name} frame type {ft} ok {with_ok}")


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_one_pass_transforms_equal_the_split_ones(n):
    """The kernels' one-pass rounding == dct2_int / idct2_int on random
    blocks across their whole input ranges and on the extremes."""
    rng = np.random.default_rng(n)
    x = rng.integers(-512, 513, (3000, n, n))
    x[:2] = 512 * np.where(np.indices((n, n)).sum(0) % 2, 1, -1)[None] * np.array([1, -1])[:, None, None]
    x[2], x[3] = 512, -512
    np.testing.assert_array_equal(_dct_rule(x), dct2_int(_t(x.astype(np.int32))).numpy())
    t = rng.integers(-12288, 12289, (3000, n, n))
    t[0], t[1] = 12288, -12288
    t[2] = np.where(np.indices((n, n)).sum(0) % 2, 12288, -12288)
    np.testing.assert_array_equal(_idct_rule(t), idct2_int(_t(t.astype(np.int32))).numpy())


@pytest.mark.parametrize("n", [4, 8, 16])
def test_rle_rule_matches_rle_length(n):
    rng = np.random.default_rng(100 + n)
    q = rng.integers(-2, 3, (2000, n, n)) * (rng.random((2000, 1, 1)) < rng.random((2000, n, n)))
    q[0], q[1] = 0, 1
    q[2] = 0
    q[2].reshape(-1)[diag_scan_indices(n)[-1]] = 5  # one nonzero, last in scan order
    np.testing.assert_array_equal(_rle_rule(q), rle_length(_t(q)).numpy())


# ------------------------------------------------------------ residual_recon
@functools.lru_cache(maxsize=None)
def _recon_inputs(bs: int, dtype: str, seed: int = 0) -> dict:
    """Coefficients as the codec makes them: quantized DCTs of residuals at
    block QPs in [0, 12] (extremes: ±255 checkerboards at QP 0, zeros), with
    the quads at QP - 1; int16 planes as decode ships them or int32 as the
    encode's select returns them; predictions, split and ok flags."""
    rng = np.random.default_rng([bs, len(dtype), seed])
    nbr, nbc, s = 3, 4, bs // 2
    nb = nbr * nbc
    res = rng.integers(-255, 256, (nb, bs, bs))
    ch = _checkers(bs)
    res[: min(len(ch), nb - 2)] = ch[: nb - 2]
    res[-2] = 0
    qps = rng.integers(0, 13, nb)
    qps[: len(ch)] = 0
    r = _t(res.astype(np.int32))
    qf = quantize(dct2_int(r), _t(qps.astype(np.int32))).numpy()
    qpm1 = np.where(qps > 0, qps - 1, qps)
    qq = quantize(dct2_int(split_quads(r)), _t(qpm1.astype(np.int32))[:, None]).numpy()
    h, w = nbr * bs, nbc * bs
    return {"qf": qf.astype(dtype), "qq": qq.astype(dtype), "qps": qps.astype(np.int32),
            "pred": rng.integers(0, 256, (h, w)).astype(np.int16), "pred_q": rng.integers(0, 256, (h, w)).astype(np.int16),
            "split": rng.random(nb) < 0.5, "ok": rng.random(nb) < 0.8, "sub_ok": rng.random((nb, 4)) < 0.8}


def _port_recon(a: dict, vbs: bool, inter: bool, with_ok: bool):
    args = [_t(a["qf"]), _t(a["qq"]) if vbs else None, _t(a["qps"])]
    if not inter:
        return K.residual_recon(*args)
    return K.residual_recon(*args, _t(a["pred"]), _t(a["pred_q"]) if vbs else None, _t(a["split"]) if vbs else None,
                            _t(a["ok"]) if with_ok else None, _t(a["sub_ok"]) if with_ok and vbs else None)


def _jax_dequant(a: dict, vbs: bool):
    """JaxCodec._dequant: widen, rescale at the block QPs (quads at QP - 1), idct2_int, in jnp."""
    qps = jnp.asarray(a["qps"])
    rf = JT.idct2_int(JQ.rescale(jnp.asarray(a["qf"]).astype(jnp.int32), qps).astype(jnp.int32))
    if not vbs:
        return np.asarray(rf), None
    qpm1 = jnp.where(qps > 0, qps - 1, qps)
    return np.asarray(rf), np.asarray(JT.idct2_int(JQ.rescale(jnp.asarray(a["qq"]).astype(jnp.int32),
                                                              qpm1[:, None]).astype(jnp.int32)))


def _assemble(a: dict, rf, rq, vbs: bool, with_ok: bool) -> np.ndarray:
    """JaxCodec._recon_inter's assembly on given residuals: pred + residual wrapped, the quads where split."""
    bs = rf.shape[-1]
    h, w = a["pred"].shape
    pf = np.asarray(blockify(_t(a["pred"]), bs)).astype(np.int64)
    if with_ok:
        pf = np.where(a["ok"][:, None, None], pf, 128)
    blocks = (pf + rf) & 255
    if vbs:
        pq = np.asarray(split_quads(blockify(_t(a["pred_q"]), bs))).astype(np.int64)
        if with_ok:
            pq = np.where(a["sub_ok"][:, :, None, None], pq, 128)
        qb = np.asarray(merge_quads(_t((pq + rq) & 255)))
        blocks = np.where(a["split"][:, None, None], qb, blocks)
    return np.asarray(unblockify(_t(blocks.astype(np.uint8)), h, w))


RECON_GRID = [(bs, vbs, dt) for bs in (8, 16) for vbs in (False, True) for dt in ("int16", "int32")]


@pytest.mark.parametrize("bs,vbs,dtype", RECON_GRID)
def test_residual_recon_on_cpu_matches_jax_package(bs, vbs, dtype):
    a = _recon_inputs(bs, dtype)
    rf, rq = _jax_dequant(a, vbs)
    got_f, got_q = _port_recon(a, vbs, False, False)
    assert got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_f.numpy(), rf)
    if vbs:
        np.testing.assert_array_equal(got_q.numpy(), rq)
    else:
        assert got_q is None
    for with_ok in (False, True):
        out = _port_recon(a, vbs, True, with_ok)
        assert out.dtype == torch.uint8 and tuple(out.shape) == a["pred"].shape
        np.testing.assert_array_equal(out.numpy(), _assemble(a, rf, rq, vbs, with_ok))


def _recon_rule(a: dict, vbs: bool, inter: bool, with_ok: bool):
    """csrc/residual_recon.cu per CTA and thread, in numpy: the 32-bit
    wrapping left shift, the one-pass IDCT, and for an inter frame only the
    variant the block uses, each thread writing its own pixel (a quad
    thread t the pixel (rq, cq) + s (q / 2, q % 2) of the block)."""
    qf, qq, qps = a["qf"].astype(np.int64), a["qq"].astype(np.int64), a["qps"].astype(np.int64)
    nb, n = qf.shape[0], qf.shape[-1]
    s = n // 2
    qpm1 = np.where(qps > 0, qps - 1, qps)

    def shl32(v, k):
        return ((v << (k & 31)) & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)

    rf = _idct_rule(shl32(qf, qps[:, None, None] + q_exponent_matrix(n)))
    rq = _idct_rule(shl32(qq, qpm1[:, None, None, None] + q_exponent_matrix(s))) if vbs else None
    if not inter:
        return rf, rq
    h, w = a["pred"].shape
    nbc = w // n
    out = np.full((h, w), -1, np.int64)
    for b in range(nb):
        y0, x0 = (b // nbc) * n, (b % nbc) * n
        for t in range(n * n):
            if vbs and a["split"][b]:
                q, u = divmod(t, s * s)
                rq_, cq = divmod(u, s)
                y, x = y0 + (q >> 1) * s + rq_, x0 + (q & 1) * s + cq
                p = 128 if with_ok and not a["sub_ok"][b, q] else int(a["pred_q"][y, x])
                out[y, x] = (p + rq[b, q, rq_, cq]) & 255
            else:
                r, c = divmod(t, n)
                y, x = y0 + r, x0 + c
                p = 128 if with_ok and not a["ok"][b] else int(a["pred"][y, x])
                out[y, x] = (p + rf[b, r, c]) & 255
    assert (out >= 0).all()  # every pixel written once a frame
    return out.astype(np.uint8)


@pytest.mark.parametrize("bs,vbs,dtype", RECON_GRID)
def test_recon_rule_matches_plain(bs, vbs, dtype):
    a = _recon_inputs(bs, dtype)
    rf, rq = _recon_rule(a, vbs, False, False)
    got_f, got_q = _port_recon(a, vbs, False, False)
    np.testing.assert_array_equal(rf, got_f.numpy())
    if vbs:
        np.testing.assert_array_equal(rq, got_q.numpy())
    for with_ok in (False, True):
        np.testing.assert_array_equal(_recon_rule(a, vbs, True, with_ok), _port_recon(a, vbs, True, with_ok).numpy())


def test_wrappers_refuse_what_the_kernels_do_not_take_and_launch_nothing_on_cpu():
    a = _select_inputs(16, "random", 1)
    res, quads, sad, sub_sad, qps, elig = (_t(a[k]) for k in ("res", "quads", "sad", "sub_sad", "qps", "elig"))
    kw = dict(qp_nominal=4, lam=LAM, vbs_enable=True, vbs_eligible=elig, bs=16, sbs=8)
    with pytest.raises(TypeError, match="res_full"):
        K.transform_select(res.long(), quads, sad, sub_sad, 1, qps, **kw)
    with pytest.raises(ValueError, match="res_quads"):
        K.transform_select(res, None, sad, sub_sad, 1, qps, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.transform_select(res.transpose(-1, -2), quads, sad, sub_sad, 1, qps, **kw)
    with pytest.raises(ValueError, match="sbs"):
        K.transform_select(res, quads, sad, sub_sad, 1, qps, **dict(kw, sbs=4))
    r = _recon_inputs(16, "int16")
    qf, qq, rqps = _t(r["qf"]), _t(r["qq"]), _t(r["qps"])
    with pytest.raises(TypeError, match="qtc_quads"):
        K.residual_recon(qf, qq.to(torch.int32), rqps)
    with pytest.raises(ValueError, match="prediction plane"):
        K.residual_recon(qf, qq, rqps, _t(r["pred"])[:-16])
    with pytest.raises(ValueError, match="split"):
        K.residual_recon(qf, qq, rqps, _t(r["pred"]), _t(r["pred_q"]))
    with pytest.raises(TypeError, match="qps"):
        K.residual_recon(qf, qq, rqps.long())
    n0 = (K.transform_select.launches, K.residual_recon.launches)
    K.transform_select(res, quads, sad, sub_sad, 1, qps, **kw)
    K.residual_recon(qf, qq, rqps, _t(r["pred"]), _t(r["pred_q"]), _t(r["split"]))
    assert (K.transform_select.launches, K.residual_recon.launches) == n0  # CPU tensors: the plain versions


# ------------------------------------------------------------ the engines
TOOLS = {
    "whole_pel": dict(search_range=4),
    "vbs": dict(search_range=4, vbs_enable=True),
    "fme": dict(search_range=4, fme_enable=True),
    "fast_vbs_fme": dict(search_range=16, vbs_enable=True, fme_enable=True, fast_me=True),
    "intra1_vbs": dict(search_range=8, vbs_enable=True, intra_mode=1),
    "rc": dict(search_range=4, rc_flag=1, target_br="60 kbps", frame_rate=30,
               qp_rate_tables=[[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
                               [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170]]),
}
ENC = dict(height=32, width=48, frames=5, qp=4, intra_dur=3, lam=0.015)


@pytest.fixture(scope="module", params=list(TOOLS))
def both(request, tmp_path_factory):
    """One clip through each package's facade: the encodes, text and binary files, and decodes."""
    name = request.param
    kw = dict(ENC, **TOOLS[name])
    clip = synthetic_clip(32, 48, 5, seed=11)
    d = tmp_path_factory.mktemp(name)
    out = {}
    for tag, cls, cfg in (("j", JaxVideoCodec, JaxCodecConfig(**kw)), ("t", VideoCodec, CodecConfig(**kw))):
        v = cls(cfg, clip) if tag == "j" else cls(cfg, clip, device="cpu")
        pkg = v.encode(compute_ssim=False, package=False)
        v.transmit_bitstream(d / f"{tag}mv.txt", d / f"{tag}res.txt")
        v.transmit_bitstream_binary(d / f"{tag}.sob")
        dec_cls = (lambda c: cls(c)) if tag == "j" else (lambda c: cls(c, device="cpu"))
        out[tag] = {"pkg": pkg, "dec": np.asarray(dec_cls(cfg).decode_bitstream(d / f"{tag}mv.txt",
                                                                                d / f"{tag}res.txt")),
                    "bdec": np.asarray(dec_cls(cfg).decode_bitstream_binary(d / f"{tag}.sob"))}
    out["dir"] = d
    return out


def test_torch_codec_equals_jax_codec_on_each_tool_set(both):
    j, t, d = both["j"]["pkg"], both["t"]["pkg"], both["dir"]
    assert t["frame_type_seq"] == j["frame_type_seq"] and t["Qp_per_row_per_frame"] == j["Qp_per_row_per_frame"]
    assert t["residual size per frame"] == j["residual size per frame"]
    for i, (a, b) in enumerate(zip(t["per_frame"], j["per_frame"])):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "row_bits", "recon"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=f"frame {i} {k}")
    for f in ("mv.txt", "res.txt", ".sob"):
        assert (d / f"t{f}").read_bytes() == (d / f"j{f}").read_bytes(), f
    recon = t["reconstructed frames"]
    np.testing.assert_array_equal(recon, j["reconstructed frames"])
    for tag in ("t", "j"):
        np.testing.assert_array_equal(both[tag]["dec"], recon)
        np.testing.assert_array_equal(both[tag]["bdec"], recon)


ROUTES = {"whole_pel": dict(search_range=4), "fast_vbs_fme": TOOLS["fast_vbs_fme"], "intra1_vbs": TOOLS["intra1_vbs"]}


@pytest.mark.parametrize("name", list(ROUTES))
def test_every_frame_step_routes_through_the_wrappers(name, monkeypatch):
    """Each encoded frame calls ``transform_select`` once, each encoded and
    decoded frame ``residual_recon`` once, each intra frame ``intra_search``
    once; the plain versions behind them give the engine's outputs."""
    calls = {k: 0 for k in ("transform_select", "residual_recon", "intra_search")}
    for k in calls:
        plain = getattr(K, f"{k}_plain")

        def counted(*a, _k=k, _plain=plain, **kw):
            calls[_k] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(K, k, counted)
    cfg = CodecConfig(**dict(ENC, **ROUTES[name]))
    codec = TorchCodec(cfg, synthetic_clip(32, 48, 5, seed=2), device="cpu")
    pkg = codec.encode(package=False)
    fts = pkg["frame_type_seq"]
    assert fts == [0, 1, 1, 0, 1] and calls == {"transform_select": 5, "residual_recon": 5, "intra_search": 2}
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(pkg["per_frame"], fts)]
    dec = codec.decode(fts, [r for _, r in pairs], [[]] * len(fts), [m for m, _ in pairs])
    assert calls == {"transform_select": 5, "residual_recon": 10, "intra_search": 2}
    np.testing.assert_array_equal(torch.stack(list(dec)).numpy(), pkg["reconstructed frames"])


def test_entry_points_default_to_the_card():
    """Every entry point runs on the card unless the caller asks for the CPU:
    the device defaults to "cuda", and without a card the facade fails
    rather than running on the CPU."""
    import inspect

    from streamoptima_tpu_torch import metrics, profiling, rc
    from streamoptima_tpu_torch.compat_engine import CompatCodec
    from streamoptima_tpu_torch.parallel.dryrun import dryrun_multichip

    for fn in (TorchCodec, CompatCodec, metrics.ssim_frames, profiling.time_steps, rc.measure_qp_tables,
               dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            VideoCodec(CodecConfig(**dict(ENC, search_range=4)))
    with pytest.raises(TypeError, match="at most one"):
        VideoCodec(CodecConfig(**dict(ENC, search_range=4)), device="cpu", mesh=object())
