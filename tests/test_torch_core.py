"""PyTorch port, integer core and intra: parity with the JAX package.

Every test feeds the same seeded numpy inputs to the JAX package's function
(its numpy or jnp path) and to the port's counterpart on the CPU.  The
codec's arithmetic is integer, so the tolerance is exact everywhere except
PSNR (float32, reductions in another order: 1e-4 dB).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu import metrics as JM
from streamoptima_tpu.core import intra as JI
from streamoptima_tpu.core import pred as JP
from streamoptima_tpu.core import quant as JQ
from streamoptima_tpu.core import rd as JRD
from streamoptima_tpu.core import transform as JT
from streamoptima_tpu.core import zigzag as JZ
from streamoptima_tpu_torch import metrics as TM
from streamoptima_tpu_torch.core import blocks as TB
from streamoptima_tpu_torch.core import intra as TI
from streamoptima_tpu_torch.core import pred as TP
from streamoptima_tpu_torch.core import quant as TQ
from streamoptima_tpu_torch.core import rd as TRD
from streamoptima_tpu_torch.core import transform as TT
from streamoptima_tpu_torch.core import zigzag as TZ

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [8, 16])
def test_constant_tables_match_jax_package(n):
    np.testing.assert_array_equal(TT.dct_matrix(n, CPU).numpy(), JT.dct_matrix_fixed(n))
    np.testing.assert_array_equal(TQ.band_exponents(n, CPU).numpy(), JQ.q_exponent_matrix(n))
    np.testing.assert_array_equal(TZ.scan_indices(n, CPU).numpy(), JZ.diag_scan_indices(n))


def test_blockify_roundtrip_matches_jax_layout():
    rng = np.random.default_rng(0)
    f = rng.integers(0, 256, (48, 64)).astype(np.int32)
    from streamoptima_tpu.core.blocks import blockify

    b = TB.blockify(_t(f), 16)
    np.testing.assert_array_equal(b.numpy(), blockify(f, 16))
    np.testing.assert_array_equal(TB.unblockify(b, 48, 64).numpy(), f)


@pytest.mark.parametrize("qp", [0, 1, 4, 7])
def test_quantize_rescale_scalar_qp(qp):
    rng = np.random.default_rng(qp)
    tc = rng.integers(-4096, 4097, (20, 16, 16)).astype(np.int32)
    # exact half-way ties of every shift, both signs
    tc[0] = (np.arange(256).reshape(16, 16) - 128) << max(qp, 1) >> 1
    np.testing.assert_array_equal(TQ.quantize(_t(tc), qp).numpy(), JQ.quantize(tc, qp))
    q = JQ.quantize(tc, qp).astype(np.int32)
    np.testing.assert_array_equal(TQ.rescale(_t(q), qp).numpy(), JQ.rescale(q, qp))


def test_quantize_rescale_per_block_qps():
    rng = np.random.default_rng(1)
    tc = rng.integers(-4096, 4097, (30, 16, 16)).astype(np.int32)
    qps = rng.integers(0, 12, 30).astype(np.int32)
    np.testing.assert_array_equal(TQ.quantize(_t(tc), _t(qps)).numpy(), JQ.quantize(tc, qps))
    q = JQ.quantize(tc, qps).astype(np.int32)
    np.testing.assert_array_equal(TQ.rescale(_t(q), _t(qps)).numpy(), JQ.rescale(q, qps))


def test_rhe_shift_right_ties_and_zero_shift():
    num = np.arange(-64, 65, dtype=np.int32)
    for k in (0, 1, 2, 3, 5):
        np.testing.assert_array_equal(TQ.rhe_shift_right(_t(num), k).numpy(), JQ.rhe_shift_right(num, k))
    ks = np.arange(129, dtype=np.int32) % 6
    np.testing.assert_array_equal(TQ.rhe_shift_right(_t(num), _t(ks)).numpy(), JQ.rhe_shift_right(num, ks))


def _dct_inputs(rng):
    x = rng.integers(-255, 256, (64, 16, 16)).astype(np.int32)
    x[0] = 255
    x[1] = -255
    x[2] = np.where((np.add.outer(np.arange(16), np.arange(16)) % 2) == 0, 255, -255)
    x[3] = np.where(np.arange(16)[None, :] < 8, 255, -255)
    return x


def test_dct2_int_matches_jax_package_including_extremes():
    x = _dct_inputs(np.random.default_rng(2))
    np.testing.assert_array_equal(TT.dct2_int(_t(x)).numpy(), JT.dct2_int(x))
    np.testing.assert_array_equal(TT.dct2_int(_t(x)).numpy(), np.asarray(JT.dct2_int(jnp.asarray(x))))


def test_idct2_int_matches_jax_package_including_extremes():
    rng = np.random.default_rng(3)
    t = rng.integers(-12288, 12289, (64, 16, 16)).astype(np.int32)
    t[0] = 12288
    t[1] = -12288
    t[2] = np.where((np.add.outer(np.arange(16), np.arange(16)) % 2) == 0, 12288, -12288)
    t[3] = 0
    t[3, 0, 0] = 4080 << 4
    np.testing.assert_array_equal(TT.idct2_int(_t(t)).numpy(), JT.idct2_int(t))
    np.testing.assert_array_equal(TT.idct2_int(_t(t)).numpy(), np.asarray(JT.idct2_int(jnp.asarray(t))))


def test_dct_quant_idct_chain_small_blocks():
    rng = np.random.default_rng(4)
    x = rng.integers(-255, 256, (16, 8, 8)).astype(np.int32)
    q = JQ.quantize(JT.dct2_int(x), 3).astype(np.int32)
    r = JT.idct2_int(JQ.rescale(q, 3).astype(np.int32))
    got = TT.idct2_int(TQ.rescale(TQ.quantize(TT.dct2_int(_t(x)), 3), 3))
    np.testing.assert_array_equal(got.numpy(), r)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
def test_rle_length_matches_jax_package(density):
    rng = np.random.default_rng(int(density * 100))
    v = rng.integers(-9, 10, (40, 16, 16))
    mask = rng.random((40, 16, 16)) < density
    blocks = np.where(mask, v, 0).astype(np.int32)
    np.testing.assert_array_equal(TZ.rle_length(_t(blocks)).numpy(), JZ.rle_length(blocks))


@pytest.mark.parametrize("with_invalid", [False, True])
def test_transform_and_select_non_vbs(with_invalid):
    rng = np.random.default_rng(5)
    nb = 24
    res = rng.integers(-255, 256, (nb, 16, 16)).astype(np.int32)
    res[::3] //= 16  # sparse blocks: zero runs in the coded lengths
    sad = np.abs(res).sum(axis=(1, 2)).astype(np.int32)
    qps = rng.integers(0, 8, nb).astype(np.int32)
    ok = rng.random(nb) > 0.2 if with_invalid else None
    ref = JRD.transform_and_select(
        jnp.asarray(res), jnp.zeros((nb, 4, 8, 8), jnp.int32), jnp.asarray(sad), jnp.zeros((nb, 4), jnp.int32),
        1, jnp.asarray(qps), qp_nominal=4, lam=None, vbs_enable=False, vbs_eligible=None, bs=16, sbs=8,
        ok_full=None if ok is None else jnp.asarray(ok),
    )
    got = TRD.transform_and_select(_t(res), None, _t(sad), None, 1, _t(qps), qp_nominal=4, lam=None,
                                   vbs_enable=False, vbs_eligible=None, bs=16, sbs=8,
                                   ok_full=None if ok is None else _t(ok))
    for name, a, b in zip(("split", "qtc_full", "qtc_quads", "lens", "mae"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_transform_and_select_refuses_vbs():
    """VBS without the quad inputs is refused, not decided on half the data."""
    with pytest.raises(ValueError, match="vbs_enable"):
        TRD.transform_and_select(torch.zeros((1, 16, 16), dtype=torch.int32), None, torch.zeros(1, dtype=torch.int32),
                                 None, 1, torch.full((1,), 4, dtype=torch.int32), qp_nominal=4, lam=0.015,
                                 vbs_enable=True, vbs_eligible=torch.ones(1, dtype=torch.bool), bs=16, sbs=8)


def _smooth_frame(h, w, seed):
    from streamoptima_tpu_torch.utils import synthetic_clip

    return synthetic_clip(h, w, 1, seed=seed)[0]


@pytest.mark.parametrize("h,w,sr", [(48, 64, 4), (64, 96, 8), (48, 96, 16)])
def test_intra_search_and_residuals(h, w, sr):
    cur = _smooth_frame(h, w, sr).astype(np.int32)
    ref = JI.intra_search_mode0(jnp.asarray(cur), 16, sr, w, False, jnp)
    got = TI.intra_search_mode0(_t(cur), 16, sr, w)
    np.testing.assert_array_equal(got["mv"].numpy(), np.asarray(ref["mv"]))
    np.testing.assert_array_equal(got["sad"].numpy(), np.asarray(ref["sad"]))
    # the numpy path of the JAX package agrees too
    np.testing.assert_array_equal(got["sad"].numpy(), JI.intra_search_mode0(cur, 16, sr, w, False, np)["sad"])
    res_ref, _ = JI.intra_residuals_mode0(jnp.asarray(cur), ref["mv"], None, 16, jnp, sr=sr)
    res, quads = TI.intra_residuals_mode0(_t(cur), got["mv"], 16, sr)
    assert quads is None
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_ref))


def test_intra_search_on_random_noise_and_flat_frames():
    rng = np.random.default_rng(9)
    for cur in (rng.integers(0, 256, (32, 80)).astype(np.int32), np.full((32, 80), 77, np.int32)):
        ref = JI.intra_search_mode0(cur, 16, 8, 80, False, np)
        got = TI.intra_search_mode0(_t(cur), 16, 8, 80)
        np.testing.assert_array_equal(got["mv"].numpy(), ref["mv"])
        np.testing.assert_array_equal(got["sad"].numpy(), ref["sad"])


@pytest.mark.parametrize("sr", [4, 8, 12, 16, 20])
def test_intra_reconstruct_variants(sr):
    """sr < bs takes the wavefront variant, sr >= bs the column scan; both
    must equal the JAX variants and the sequential numpy oracle."""
    h, w, bs = 48, 96, 16
    rng = np.random.default_rng(sr)
    nbr, nbc = h // bs, w // bs
    mv = rng.integers(-sr, 1, (nbr, nbc)).astype(np.int32)
    mv = np.maximum(mv, -np.arange(nbc) * bs).astype(np.int32)  # valid: x + mv >= 0
    mv[:, 0] = -1
    rf = rng.integers(-40, 41, (nbr * nbc, bs, bs)).astype(np.int32)
    got = TI.intra_reconstruct_mode0(_t(rf), _t(mv.reshape(-1)), h, w, bs, sr)
    split = np.zeros(nbr * nbc, bool)
    ref_j = JI.intra_reconstruct_mode0(jnp.asarray(rf), None, jnp.asarray(split), jnp.asarray(mv.reshape(-1)),
                                       None, h, w, bs, jnp, sr=sr)
    ref_np = JI.intra_reconstruct_mode0(rf, None, split, mv.reshape(-1), None, h, w, bs, np)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_j))
    np.testing.assert_array_equal(got.numpy(), ref_np)


@pytest.mark.parametrize("nref,bound", [(1, 4), (2, 8), (2, 40)])
def test_gather_predictions_whole_pel(nref, bound):
    rng = np.random.default_rng(nref * 100 + bound)
    h, w, bs = 48, 64, 16
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    nb = (h // bs) * (w // bs)
    mv = np.stack([rng.integers(-bound, bound + 1, nb), rng.integers(-bound, bound + 1, nb),
                   rng.integers(0, nref, nb)], 1).astype(np.int32)
    ys, xs = np.meshgrid(np.arange(h // bs) * bs, np.arange(w // bs) * bs, indexing="ij")
    bx, by = xs.reshape(-1), ys.reshape(-1)
    ref = JP.gather_predictions(mv, refs.astype(np.int32), bx, by, bs, False, np)
    got = TP.gather_predictions(_t(mv), _t(refs), _t(bx), _t(by), bs)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrap_uint8_and_psnr():
    rng = np.random.default_rng(11)
    x = rng.integers(-600, 600, (3, 16, 16)).astype(np.int32)
    np.testing.assert_array_equal(TP.wrap_uint8(_t(x)).numpy(), JP.wrap_uint8(x, np))
    a = rng.integers(0, 256, (4, 32, 48)).astype(np.uint8)
    b = rng.integers(0, 256, (4, 32, 48)).astype(np.uint8)
    np.testing.assert_allclose(TM.psnr(_t(a), _t(b)).numpy(), np.asarray(JM.psnr_jax(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-4)
