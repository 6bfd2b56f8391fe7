"""PyTorch port, the two kernels' plain versions and wrappers on the CPU.

The plain versions (what a CPU tensor runs, and what the CUDA kernels are
held against on the card) must equal the JAX package's Pallas kernels, run
in interpret mode as its own tests run them, and the numpy oracle of
core/me.py.  Exact tolerance: the search and the fetch are integer.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu.core import me as JME
from streamoptima_tpu.core import me_pallas as MP
from streamoptima_tpu.core import pred as JP
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as TME

torch.set_num_threads(1)
INT32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coords(h, w, bs=16):
    ys, xs = np.meshgrid(np.arange(h // bs) * bs, np.arange(w // bs) * bs, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _oracle(cur, refs, sr, bs=16):
    """numpy oracle (JAX package): search result plus the (h, w) pred plane
    with zeros where no candidate is valid."""
    h, w = cur.shape
    a = JME.full_search_materialized(cur.astype(np.int32), refs.astype(np.int32), sr, bs, bs // 2, 1, False,
                                     False, np)
    bx, by = _coords(h, w, bs)
    g = JP.gather_predictions(a["mv"], refs.astype(np.int32), bx, by, bs, False, np)
    g = np.where(a["ok"][:, None, None], g, 0)
    a["pred"] = g.reshape(h // bs, w // bs, bs, bs).swapaxes(1, 2).reshape(h, w)
    return a


def _assert_search_equal(got, ref):
    for k in ("mv", "sad", "ok", "pred"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("nref", [1, 2])
@pytest.mark.parametrize("sr", [4, 8])
@pytest.mark.parametrize("h,w", [(48, 64), (64, 96)])
def test_full_search_plain_matches_pallas_kernel(h, w, sr, nref):
    rng = np.random.default_rng(h + w + sr + nref)
    cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    ref = MP.full_search_pallas(jnp.asarray(cur, jnp.int32), jnp.asarray(refs, jnp.int32), sr, 16, 8, False,
                                interpret=True)
    got = K.full_search(_t(cur), _t(refs), sr, 16)
    _assert_search_equal(got, ref)


def test_full_search_recovers_translation():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (80, 144)).astype(np.uint8)
    ref = base[2 : 2 + 64, 3 : 3 + 128]
    cur = base[0:64, 0:128]
    got = K.full_search(_t(cur), _t(ref[None]), 4, 16)
    mv = got["mv"].numpy().reshape(4, 8, 3)
    assert (mv[1:3, 2:6, 0] == -3).all() and (mv[1:3, 2:6, 1] == -2).all()
    assert (got["sad"].numpy().reshape(4, 8)[1:3, 2:6] == 0).all()


@pytest.mark.parametrize("case", ["flat", "black_vs_white", "two_refs_tie"])
def test_full_search_ties_follow_packed_key(case):
    """Equal SADs everywhere: the winner must be the smallest packed
    (l1, ref, dxi, dyi) key, never the first candidate found."""
    h, w, sr = 48, 64, 4
    if case == "flat":
        cur, refs = np.full((h, w), 90, np.uint8), np.full((1, h, w), 90, np.uint8)
    elif case == "black_vs_white":
        cur, refs = np.zeros((h, w), np.uint8), np.full((1, h, w), 255, np.uint8)
    else:
        cur = np.full((h, w), 10, np.uint8)
        refs = np.stack([np.full((h, w), 12, np.uint8), np.full((h, w), 8, np.uint8)])
    got = K.full_search(_t(cur), _t(refs), sr, 16)
    _assert_search_equal(got, _oracle(cur, refs, sr))
    mv = got["mv"].numpy().reshape(h // 16, w // 16, 3)
    assert (mv[:-1, :-1] == 0).all()  # l1 = 0 and ref 0: the smallest key
    # last column / row: d = 0 is out of bounds, the nearest key is d = -1
    assert (mv[:, -1, 0] == -1).all() and (mv[-1, :, 1] == -1).all()


def test_full_search_strict_bound_excludes_last_column():
    """The only exact match sits at x + dx == W - bs, which the reference's
    off-by-one marks invalid: it must not win."""
    h, w, sr = 48, 64, 4
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
    cur[16:32, 32:48] = ref[16:32, 48:64]  # block (1, 2) matches at dx = +16 > sr: out of range
    cur[16:32, 48:64] = ref[16:32, 48:64]  # block (1, 3) matches at dx = 0, x + dx == W - bs
    got = K.full_search(_t(cur), _t(ref[None]), sr, 16)
    _assert_search_equal(got, _oracle(cur, ref[None], sr))
    b = 1 * (w // 16) + 3
    assert got["sad"][b] > 0 and got["mv"][b, 0] < 0


def test_full_search_no_valid_candidate():
    """A one-block-wide frame has no valid candidate: mv (0,0,0),
    sad INT32_MAX, ok False, pred zeros."""
    rng = np.random.default_rng(4)
    cur = rng.integers(0, 256, (48, 16)).astype(np.uint8)
    refs = rng.integers(0, 256, (1, 48, 16)).astype(np.uint8)
    got = K.full_search(_t(cur), _t(refs), 4, 16)
    _assert_search_equal(got, _oracle(cur, refs, 4))
    assert not got["ok"].any() and (got["sad"] == INT32_MAX).all() and (got["pred"] == 0).all()


def test_secondary_key_packing_matches_jax_argmin():
    nref, sr = 3, 5
    nd = 2 * sr + 1
    d = np.arange(-sr, sr + 1)
    l1 = np.abs(d)[None, :, None] + np.abs(d)[None, None, :]
    ref = ((l1.astype(np.int32) << 3 | np.arange(nref)[:, None, None]) << 8 | np.arange(nd)[None, None, :]) << 8 \
        | np.arange(nd)[None, :, None]
    np.testing.assert_array_equal(TME.secondary_keys(nref, sr, torch.device("cpu")).numpy(), ref)


@pytest.mark.parametrize("nref", [1, 2])
@pytest.mark.parametrize("sr", [4, 8])
@pytest.mark.parametrize("h,w", [(48, 64), (64, 96)])
def test_pred_fetch_plain_matches_pallas_kernel(h, w, sr, nref):
    rng = np.random.default_rng(h + nref * 10 + sr)
    nb = (h // 16) * (w // 16)
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    mv = np.stack([rng.integers(-sr, sr + 1, nb), rng.integers(-sr, sr + 1, nb), rng.integers(0, nref, nb)],
                  1).astype(np.int32)
    mv[0, :2] = -sr  # top-left block: window partly outside the frame
    smv = np.zeros((nb, 4, 3), np.int32)
    tab, pad = MP.build_fetch_table(mv, smv, sr, False, False, h // 16, w // 16, 16)
    ref, _ = MP.pred_fetch_compact(jnp.asarray(mv), jnp.asarray(smv), jnp.asarray(refs, jnp.int32),
                                   jnp.asarray(tab), pad, 16, 8, False, False, interpret=True)
    got = K.pred_fetch(_t(mv), _t(refs), 16)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_pred_fetch_serves_mvs_beyond_search_range():
    """No dispatch split: MVs past +-sr and windows fully outside the frame
    come out of the same path, zero-filled like the reference gather."""
    rng = np.random.default_rng(8)
    h, w = 48, 64
    nb = 12
    refs = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    mv = np.stack([rng.integers(-70, 71, nb), rng.integers(-60, 61, nb), rng.integers(0, 2, nb)], 1).astype(np.int32)
    mv[1] = (200, 0, 1)
    bx, by = _coords(h, w)
    g = JP.gather_predictions(mv, refs.astype(np.int32), bx, by, 16, False, np)
    exp = g.reshape(3, 4, 16, 16).swapaxes(1, 2).reshape(h, w)
    np.testing.assert_array_equal(K.pred_fetch(_t(mv), _t(refs), 16).numpy(), exp)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    cur = torch.zeros((48, 64), dtype=torch.uint8)
    refs = torch.zeros((1, 48, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        K.full_search(cur.to(torch.int32), refs, 4, 16)
    with pytest.raises(ValueError, match="nref"):
        K.full_search(cur, torch.zeros((9, 48, 64), dtype=torch.uint8), 4, 16)
    with pytest.raises(ValueError, match="sr"):
        K.full_search(cur, refs, 128, 16)
    with pytest.raises(ValueError, match="contiguous"):
        K.full_search(torch.zeros((64, 48), dtype=torch.uint8).T, refs, 4, 16)
    with pytest.raises(ValueError, match="match"):
        K.full_search(cur, torch.zeros((1, 48, 80), dtype=torch.uint8), 4, 16)
    with pytest.raises(ValueError, match="mv"):
        K.pred_fetch(torch.zeros((12, 3), dtype=torch.int64), refs, 16)
    with pytest.raises(ValueError, match="blocks"):
        K.pred_fetch(torch.zeros((11, 3), dtype=torch.int32), refs, 16)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = (K.full_search.launches, K.pred_fetch.launches)
    cur = torch.zeros((48, 64), dtype=torch.uint8)
    refs = torch.zeros((1, 48, 64), dtype=torch.uint8)
    K.full_search(cur, refs, 4, 16)
    K.pred_fetch(torch.zeros((12, 3), dtype=torch.int32), refs, 16)
    assert (K.full_search.launches, K.pred_fetch.launches) == before
