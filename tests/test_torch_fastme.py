"""PyTorch port, fast ME on the CPU: parity with the JAX package.

The same seeded numpy inputs go through ``streamoptima_tpu.core.fastme`` /
``me_pallas`` (the Pallas kernels in interpret mode, as ``tests/test_fastme.py``
runs them, or their XLA twins) and through the port's ``core/fastme.py`` and
the plain PyTorch versions of its two fast-ME kernels.  All arithmetic is
integer: every comparison is exact (tolerance 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu.core import fastme as JFM
from streamoptima_tpu.core import me_pallas as MP
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch.core import blocks as TB
from streamoptima_tpu_torch.core import fastme as FM
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as TME
from streamoptima_tpu_torch.engine import TorchCodec

torch.set_num_threads(1)
INT32_MAX = 2**31 - 1
BS = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _setup(fme, nref=2, h=64, w=96, seed=0):
    """A frame, references and MVP guesses as ``tests/test_fastme.py`` makes
    them: small guesses of either sign and parity, some far outside the frame
    (K8 fallbacks), some exactly on an edge."""
    rng = np.random.default_rng(seed)
    nbr, nbc = h // BS, w // BS
    nb = nbr * nbc
    cur = rng.integers(0, 256, (h, w)).astype(np.uint8)
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    ys, xs = np.meshgrid(np.arange(nbr) * BS, np.arange(nbc) * BS, indexing="ij")
    bx, by = xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)
    scale = 2 if fme else 1
    g = rng.integers(-6, 7, (nb, 3))
    g[:, 2] = rng.integers(0, nref, nb)
    g[3] = [5000, -4000, 0]
    g[7] = [-2 * w, 2 * h, nref - 1]
    g[11] = [scale * (w - BS) - scale * bx[11], 0, 0]  # right edge
    g[15] = [0, -scale * by[15], 0]  # top edge exactly
    g[1] = [-3, -5, 0]  # negative and odd
    return cur, refs, bx, by, g.astype(np.int32), (nbr, nbc)


def _planes(refs, fme):
    """The port's planes of ``refs``: parity planes under FME, else the frames."""
    return TME.fme_parity_planes(_t(refs), True) if fme else _t(refs)


def _dims(h, w, fme):
    return (2 * h - 1, 2 * w - 1) if fme else (h, w)


# ----------------------------------------------------------- window fetch
def _origins(rng, H, W, nwin, nc, nb=24):
    by0 = rng.integers(1, H - nwin, nb)
    bx0 = rng.integers(1, max(W - nc, 2), nb)
    by0[:8] = (-3, H - 5, 10, 12, -nwin, H, -(10**5), 7)  # straddling top/bottom, just outside, far outside
    bx0[:8] = (9, 11, -7, W - 4, 5, 5, 13, 10**5)
    by0[8], bx0[8] = -1, -1  # a corner
    by0[9], bx0[9] = H - 1, W - 1
    return by0.astype(np.int32), bx0.astype(np.int32)


@pytest.mark.parametrize("source", ["window_gather", "pallas_window_fetch"])
@pytest.mark.parametrize("nwin,nwin_c,P,W", [(18, None, 8, 96), (10, None, 8, 96), (21, 69, 8, 96), (24, 72, 8, 96),
                                             (18, None, 1, 96), (18, None, 4, 97), (10, 21, 1, 59)],
                         ids=["18-None", "10-None", "21-69", "24-72", "18-None-P1", "18-None-W97", "10-21-P1-W59"])
def test_window_fetch_plain_matches_jax_package(nwin, nwin_c, P, W, source):
    """Square and rectangular windows, eight planes or one, even and odd
    widths; origins inside, straddling every edge, and wholly outside the
    plane."""
    rng = np.random.default_rng(nwin if (P, W) == (8, 96) else (nwin, P, W))
    H = 64
    planes = rng.integers(1, 256, (P, H, W)).astype(np.uint8)
    by0, bx0 = _origins(rng, H, W, nwin, nwin_c or nwin)
    got = K.window_fetch(_t(planes), _t(by0), _t(bx0), nwin, nwin_c)
    assert got.dtype == torch.uint8 and got.shape == (24, P, nwin, nwin_c or nwin)
    jp = jnp.asarray(planes).astype(jnp.bfloat16)
    if source == "window_gather":
        ref = JFM.window_gather(jp, jnp.asarray(by0), jnp.asarray(bx0), nwin, jnp, nwin_c=nwin_c)
    else:
        ref = MP.window_fetch(MP.window_prep(jp, nwin, nwin_c=nwin_c), jnp.asarray(by0), jnp.asarray(bx0), nwin,
                              interpret=True, nwin_c=nwin_c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[6] == 0).all() and (got[7] == 0).all() and (got[4] == 0).all() and (got[5] == 0).all()
    assert (got[0, :, :3] == 0).all() and (got[0, :, 3:] != 0).all()  # partly outside is partly zero


def test_window_fetch_wrapper_refuses_what_the_kernel_does_not_take():
    planes = torch.zeros((4, 32, 48), dtype=torch.uint8)
    o = torch.zeros((5,), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.window_fetch(planes.to(torch.int32), o, o, 18)
    with pytest.raises(ValueError, match="by0"):
        K.window_fetch(planes, o.to(torch.int64), o, 18)
    with pytest.raises(ValueError, match="bx0"):
        K.window_fetch(planes, o, o[:4], 18)
    with pytest.raises(ValueError, match="extents"):
        K.window_fetch(planes, o, o, 0)
    before = K.window_fetch.launches
    K.window_fetch(planes, o, o, 18)
    assert K.window_fetch.launches == before  # CPU: the plain version, no launch


# ------------------------------------------------------------ the pieces
@pytest.mark.parametrize("fme", [False, True])
def test_region_base_valid_and_pick_match_jax_package(fme):
    cur, refs, bx, by, g, _ = _setup(fme)
    h, w = cur.shape
    dims = _dims(h, w, fme)
    by0, bx0 = FM.region_base(_t(g), _t(by), _t(bx), fme)
    rby0, rbx0 = JFM._region_base(jnp.asarray(g), jnp.asarray(by), jnp.asarray(bx), BS, fme, jnp)
    np.testing.assert_array_equal(by0.numpy(), np.asarray(rby0))
    np.testing.assert_array_equal(bx0.numpy(), np.asarray(rbx0))
    scale = 2 if fme else 1
    for n in (BS, BS // 2):
        valid = FM.cand_valid(_t(g), _t(scale * bx), _t(scale * by), n, dims)
        ref = JFM._cand_valid(jnp.asarray(g), jnp.asarray(scale * bx), jnp.asarray(scale * by), n, dims, 2, None, jnp)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref)[:, 0])
    rng = np.random.default_rng(5)
    sads = rng.integers(0, 4, (g.shape[0], 2, 3, 3)).astype(np.int32)  # many ties: the scan order decides
    mv, sad, ok = FM.pick9(_t(sads), valid, _t(g))
    rmv, rsad, _, _, rok = JFM.pick9(jnp.asarray(sads), ref, jnp.asarray(g), jnp)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rmv))
    np.testing.assert_array_equal(sad.numpy(), np.asarray(rsad))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert not ok.all() and (mv[~ok] == _t(g)[~ok]).all() and (sad[~ok] == INT32_MAX).all()  # K8


@pytest.mark.parametrize("fme", [False, True])
def test_eval9_from_fetched_windows_matches_jax_package(fme):
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme, seed=2)
    h, w = cur.shape
    dims = _dims(h, w, fme)
    scale = 2 if fme else 1
    jplanes = JFM.plane_stack(jnp.asarray(refs), fme, jnp)
    jcur_b = jnp.asarray(cur.astype(np.int32)).reshape(nbr, BS, nbc, BS).swapaxes(1, 2).reshape(-1, BS, BS)
    rby0, rbx0 = JFM._region_base(jnp.asarray(g), jnp.asarray(by), jnp.asarray(bx), BS, fme, jnp)
    jwin = JFM.window_gather(jplanes, rby0, rbx0, BS + 2, jnp)
    rmv, rsad = JFM.eval9(jwin, jcur_b, jnp.asarray(g), jnp.asarray(scale * bx), jnp.asarray(scale * by), BS, dims,
                          fme, None, jnp)
    planes = _planes(refs, fme)
    by0, bx0 = FM.region_base(_t(g), _t(by), _t(bx), fme)
    win = K.window_fetch(planes.reshape(-1, h, w), by0, bx0, BS + 2)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    cur_b = TB.blockify(_t(cur), BS).to(torch.int32)
    mv, sad, _ = FM.pick9(FM.sad9(win, cur_b, _t(g), BS, fme),
                          FM.cand_valid(_t(g), _t(scale * bx), _t(scale * by), BS, dims), _t(g))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rmv))
    np.testing.assert_array_equal(sad.numpy(), np.asarray(rsad))


# ------------------------------------------------------------ the confirm
@pytest.mark.parametrize("fme,vbs", [(True, True), (False, False), (False, True), (True, False)])
def test_confirm_matches_jax_package(fme, vbs):
    """Block and quad winners, SADs and oks at wild MVPs, and — for the two
    configurations the engine runs — the predictions the port fetches at
    those MVs against the JAX confirm's own, K8 fallback blocks included."""
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme, seed=4)
    h, w = cur.shape
    s = BS // 2
    dims = _dims(h, w, fme)
    scale = 2 if fme else 1
    jplanes = JFM.plane_stack(jnp.asarray(refs), fme, jnp)
    jcur_b = jnp.asarray(cur.astype(np.int32)).reshape(nbr, BS, nbc, BS).swapaxes(1, 2).reshape(-1, BS, BS)
    jcur_q = jcur_b.reshape(-1, 2, s, 2, s).swapaxes(2, 3).reshape(-1, 4, s, s)
    rby0, rbx0 = JFM._region_base(jnp.asarray(g), jnp.asarray(by), jnp.asarray(bx), BS, fme, jnp)
    jwin = JFM.window_gather(jplanes, rby0, rbx0, BS + 2, jnp)
    ref = JFM.confirm(jwin, jcur_b, jcur_q, jnp.asarray(g), jnp.asarray(scale * bx), jnp.asarray(scale * by), BS, s,
                      dims, fme, vbs, None, rby0, rbx0, jnp)

    planes = _planes(refs, fme)
    by0, bx0 = FM.region_base(_t(g), _t(by), _t(bx), fme)
    win = K.window_fetch(planes.reshape(-1, h, w), by0, bx0, BS + 2)
    cur_b = TB.blockify(_t(cur), BS).to(torch.int32)
    got = FM.confirm(win, cur_b, _t(g), _t(scale * bx), _t(scale * by), BS, dims, fme, vbs)
    keys = ("mv", "sad", "ok") + (("sub_mv", "sub_sad", "sub_ok") if vbs else ())
    assert set(got) == set(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    fallback = ~got["ok"].numpy()
    assert fallback.any() and (got["mv"].numpy()[fallback] == g[fallback]).all()
    if fme and vbs:
        pf, pq = K.pred_fetch_fme_vbs(got["mv"], got["sub_mv"], planes, BS)
        np.testing.assert_array_equal(TB.blockify(pf, BS).numpy(), np.asarray(ref["pred_full"]))
        np.testing.assert_array_equal(TB.quads_px(pq, BS).numpy(), np.asarray(ref["pred_quads"]))
        assert not got["sub_ok"].numpy().all()
    elif not fme and not vbs:
        pf = K.pred_fetch(got["mv"], planes, BS)
        np.testing.assert_array_equal(TB.blockify(pf, BS).numpy(), np.asarray(ref["pred_full"]))
        assert (TB.blockify(pf, BS).numpy()[3] == 0).all()  # a K8 block far outside predicts zeros, not 128


# ------------------------------------------------- the confirm kernel's wrapper
def _confirm_args(fme, vbs, nref=2, bs=BS, seed=5, content="random"):
    """The confirm's arguments (``fast_confirm``'s and ``FM.confirm``'s):
    random regions, or flat ones for ``content`` "flat" (every SAD ties);
    pixels 0..255, or any int32 for "wide"; MVPs of either sign and parity,
    some far outside the grid (K8); origins on the grid, two of them near
    the int32 bounds, where the origin plus the MVP wraps as torch's int32
    does."""
    rng = np.random.default_rng(seed)
    nb = 24
    P = 4 * nref if fme else nref
    if content == "flat":
        win, cur = np.full((nb, P, bs + 2, bs + 2), 77, np.uint8), np.full((nb, bs, bs), 77, np.int32)
    else:
        win = rng.integers(0, 256, (nb, P, bs + 2, bs + 2)).astype(np.uint8)
        hi = 2**31 if content == "wide" else 256
        cur = rng.integers(-hi if content == "wide" else 0, hi, (nb, bs, bs)).astype(np.int32)
    scale = 2 if fme else 1
    dims = _dims(10 * bs, 12 * bs, fme)
    X = scale * bs * rng.integers(0, 4, nb)
    Y = scale * bs * rng.integers(0, 6, nb)
    g = rng.integers(-6, 7, (nb, 3))
    g[:, 2] = rng.integers(0, nref, nb)
    g[3], g[7] = (5000, -4000, 0), (-2 * dims[1], 2 * dims[0], nref - 1)
    X[5], g[5, 0] = 2**31 - 3, 7  # wraps past INT32_MAX
    Y[6], g[6, 1] = -(2**31) + 2, -9
    return (_t(win), _t(cur), _t(g.astype(np.int32)), _t(X.astype(np.int32)), _t(Y.astype(np.int32)), bs, dims, fme,
            vbs)


def _confirm_transcription(win, cur, g, X, Y, bs, dims, fme, vbs) -> dict:
    """csrc/fast_confirm.cu's rule, loop for loop, in Python integers: each
    window's part sums (the four quads and, for an odd bs, the last row and
    column) in wrapping int32; a block's SAD the sum of its window's parts;
    per block or quad the first strict minimum in scan order among the
    candidates K7 leaves valid at its own origin and size."""
    win, cur, g, X, Y = (t.numpy().astype(np.int64) for t in (win, cur, g, X, Y))
    nb, P = win.shape[:2]
    n, s = bs, bs >> 1
    no, scale = (2, 2) if fme else (3, 1)
    nref = P // 4 if fme else P
    DH, DW = dims

    def i32(v):
        return ((int(v) + 2**31) & 0xFFFFFFFF) - 2**31

    def rect(reg, c, oy, ox, r0, r1, c0, c1):
        d = (reg[r0 + oy:r1 + oy, c0 + ox:c1 + ox] - c[r0:r1, c0:c1]) & 0xFFFFFFFF
        return int(np.where(d >= 2**31, (-d) & 0xFFFFFFFF, d).sum())

    def k7(p, D, m):
        return 0 <= p < D - m and 0 <= p + 2 * m < D - m

    rects = [[(r0, r0 + s, c0, c0 + s)] for r0 in (0, s) for c0 in (0, s)]
    if n & 1:
        rects.append([(2 * s, n, 0, n), (0, 2 * s, 2 * s, n)])
    out = {k: [] for k in ("mv", "sad", "ok", "sub_mv", "sub_sad", "sub_ok")}
    for b in range(nb):
        sums = np.array([[sum(rect(win[b, p], cur[b], oy, ox, *r) for r in part) & 0xFFFFFFFF for part in rects]
                         for p in range(P) for oy in range(no) for ox in range(no)])
        gx, gy, gr = (int(v) for v in g[b])
        for q in ([-1, 0, 1, 2, 3] if vbs else [-1]):
            m, qx, qy = (n, 0, 0) if q < 0 else (s, (q & 1) * s, (q >> 1) * s)
            px, py = i32(i32(X[b] + scale * qx) + gx), i32(i32(Y[b] + scale * qy) + gy)
            vx, vy = [k7(px + d - 1, DW, m) for d in range(3)], [k7(py + d - 1, DH, m) for d in range(3)]
            best, bk = INT32_MAX, 0
            for k in range(9 * nref):
                r, c = divmod(k, 9)
                dxi, dyi = divmod(c, 3)
                if not (vx[dxi] and vy[dyi]):
                    continue
                if fme:
                    ty, tx = dyi + 1 - (gy & 1), dxi + 1 - (gx & 1)
                    w = ((4 * r + 2 * (ty & 1) + (tx & 1)) * 2 + (ty >> 1)) * 2 + (tx >> 1)
                else:
                    w = (r * 3 + dyi) * 3 + dxi
                v = i32(sums[w].sum() if q < 0 else sums[w, q])
                if v < best:
                    best, bk = v, k
            found = best != INT32_MAX
            mv = [i32(gx + bk % 9 // 3 - 1), i32(gy + bk % 3 - 1), bk // 9] if found else [gx, gy, gr]
            pre = "" if q < 0 else "sub_"
            out[pre + "mv"].append(mv)
            out[pre + "sad"].append(best)
            out[pre + "ok"].append(found)
    res = {"mv": torch.tensor(out["mv"], dtype=torch.int32), "sad": torch.tensor(out["sad"], dtype=torch.int32),
           "ok": torch.tensor(out["ok"])}
    if vbs:
        res.update(sub_mv=torch.tensor(out["sub_mv"], dtype=torch.int32).reshape(nb, 4, 3),
                   sub_sad=torch.tensor(out["sub_sad"], dtype=torch.int32).reshape(nb, 4),
                   sub_ok=torch.tensor(out["sub_ok"]).reshape(nb, 4))
    return res


def _confirm_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("fme,vbs", [(True, True), (False, False), (False, True), (True, False)])
def test_fast_confirm_wrapper_sends_cpu_tensors_to_the_plain_confirm(fme, vbs):
    """On the CPU the wrapper is ``FM.confirm``, output for output, and
    launches nothing; the tracer counts its blocks on the ``plain`` route."""
    from streamoptima_tpu_torch.profiling import tracer

    args = _confirm_args(fme, vbs)
    n0 = K.fast_confirm.launches
    tracer.reset()
    tracer.enable()
    try:
        got = K.fast_confirm(*args)
    finally:
        tracer.disable()
    assert tracer.snapshot()["confirm_blocks"] == {"plain": 24}
    tracer.reset()
    assert K.fast_confirm.launches == n0
    _confirm_equal(got, FM.confirm(*args))
    assert K.fast_confirm_plain is FM.confirm


@pytest.mark.parametrize("fme,vbs,nref,bs,content", [
    (True, True, 1, 16, "random"), (True, True, 2, 8, "random"), (False, True, 4, 8, "random"),
    (False, False, 1, 16, "random"), (True, False, 4, 16, "random"), (True, True, 2, 16, "flat"),
    (False, True, 1, 16, "flat"), (True, True, 1, 16, "wide"), (False, True, 2, 8, "wide"),
    (True, True, 2, 5, "random"), (False, True, 1, 7, "wide"), (False, False, 2, 5, "random"),
    (True, False, 1, 1, "random")])
def test_fast_confirm_kernel_rule_matches_the_plain_confirm(fme, vbs, nref, bs, content):
    """A transcription of the kernel's rule (part sums per window, the block
    as their sum, a scan-order pick per block and quad) equals ``FM.confirm``
    on every output: whole-pel and FME, with and without VBS, nref 1 to 4,
    even and odd bs, flat regions (every SAD ties), int32 pixels of any
    value, MVPs far outside (K8) and origins whose sums wrap."""
    args = _confirm_args(fme, vbs, nref, bs, seed=nref * 31 + bs, content=content)
    want = FM.confirm(*args)
    _confirm_equal(_confirm_transcription(*args), want)
    assert not want["ok"].all()
    assert want["ok"].any()
    if content == "flat":
        assert (want["sad"][want["ok"]] == 0).all()


def test_fast_confirm_wrapper_refuses_what_the_kernel_does_not_take():
    win, cur, g, X, Y, bs, dims, fme, vbs = _confirm_args(True, True)
    call = lambda **kw: K.fast_confirm(*({"win": win, "cur": cur, "g": g, "X": X, "Y": Y} | kw).values(), bs, dims,
                                       fme, vbs)
    with pytest.raises(TypeError):
        call(win=win.to(torch.int16))
    with pytest.raises(ValueError, match="cur_blocks"):
        call(cur=cur.to(torch.int64))
    with pytest.raises(ValueError, match="g must"):
        call(g=g.to(torch.int64))
    with pytest.raises(ValueError, match="X must"):
        call(X=X[:-1].contiguous())
    with pytest.raises(ValueError, match="regions"):
        call(win=win[:, :, 1:].contiguous())
    with pytest.raises(ValueError, match="parity planes"):
        call(win=win[:, :3].contiguous())  # FME wants 4 * nref planes
    with pytest.raises(ValueError, match="cur_blocks"):
        call(cur=cur[:-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(win=win.transpose(2, 3))
    with pytest.raises(ValueError, match="cur_blocks"):
        call(cur=cur.transpose(1, 2))
    with pytest.raises(ValueError, match="g must"):
        call(g=g.t().contiguous().t())
    with pytest.raises(ValueError, match="one device"):
        call(Y=Y.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        call(cur=cur.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.fast_confirm(win.to("meta"), cur.to("meta"), g.to("meta"), X.to("meta"), Y.to("meta"), bs, dims, fme, vbs)


# ------------------------------------------------------------ the chain pass
def _jax_pass_inputs(cur, refs, bx, by, fme, k):
    """``me_pallas.rowscan_pass``'s arguments, as tests/test_fastme.py:169-226."""
    h, w = cur.shape
    nbr, nbc = h // BS, w // BS
    planes = JFM.plane_stack(jnp.asarray(refs), fme, jnp)
    cur_b = jnp.asarray(cur.astype(np.int32)).reshape(nbr, BS, nbc, BS).swapaxes(1, 2).reshape(-1, BS, BS)
    curT = cur_b.reshape(nbr, nbc, BS, BS).swapaxes(0, 1)
    xsT = jnp.asarray(bx).reshape(nbr, nbc).swapaxes(0, 1).astype(jnp.int32)
    ys = jnp.asarray(by).reshape(nbr, nbc)[:, 0].astype(jnp.int32)
    Lp = -(-nbc // k)
    padc = Lp * k - nbc
    curK = jnp.concatenate([curT, jnp.zeros((padc, nbr, BS, BS), curT.dtype)])
    xsK = jnp.concatenate([xsT, jnp.broadcast_to(xsT[-1:], (padc, nbr))]).reshape(Lp, k, nbr)
    wr, wc = JFM.wide_window_spec(BS, k, fme)
    cmK = jnp.asarray((np.arange(Lp * k) < nbc).reshape(Lp, k).astype(np.int32))
    curKk = curK.reshape(Lp, k, nbr, BS, BS).astype(jnp.int16)
    if fme:
        curKk = jnp.repeat(curKk, 4, axis=-1)
    prep = MP.pass_prep(planes, wr, wc, fme)
    return prep, curKk, xsK[:, 0, :].reshape(-1), xsK, ys, cmK


@pytest.mark.parametrize("seeds_kind", ["zero", "random"])
@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_rowscan_pass_plain_matches_pallas_kernel(k, fme, seeds_kind):
    """One pass against ``me_pallas.rowscan_pass`` in interpret mode at every
    lookahead (the port has none: any lookahead gives the same MVs), from
    zero seeds and from random seeds with negative odd MVs and K8 fallbacks."""
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme, seed=9)
    h, w = cur.shape
    seeds = np.zeros((nbr, 3), np.int32) if seeds_kind == "zero" else g.reshape(nbr, nbc, 3)[:, 0].copy()
    if seeds_kind == "random":
        seeds[0] = (-3, -5, 1)
    prep, curKk, xs0, xsK, ys, cmK = _jax_pass_inputs(cur, refs, bx, by, fme, k)
    mK, _ = MP.rowscan_pass(prep, curKk, xs0, xsK, ys, cmK, jnp.asarray(seeds), BS, k, _dims(h, w, fme),
                            interpret=True)
    ref = np.asarray(mK).reshape(-1, nbr, 3)[:nbc]  # (L, S, 3)
    before = K.rowscan_pass.launches
    got = K.rowscan_pass(_t(cur), _planes(refs, fme), _t(seeds), BS, fme)
    assert K.rowscan_pass.launches == before  # CPU: the plain version, no launch
    assert got.dtype == torch.int32 and got.shape == (nbr, nbc, 3)
    np.testing.assert_array_equal(got.numpy().swapaxes(0, 1), ref)
    if seeds_kind == "random":
        assert (got.numpy()[:, :, :2] < 0).any() and (got.numpy()[:, :, :2] % 2 != 0).any()


@pytest.mark.parametrize("fme", [False, True])
def test_rowscan_pass_plain_is_forward_substitution(fme):
    """Each row of a pass is the sequential chain from its seed: column j's
    MV is the one-block search around column j - 1's."""
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme, seed=12, nref=1)
    h, w = cur.shape
    scale = 2 if fme else 1
    dims = _dims(h, w, fme)
    planes = _planes(refs, fme)
    seeds = _t(g.reshape(nbr, nbc, 3)[:, 0].copy())
    got = K.rowscan_pass(_t(cur), planes, seeds, BS, fme)
    cur_b = TB.blockify(_t(cur), BS).to(torch.int32)
    prev = torch.cat([seeds[:, None], got[:, :-1]], dim=1).reshape(-1, 3)
    by0, bx0 = FM.region_base(prev, _t(by), _t(bx), fme)
    win = K.window_fetch(planes.reshape(-1, h, w), by0, bx0, BS + 2)
    mv, _, _ = FM.pick9(FM.sad9(win, cur_b, prev, BS, fme),
                        FM.cand_valid(prev, _t(scale * bx), _t(scale * by), BS, dims), prev)
    np.testing.assert_array_equal(mv.numpy(), got.reshape(-1, 3).numpy())


def test_rowscan_pass_wrapper_refuses_what_the_kernel_does_not_take():
    cur = torch.zeros((48, 64), dtype=torch.uint8)
    refs = torch.zeros((1, 48, 64), dtype=torch.uint8)
    planes = torch.zeros((1, 4, 48, 64), dtype=torch.uint8)
    seeds = torch.zeros((3, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="planes"):
        K.rowscan_pass(cur, refs, seeds, 16, True)  # FME wants the four parity planes
    with pytest.raises(ValueError, match="planes"):
        K.rowscan_pass(cur, planes[:, :, :32], seeds, 16, True)
    with pytest.raises(ValueError, match="seeds"):
        K.rowscan_pass(cur, refs, seeds[:2], 16, False)
    with pytest.raises(ValueError, match="seeds"):
        K.rowscan_pass(cur, refs, seeds.to(torch.int64), 16, False)
    with pytest.raises(TypeError):
        K.rowscan_pass(cur.to(torch.int32), refs, seeds, 16, False)
    with pytest.raises(ValueError, match="multiple"):
        K.rowscan_pass(cur[:40].contiguous(), refs[:, :40].contiguous(), seeds, 16, False)


# -------------------------------------------------------- the whole search
FAST_KW = {"whole_pel": {}, "vbs_fme": {"vbs_enable": True, "fme_enable": True}}


@pytest.mark.parametrize("mode", ["whole_pel", "vbs_fme"])
def test_search_matches_sequential_oracle_cold_and_warm(mode):
    """The port's row-segmented solve equals the literal raster-sequential
    chain (``JaxCodec(fast_me_chain="scan")``) on one inter frame, and a
    start from wild guesses reaches the same fixpoint as a cold start."""
    h, w = 64, 96
    kw = dict(height=h, width=w, frames=2, search_range=16, qp=4, intra_dur=8, lam=0.015, fast_me=True,
              **FAST_KW[mode])
    clip = synthetic_clip(h, w, 2, seed=7)
    clip[1, 20:40, 30:70] = np.random.default_rng(7).integers(0, 256, (20, 40))  # breaks the smooth motion field
    oracle = JaxCodec(JaxCodecConfig(fast_me_chain="scan", **kw), clip).encode(package=False)["per_frame"][1]
    tc = TorchCodec(CodecConfig(**kw), clip, device="cpu")
    frame = tc.encode(package=False)["per_frame"][1]
    np.testing.assert_array_equal(frame["mv"].numpy(), np.asarray(oracle["mv"]))
    np.testing.assert_array_equal(frame["sub_mv"].numpy(), np.asarray(oracle["sub_mv"]))
    np.testing.assert_array_equal(frame["recon"].numpy(), np.asarray(oracle["recon"]))
    assert len(np.unique(frame["mv"].numpy()[:, :2], axis=0)) > 1  # a chain that moves, not one MV everywhere

    cur = _t(clip[1])
    cur_b = TB.blockify(cur, BS).to(torch.int32)
    ref0 = tc.encode(package=False)["per_frame"][0]["recon"]
    planes = tc.motion.planes([ref0], False) if tc.vbs else ref0[None]
    cold, _ = tc.motion.fast_search(cur, cur_b, planes, None)
    rng = np.random.default_rng(8)
    wild = np.concatenate([rng.integers(-9, 10, (tc.nb, 2)), np.zeros((tc.nb, 1), int)], 1).astype(np.int32)
    warm, _ = tc.motion.fast_search(cur, cur_b, planes, _t(wild))
    again, passes = tc.motion.fast_search(cur, cur_b, planes, cold["g_next"])
    assert set(cold) == set(warm)
    for k in cold:
        np.testing.assert_array_equal(cold[k].numpy(), warm[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(cold[k].numpy(), again[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(cold["mv"].numpy(), frame["mv"].numpy())
    # the MVPs are the MVs shifted one block: the confirm re-derived the chain
    np.testing.assert_array_equal(cold["g_next"][1:].numpy(), cold["mv"][:-1].numpy())
    assert passes == 1  # started at the fixpoint: one pass confirms it
