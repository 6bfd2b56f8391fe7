"""PyTorch port, the ``intra_search`` wrapper (mode-0 intra search and
residuals) on the CPU: parity with the JAX package, and the kernel's rule.

On the CPU ``kernels.intra_search`` runs its plain version
(``intra.intra_search_mode0`` then ``intra.intra_residuals_mode0``).  Every
case feeds the same seeded frame to it and to the JAX package's
``intra_search_mode0`` and ``intra_residuals_mode0`` (jnp, ``sr=`` given, as
``JaxCodec._intra_step`` calls them; intra mode 1 on the transposed frame,
the residuals transposed back): bs 8 and 16, VBS on and off, sr 1, 8 and
16, both intra modes, and the frame's canvas or a wider one (the compat
engine's 288 x 352 around a smaller frame), on smooth, noise, flat (every
shift ties), 0/255 checkerboard and ramp frames.  ``_kernel_rule``
transcribes ``csrc/intra_search.cu`` in numpy: per block the staged columns
left of it, one per-pixel read rule for the block and its quads, the
half-row sums, the minimum of (SAD, (|dx| << 8) | (sr - dx)) over the
shifts, the border column, and the residuals in both layouts; it is held to
the plain version on the same frames.  Last, both engines route every intra
frame through the wrapper, and the compat engine still equals the JAX
``CompatCodec``.  The arithmetic is integer: every tolerance is exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu.compat_engine import CompatCodec as JaxCompatCodec
from streamoptima_tpu.config import CodecConfig as JaxCodecConfig
from streamoptima_tpu.core import intra as JI
from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch.compat_engine import CompatCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.engine import TorchCodec, frame_arrays_of

torch.set_num_threads(1)
KEYS = ("mv", "sad", "sub_mv", "sub_sad")


@functools.lru_cache(maxsize=None)
def _frame(kind: str, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng([h, w, len(kind)])
    if kind == "smooth":
        return synthetic_clip(h, w, 1, seed=h + w)[0]
    if kind == "noise":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w), 128, np.uint8)
    if kind == "checker":
        return np.where(np.indices((h, w)).sum(0) % 2, 255, 0).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return ((3 * xx + yy) % 256).astype(np.uint8)  # ramp


def _port(frame, bs, sr, canvas, vbs, transpose):
    s, rf, rq = K.intra_search(torch.from_numpy(frame), bs, sr, canvas, vbs, transpose=transpose)
    out = {k: s[k].numpy() for k in KEYS if k in s}
    out["res_full"] = rf.numpy()
    out["res_quads"] = None if rq is None else rq.numpy()
    return out


def _jax(frame, bs, sr, canvas, vbs, transpose):
    """JaxCodec._intra_step's search and residuals."""
    work = jnp.asarray(frame).astype(jnp.int32)
    if transpose:
        work = work.T
    s = JI.intra_search_mode0(work, bs, sr, canvas, vbs, jnp)
    rf, rq = JI.intra_residuals_mode0(work, s["mv"], s.get("sub_mv"), bs, jnp, sr=sr)
    if transpose:
        rf = rf.swapaxes(-1, -2)
        rq = None if rq is None else rq.swapaxes(-1, -2)
    out = {k: np.asarray(s[k]) for k in KEYS if k in s}
    out["res_full"] = np.asarray(rf)
    out["res_quads"] = None if rq is None else np.asarray(rq)
    return out


def _assert_same(got: dict, ref: dict, what: str) -> None:
    assert set(got) == set(ref), what
    for k in ref:
        if ref[k] is None:
            assert got[k] is None, f"{what} {k}"
            continue
        assert got[k].dtype == np.int32 and got[k].shape == ref[k].shape, f"{what} {k}"
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what} {k}")


KINDS = ["smooth", "noise", "flat", "checker", "ramp"]
GRID = [(bs, sr, vbs) for bs in (8, 16) for sr in (1, 8, 16) for vbs in (False, True)]


#: (transpose, canvas beyond the searched frame): mode 0 on the frame's canvas and on one 40 columns wider
#: (the compat engine's canvas around a smaller frame); mode 1 on its own (the frame's height)
CASES = ((False, 0), (False, 40), (True, 0))


@pytest.mark.parametrize("bs,sr,vbs", GRID)
def test_intra_search_on_cpu_matches_jax_package(bs, sr, vbs):
    h, w = 3 * bs, 4 * bs
    for kind in KINDS:
        frame = _frame(kind, h, w)
        for transpose, extra in CASES:
            canvas = (h if transpose else w) + extra
            _assert_same(_port(frame, bs, sr, canvas, vbs, transpose), _jax(frame, bs, sr, canvas, vbs, transpose),
                         f"{kind} transpose={transpose} canvas={canvas}")


def _kernel_rule(frame, bs, sr, canvas, vbs, transpose):
    """csrc/intra_search.cu per CTA, in numpy."""
    work = frame.T if transpose else frame
    hh, ww = work.shape
    nbr, nbc, s = hh // bs, ww // bs, bs // 2
    nb = nbr * nbc
    out = {"mv": np.zeros(nb, np.int32), "sad": np.zeros(nb, np.int32)}
    if vbs:
        out.update(sub_mv=np.zeros((nb, 4), np.int32), sub_sad=np.zeros((nb, 4), np.int32))
    rf = np.zeros((nb, bs * bs), np.int32)
    rq = np.zeros((nb, 4 * s * s), np.int32)
    i_, j_ = np.indices((bs, bs))
    for b in range(nb):
        y0, x0 = (b // nbc) * bs, (b % nbc) * bs
        cur = work[y0:y0 + bs, x0:x0 + bs].astype(np.int64)
        ctx = np.full((bs, sr), 128, np.int64)  # frame columns x0 - sr .. x0 - 1, 128 left of the frame
        for m in range(sr):
            if x0 - sr + m >= 0:
                ctx[:, m] = work[y0:y0 + bs, x0 - sr + m]

        def read(mv_px):  # the per-pixel rule: left of the frontier at a shift in [-sr, 0], else 128
            ok = (mv_px >= -sr) & (mv_px <= 0) & (j_ + mv_px < 0)
            return np.where(ok, ctx[i_, np.clip(sr + j_ + mv_px, 0, max(sr - 1, 0))] if sr else 128, 128)

        nd = sr + 1
        part = np.zeros((nd, bs, 2), np.int64)
        for d in range(nd):
            diff = np.abs(cur - read(np.full((bs, bs), d - sr)))
            part[d, :, 0] = diff[:, :s].sum(1)
            part[d, :, 1] = diff[:, s:].sum(1)
        units = 5 if vbs else 1
        sad = np.zeros((nd, 5), np.int64)
        sad[:, 0] = part.sum((1, 2))
        for u in range(1, units):
            dr, dc = (u - 1) >> 1, (u - 1) & 1
            sad[:, u] = part[:, dr * s:dr * s + s, dc].sum(1)
        won = []
        for u in range(units):
            n, xu = (bs, x0) if u == 0 else (s, x0 + ((u - 1) & 1) * s)
            keys = []
            for dx in range(-sr, sr + 1):
                valid = xu + dx >= 0 and xu + dx + n <= canvas
                sd = int(sad[dx + sr if dx < 0 else sr, u]) if valid else 2**31 - 1
                keys.append((sd << 32) | (abs(dx) << 8) | (sr - dx))
            best = min(keys)
            m, sv = sr - (best & 0xFF), best >> 32
            if u == 0 and x0 == 0:
                m, sv = -1, int(sad[sr, 0])
            won.append(m)
            if u == 0:
                out["mv"][b], out["sad"][b] = m, sv
            else:
                out["sub_mv"][b, u - 1], out["sub_sad"][b, u - 1] = m, sv
        full = cur - read(np.full((bs, bs), won[0]))
        rf[b] = (full.T if transpose else full).reshape(-1)  # thread k writes word k: (j, i) under transpose
        if vbs:
            q = 2 * (i_ >= s) + (j_ >= s)
            quad = cur - read(np.asarray(won[1:])[q])
            li, lj = i_ % s, j_ % s
            idx = q * s * s + (lj * s + li if transpose else li * s + lj)
            rq[b, idx.reshape(-1)] = quad.reshape(-1)
    res = {k: v.reshape((nbr, nbc) + v.shape[1:]) for k, v in out.items()}
    res["res_full"] = rf.reshape(nb, bs, bs)
    res["res_quads"] = rq.reshape(nb, 4, s, s) if vbs else None
    return res


@pytest.mark.parametrize("bs,sr,vbs", GRID)
def test_kernel_rule_matches_plain(bs, sr, vbs):
    h, w = 3 * bs, 4 * bs
    for kind in KINDS:
        frame = _frame(kind, h, w)
        for transpose, extra in CASES:
            canvas = (h if transpose else w) + extra
            _assert_same(_kernel_rule(frame, bs, sr, canvas, vbs, transpose),
                         _port(frame, bs, sr, canvas, vbs, transpose), f"{kind} transpose={transpose} canvas={canvas}")


@pytest.mark.parametrize("vbs", [False, True])
def test_kernel_rule_at_a_large_range_and_one_block_column(vbs):
    """sr beyond the frame (every shift left of column 0 reads 128) and a
    frame one block wide (only the border column)."""
    for h, w, sr in ((32, 48, 40), (48, 16, 8)):
        frame = _frame("noise", h, w)
        for transpose in (False, True):
            canvas = h if transpose else w
            _assert_same(_kernel_rule(frame, 16, sr, canvas, vbs, transpose), _port(frame, 16, sr, canvas, vbs,
                                                                                     transpose), f"{h}x{w} sr={sr}")


def test_intra_search_refuses_what_the_kernel_does_not_take_and_launches_nothing_on_cpu():
    frame = torch.from_numpy(_frame("noise", 32, 48))
    with pytest.raises(TypeError, match="cur"):
        K.intra_search(frame.to(torch.int32), 16, 8, 48, True)
    with pytest.raises(ValueError, match="multiple"):
        K.intra_search(frame[:, :40].contiguous(), 16, 8, 48, True)
    with pytest.raises(ValueError, match="contiguous"):
        K.intra_search(frame.T, 16, 8, 32, True)
    n0 = K.intra_search.launches
    K.intra_search(frame, 16, 8, 48, True)
    K.intra_search(frame, 16, 8, 32, True, transpose=True)
    assert K.intra_search.launches == n0  # CPU tensors: the plain version, no launch


ENGINES = {
    "mode0_sr16_vbs": (TorchCodec, dict(search_range=16, vbs_enable=True, fme_enable=True, fast_me=True)),
    "mode1_sr8_vbs": (TorchCodec, dict(search_range=8, vbs_enable=True, intra_mode=1)),
    "mode0_sr1": (TorchCodec, dict(search_range=1)),
    "compat_sr8_vbs": (CompatCodec, dict(search_range=8, vbs_enable=True, fme_enable=True, engine="compat")),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engines_search_every_intra_frame_through_the_wrapper(name, monkeypatch):
    """Each intra frame of an encode calls ``intra_search`` once (with
    ``transpose`` in intra mode 1, on the compat engine's canvas there), and
    no decode calls it."""
    codec_cls, extra = ENGINES[name]
    cfg = CodecConfig(height=32, width=48, frames=5, qp=4, intra_dur=2, lam=0.015, **extra)
    calls = []

    def recording(cur, bs, sr, canvas_w, vbs, transpose=False):
        calls.append((tuple(cur.shape), canvas_w, transpose))
        return K.intra_search_plain(cur, bs, sr, canvas_w, vbs, transpose)

    monkeypatch.setattr(K, "intra_search", recording)
    codec = codec_cls(cfg, synthetic_clip(32, 48, 5, seed=6), device="cpu")
    pkg = codec.encode() if codec_cls is CompatCodec else codec.encode(package=False)
    fts = pkg["frame_type_seq"]
    canvas = 352 if codec_cls is CompatCodec else (32 if cfg.intra_mode == 1 else 48)
    assert fts == [0, 1, 0, 1, 0] and calls == [((32, 48), canvas, cfg.intra_mode == 1)] * 3
    if codec_cls is CompatCodec:
        codec.decode(fts, pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"])
    else:
        pairs = [frame_arrays_of(o, ft) for o, ft in zip(pkg["per_frame"], fts)]
        codec.decode(fts, [r for _, r in pairs], [[]] * len(fts), [m for m, _ in pairs])
    assert len(calls) == 3


@pytest.mark.parametrize("extra", [dict(search_range=8, vbs_enable=True), dict(search_range=16, vbs_enable=True,
                                                                              fme_enable=True, fast_me=True)],
                         ids=["vbs_sr8", "fast_vbs_fme_sr16"])
def test_compat_engine_equals_jax_compat_codec(extra):
    """Intra frames searched on the 288 x 352 canvas around a 48 x 64 frame:
    the port's compat encode and decode == the JAX CompatCodec's."""
    kw = dict(height=48, width=64, frames=4, qp=4, intra_dur=2, lam=0.015, engine="compat", **extra)
    clip = synthetic_clip(48, 64, 4, seed=9)
    j = JaxCompatCodec(JaxCodecConfig(**kw), clip).encode()
    codec = CompatCodec(CodecConfig(**kw), clip, device="cpu")
    t = codec.encode()
    for k in ("frame_type_seq", "MVS per Frame"):
        assert t[k] == j[k], k
    np.testing.assert_array_equal(t["reconstructed frames"], j["reconstructed frames"])
    for fa, fb in zip(t["approx residual"], j["approx residual"]):
        for (sa, ra), (sb, rb) in zip(fa, fb):
            assert sa == sb
            np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))
    dec = codec.decode(t["frame_type_seq"], t["approx residual"], t["Qp_per_row_per_frame"], t["MVS per Frame"])
    np.testing.assert_array_equal(np.asarray([np.asarray(f) for f in dec]), t["reconstructed frames"])
