"""PyTorch port, the ``intra_recon`` wrapper (mode-0 intra reconstruction)
on the CPU: parity with the JAX package, and the kernel's per-pixel rule.

On the CPU ``kernels.intra_recon`` runs its plain version
(``intra.intra_reconstruct_mode0`` + ``wrap_uint8``).  Every case feeds the
same seeded numpy inputs to it and to the JAX package's
``intra_reconstruct_mode0`` (jnp with ``sr=``: the column-scan select for
sr >= bs, the wavefront below; and the numpy twin where every read lies
inside the frame), wrapped to uint8.  ``_kernel_rule`` transcribes
``csrc/intra_recon.cu`` thread by thread (its pixel mapping, its residual
and output offsets in both layouts, the byte ring) and is held to the plain
version on the same inputs, out-of-range MVs included, so the rule the
kernel implements is checked here before a card runs it.  The arithmetic is
integer: every tolerance is exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamoptima_tpu.core import intra as JI
from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch.compat_engine import CompatCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.engine import TorchCodec, frame_arrays_of

torch.set_num_threads(1)
RING = 256  # the kernel's ring of byte columns


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _inputs(bs: int, sr: int, vbs: bool, nbr: int, nbc: int, mvs: str, dtype=np.int32, seed: int = 0) -> dict:
    """Seeded inputs of an nbr x nbc block frame.  ``mvs``: "inside" (every
    block's and quad's MV in [-sr, 0] and its reads inside the frame, as the
    encoder's search makes them), "any" (uniform in [-sr, 0]: reads left of
    the frame too) or "corrupt" (also outside [-sr, 0], as a damaged stream's
    decode may pass).  Residuals span +-4080 (the 16 x 16 IDCT's reach), so
    the sums wrap; splits are random and may cover column 0."""
    rng = np.random.default_rng([bs, sr, vbs, nbr, nbc, len(mvs), seed])
    s = bs // 2
    nb = nbr * nbc
    x = np.arange(nbc) * bs
    mv = rng.integers(-sr, 1, (nbr, nbc))
    smv = rng.integers(-sr, 1, (nbr, nbc, 4))
    if mvs == "inside":
        mv = np.maximum(mv, -x)
        smv = np.maximum(smv, -(x[None, :, None] + np.array([0, s, 0, s])))
    elif mvs == "corrupt":
        bad = rng.random((nbr, nbc)) < 0.3
        mv = np.where(bad, rng.integers(-sr - 9, 10, (nbr, nbc)), mv)
        badq = rng.random((nbr, nbc, 4)) < 0.3
        smv = np.where(badq, rng.integers(-sr - 9, 10, (nbr, nbc, 4)), smv)
        mv.reshape(-1)[:2] = [2**30, -(2**30)][:nb]
        smv.reshape(-1)[:2] = (-(2**31), 2**31 - 1)
    out = {"rf": rng.integers(-4080, 4081, (nb, bs, bs)).astype(dtype), "mv": mv.reshape(-1).astype(np.int32),
           "rq": None, "split": None, "smv": None}
    if vbs:
        out.update(rq=rng.integers(-4080, 4081, (nb, 4, s, s)).astype(dtype), split=rng.random(nb) < 0.5,
                   smv=smv.reshape(nb, 4).astype(np.int32))
    return out


def _port(a: dict, h: int, w: int, bs: int, sr: int, transpose: bool = False) -> np.ndarray:
    got = K.intra_recon(_t(a["rf"]), _t(a["mv"]), h, w, bs, sr,
                        *(None if a[k] is None else _t(a[k]) for k in ("rq", "split", "smv")), transpose=transpose)
    assert got.dtype == torch.uint8 and got.shape == (h, w)
    return got.numpy()


def _wrap(a) -> np.ndarray:
    return (np.asarray(a).astype(np.int64) & 255).astype(np.uint8)


def _jax(a: dict, h: int, w: int, bs: int, sr: int) -> np.ndarray:
    vbs = a["rq"] is not None
    nb = a["mv"].shape[0]
    split = a["split"] if vbs else np.zeros(nb, bool)
    return _wrap(JI.intra_reconstruct_mode0(jnp.asarray(a["rf"]), jnp.asarray(a["rq"]) if vbs else None,
                                            jnp.asarray(split), jnp.asarray(a["mv"]),
                                            jnp.asarray(a["smv"]) if vbs else None, h, w, bs, jnp, sr=sr))


def _numpy_twin(a: dict, h: int, w: int, bs: int) -> np.ndarray:
    nb = a["mv"].shape[0]
    split = a["split"] if a["rq"] is not None else np.zeros(nb, bool)
    return _wrap(JI.intra_reconstruct_mode0(a["rf"], a["rq"], split, a["mv"], a["smv"], h, w, bs, np))


def _kernel_rule(a: dict, h: int, w: int, bs: int, sr: int, transpose: bool = False) -> np.ndarray:
    """``csrc/intra_recon.cu`` transcribed: CTA ``row`` (vectorised here over
    the rows), thread t (vectorised over the block's pixels), its pixel (i,
    j), its residual and output offsets as the kernel computes them, the
    reconstructed columns kept as bytes in a ring of RING slots, and the
    columns in order."""
    hh, ww = (w, h) if transpose else (h, w)
    nbr, nbc = hh // bs, ww // bs
    s = bs // 2
    vbs = a["rq"] is not None
    rf = torch.from_numpy(a["rf"].astype(np.int32).reshape(-1))  # the wrapper's int32 cast
    mv = torch.from_numpy(a["mv"])
    if vbs:
        rq = torch.from_numpy(a["rq"].astype(np.int32).reshape(-1))
        split, smv = torch.from_numpy(a["split"]), torch.from_numpy(a["smv"].reshape(-1))
    t = torch.arange(bs * bs)
    i = t % bs if transpose else t // bs
    j = t // bs if transpose else t % bs
    q = 2 * (i >= s).long() + (j >= s).long() if vbs else torch.zeros_like(t)
    qoff = ((j % s) * s + i % s if transpose else (i % s) * s + j % s) if vbs else torch.zeros_like(t)
    rows = torch.arange(nbr)[:, None]
    ring = torch.zeros((nbr, bs, RING), dtype=torch.uint8)
    out = torch.zeros(hh * ww, dtype=torch.uint8)
    for c in range(nbc):
        b = rows * nbc + c  # (nbr, 1)
        m = mv[b].expand(nbr, bs * bs)
        r = rf[b * bs * bs + t]
        if vbs:
            sp = split[b].expand(nbr, bs * bs)
            m = torch.where(sp, smv[b * 4 + q], m)
            r = torch.where(sp, rq[(b * 4 + q) * s * s + qoff], r)
        x = c * bs
        src = x + j + m
        ok = (m >= -sr) & (m <= 0) & (j + m < 0) & (src >= 0)
        read = ring[rows, i, (src & (RING - 1)).clamp(0, RING - 1)].to(torch.int32)
        v = (torch.where(ok, read, 128) + r) & 255
        ring[rows, i, (x + j) & (RING - 1)] = v.to(torch.uint8)
        o = (x + j) * nbr * bs + rows * bs + i if transpose else (rows * bs + i) * nbc * bs + x + j
        out[o] = v.to(torch.uint8)
    return out.reshape(h, w).numpy()


def _ranges(bs: int) -> list:
    return [1, bs // 2, bs - 1, bs, bs + 1, 2 * bs + 3]


GRID = [(bs, sr, vbs) for bs in (8, 16) for sr in _ranges(bs) for vbs in (False, True)]


@pytest.mark.parametrize("bs,sr,vbs", GRID)
def test_intra_recon_on_cpu_matches_jax_package(bs, sr, vbs):
    """Port == the JAX package's jnp variant on MVs of every kind (corrupt
    ones included: both keep the fill), and == its numpy twin where every
    read lies inside the frame."""
    nbr, nbc = 3, 5
    h, w = nbr * bs, nbc * bs
    for mvs in ("inside", "any", "corrupt"):
        a = _inputs(bs, sr, vbs, nbr, nbc, mvs)
        got = _port(a, h, w, bs, sr)
        np.testing.assert_array_equal(got, _jax(a, h, w, bs, sr), err_msg=mvs)
        if mvs == "inside":
            np.testing.assert_array_equal(got, _numpy_twin(a, h, w, bs))


@pytest.mark.parametrize("bs,sr,vbs", GRID)
def test_kernel_rule_matches_plain(bs, sr, vbs):
    """The kernel's transcription == the plain version, in both layouts, on
    corrupt MVs (out of range, beyond int16, at the int32 extremes)."""
    nbr, nbc = 3, 5
    h, w = nbr * bs, nbc * bs
    a = _inputs(bs, sr, vbs, nbr, nbc, "corrupt")
    np.testing.assert_array_equal(_kernel_rule(a, h, w, bs, sr), _port(a, h, w, bs, sr))
    # the transposed call: the same blocks numbered in the (w, h) transpose's raster order
    a = _inputs(bs, sr, vbs, nbc, nbr, "corrupt")
    np.testing.assert_array_equal(_kernel_rule(a, h, w, bs, sr, transpose=True), _port(a, h, w, bs, sr, True))


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("shape", ["one_row", "one_column", "one_block"])
@pytest.mark.parametrize("vbs", [False, True])
def test_intra_recon_edge_shapes(bs, shape, vbs):
    nbr, nbc = {"one_row": (1, 6), "one_column": (4, 1), "one_block": (1, 1)}[shape]
    h, w = nbr * bs, nbc * bs
    for sr in (bs // 2, bs + 1):
        a = _inputs(bs, sr, vbs, nbr, nbc, "corrupt")
        got = _port(a, h, w, bs, sr)
        np.testing.assert_array_equal(got, _jax(a, h, w, bs, sr))
        np.testing.assert_array_equal(got, _kernel_rule(a, h, w, bs, sr))
        t = _inputs(bs, sr, vbs, nbc, nbr, "corrupt")
        np.testing.assert_array_equal(_port(t, h, w, bs, sr, True), _kernel_rule(t, h, w, bs, sr, True))


@pytest.mark.parametrize("sr", [8, 16])
@pytest.mark.parametrize("vbs", [False, True])
def test_intra_recon_takes_int64_residuals(sr, vbs):
    """The compat engine's int64 residuals, some beyond int32: the plain
    version (int32 band at sr >= bs, int64 below), the kernel's int32 cast
    and the exact int64 numpy twin agree after the wrap."""
    bs, nbr, nbc = 16, 2, 4
    h, w = nbr * bs, nbc * bs
    a = dict(_inputs(bs, sr, vbs, nbr, nbc, "inside", np.int64))
    rng = np.random.default_rng(sr)
    a["rf"] = a["rf"] + rng.integers(-3, 4, a["rf"].shape) * 2**32 + rng.integers(-1, 2, a["rf"].shape) * 2**31
    got = _port(a, h, w, bs, sr)
    np.testing.assert_array_equal(got, _numpy_twin(a, h, w, bs))
    np.testing.assert_array_equal(got, _kernel_rule(a, h, w, bs, sr))


def test_intra_recon_transposed_matches_the_engine_call():
    """``transpose=True`` is intra mode 1's call: mode 0 on the transposed
    residuals of the (w, h) transpose, the result transposed back."""
    bs, sr, h, w = 16, 16, 48, 80
    a = _inputs(bs, sr, True, w // bs, h // bs, "any")
    want = _jax({**a, "rf": a["rf"].transpose(0, 2, 1), "rq": a["rq"].transpose(0, 1, 3, 2)}, w, h, bs, sr).T
    np.testing.assert_array_equal(_port(a, h, w, bs, sr, True), want)


def test_intra_recon_refuses_what_the_kernel_does_not_take_and_launches_nothing_on_cpu():
    a = _inputs(16, 16, True, 2, 3, "any")
    rf, mv, rq, sp, smv = (_t(a[k]) for k in ("rf", "mv", "rq", "split", "smv"))
    with pytest.raises(ValueError, match="multiple"):
        K.intra_recon(rf, mv, 40, 48, 16, 16)
    with pytest.raises(ValueError, match="residual_full"):
        K.intra_recon(rf[:5], mv, 32, 48, 16, 16)
    with pytest.raises(TypeError, match="mv"):
        K.intra_recon(rf, mv.long(), 32, 48, 16, 16)
    with pytest.raises(TypeError, match="residual_full"):
        K.intra_recon(rf.to(torch.int16), mv, 32, 48, 16, 16)
    with pytest.raises(ValueError, match="sub_mv"):
        K.intra_recon(rf, mv, 32, 48, 16, 16, rq, sp, None)
    with pytest.raises(TypeError, match="split"):
        K.intra_recon(rf, mv, 32, 48, 16, 16, rq, sp.to(torch.uint8), smv)
    n0 = K.intra_recon.launches
    K.intra_recon(rf, mv, 32, 48, 16, 16, rq, sp, smv)
    K.intra_recon(rf, mv, 48, 32, 16, 16, rq, sp, smv, transpose=True)
    assert K.intra_recon.launches == n0  # CPU tensors: the plain version, no launch


ENGINES = {
    "mode0_sr16_vbs": (TorchCodec, dict(search_range=16, vbs_enable=True, fme_enable=True, fast_me=True)),
    "mode1_sr16_vbs": (TorchCodec, dict(search_range=16, vbs_enable=True, intra_mode=1)),
    "mode0_sr4": (TorchCodec, dict(search_range=4)),
    "compat_sr8_vbs": (CompatCodec, dict(search_range=8, vbs_enable=True, fme_enable=True, engine="compat")),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engines_reconstruct_every_intra_frame_through_the_wrapper(name, monkeypatch):
    """Each intra frame of an encode and of a decode calls ``intra_recon``
    once, and the wrapped call is the plain reconstruction: the encode's
    recon equals a call of the plain version on the same inputs."""
    codec_cls, extra = ENGINES[name]
    cfg = CodecConfig(height=32, width=48, frames=5, qp=4, intra_dur=2, lam=0.015, **extra)
    clip = synthetic_clip(32, 48, 5, seed=4)
    calls = []

    def recording(*args, **kw):
        out = K.intra_recon_plain(*args, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(K, "intra_recon", recording)
    codec = codec_cls(cfg, clip, device="cpu")
    pkg = codec.encode() if codec_cls is CompatCodec else codec.encode(package=False)
    fts = pkg["frame_type_seq"]
    assert fts == [0, 1, 0, 1, 0] and len(calls) == 3
    recon = np.asarray(pkg["reconstructed frames"])
    for k, f in enumerate((0, 2, 4)):
        np.testing.assert_array_equal(calls[k].numpy(), recon[f])
    if codec_cls is CompatCodec:
        dec = codec.decode(fts, pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"])
    else:
        pairs = [frame_arrays_of(o, ft) for o, ft in zip(pkg["per_frame"], fts)]
        dec = codec.decode(fts, [r for _, r in pairs], [[]] * len(fts), [m for m, _ in pairs])
    assert len(calls) == 6
    np.testing.assert_array_equal(torch.stack(list(dec)).numpy(), recon)
