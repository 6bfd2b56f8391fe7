"""PyTorch port, the fast-ME slice as a whole on the CPU: parity with JaxCodec.

``benchmarks/sweep.py``'s ``720p_fast_me_vbs_fme`` and ``720p_fast_me``
settings (sr=16, qp=4, lam=0.015, one reference) at 64x96, 6 frames with an
intra frame every 4, and at 128x192, 3 frames, where more than a corner of
the frame passes the K7 bounds and the chain runs through real searches: the
port's encode is bit-identical to the JAX engine's
(MVs, splits, sub-MVs, both coefficient sets, sizes, row bits,
reconstructions, text bitstream bytes), and each engine decodes the other's
stream.  On the CPU the port's kernels take their plain PyTorch versions.
Integer outputs are compared exactly; PSNR and MAE (float32, reductions in
another order) to 1e-4.
"""
import numpy as np
import pytest
import torch

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu import jax_engine as JE
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch import engine as TE
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.engine import TorchCodec, check_slice
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

torch.set_num_threads(1)
BASE = dict(height=64, width=96, frames=6, search_range=16, qp=4, intra_dur=4, lam=0.015, fast_me=True)
VBS_FME = dict(vbs_enable=True, fme_enable=True)
LARGER = dict(BASE, height=128, width=192, frames=3)
MODES = {"fast_vbs_fme": dict(BASE, **VBS_FME), "fast": BASE,
         "fast_vbs_fme_128x192": dict(LARGER, **VBS_FME), "fast_128x192": LARGER}


def _clip(h, w, frames):
    """A smooth texture moving one pixel per frame with a patch of noise in
    every inter frame, so the chain leaves zero, splits occur and a few
    winners are not the smooth motion."""
    fine = synthetic_clip(h + 16, w + 16, 1, seed=21)[0]
    clip = np.stack([fine[i:i + h, i:i + w] for i in range(frames)])
    rng = np.random.default_rng(21)
    for i in range(1, frames):
        clip[i, 18:34, 40:72] = rng.integers(0, 256, (16, 32))
    return clip


@pytest.fixture(scope="module", params=list(MODES))
def encoded(request, tmp_path_factory):
    """Both engines' encodes and text bitstreams of one clip, one mode."""
    kw = MODES[request.param]
    clip = _clip(kw["height"], kw["width"], kw["frames"])
    d = tmp_path_factory.mktemp(request.param)
    jv = JaxVideoCodec(JaxCodecConfig(**kw), clip)
    jpkg = jv.encode(compute_ssim=False, package=False)
    jv.transmit_bitstream(d / "jmv.txt", d / "jres.txt")
    launches = (K.rowscan_pass.launches, K.window_fetch.launches)
    tv = VideoCodec(CodecConfig(**kw), clip, device="cpu")
    tpkg = tv.encode(package=False)
    tv.transmit_bitstream(d / "tmv.txt", d / "tres.txt")
    assert (K.rowscan_pass.launches, K.window_fetch.launches) == launches  # CPU: plain versions, no launch
    return {"kw": kw, "vbs": "vbs_enable" in kw, "clip": clip, "dir": d, "jpkg": jpkg, "tpkg": tpkg}


@pytest.mark.parametrize("key", ["mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "row_bits", "recon"])
def test_fast_me_per_frame_outputs_bit_identical(encoded, key):
    for i, (a, b) in enumerate(zip(encoded["tpkg"]["per_frame"], encoded["jpkg"]["per_frame"])):
        np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=f"frame {i} {key}")


def test_fast_me_package_metrics_passes_and_real_chain_state(encoded):
    t, j = encoded["tpkg"], encoded["jpkg"]
    ftypes = [0, 1, 1, 1, 0, 1][:encoded["kw"]["frames"]]
    assert t["frame_type_seq"] == j["frame_type_seq"] == ftypes
    assert t["residual size per frame"] == j["residual size per frame"]
    np.testing.assert_allclose(t["PSNR per frame"], j["PSNR per frame"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["MAE per Frame"], j["MAE per Frame"], rtol=0, atol=1e-4)
    pf = t["per_frame"]
    assert all("g_next" not in o for o in pf)  # the warm-start carry stays inside the engine
    # one count per inter frame, each within the solve's bound of S + 2 passes
    passes = t["fast_me_passes"]
    inter = [o for o, ft in zip(pf, ftypes) if ft == 1]
    assert len(passes) == len(inter) and all(1 <= p <= encoded["kw"]["height"] // 16 + 2 for p in passes)
    assert passes[0] >= 2  # a cold start cannot confirm zero seeds on a moving clip in one pass
    mvs = np.concatenate([o["mv"].numpy() for o in inter])
    assert (mvs[:, :2] != 0).any()  # the chain left zero
    if encoded["kw"]["height"] > 64:
        assert len(np.unique(mvs[:, :2], axis=0)) > 2  # and went through more than one motion
    if encoded["vbs"]:
        assert sum(int(o["split"].sum()) for o in inter) > 0
        assert any(bool((o["sub_mv"].numpy()[o["split"].numpy()] != o["mv"].numpy()[o["split"].numpy()][:, None])
                        .any()) for o in inter)  # quads that moved off their block's MV
    else:
        assert all(int(o["split"].sum()) == 0 and int(o["sub_mv"].abs().sum()) == 0 for o in pf)


def test_fast_me_text_bitstream_bytes_identical(encoded):
    d = encoded["dir"]
    assert (d / "tmv.txt").read_bytes() == (d / "jmv.txt").read_bytes()
    assert (d / "tres.txt").read_bytes() == (d / "jres.txt").read_bytes()


def test_fast_me_cross_decode_from_files(encoded):
    d, kw = encoded["dir"], encoded["kw"]
    dec = VideoCodec(CodecConfig(**kw), device="cpu").decode_bitstream(d / "jmv.txt", d / "jres.txt")
    np.testing.assert_array_equal(dec, encoded["jpkg"]["reconstructed frames"])
    jdec = JaxVideoCodec(JaxCodecConfig(**kw)).decode_bitstream(d / "tmv.txt", d / "tres.txt")
    np.testing.assert_array_equal(jdec, encoded["tpkg"]["reconstructed frames"])


def test_fast_me_cross_decode_in_memory_per_frame_state(encoded):
    kw, fts = encoded["kw"], encoded["jpkg"]["frame_type_seq"]
    jstate = TE.from_jax_per_frame([{k: np.asarray(v) for k, v in o.items()} for o in encoded["jpkg"]["per_frame"]],
                                   "cpu")
    pairs = [TE.frame_arrays_of(o, ft) for o, ft in zip(jstate, fts)]
    dec = TorchCodec(CodecConfig(**kw), device="cpu").decode(fts, [r for _, r in pairs], [[]] * len(fts),
                                                             [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).numpy(), encoded["jpkg"]["reconstructed frames"])
    tstate = TE.to_numpy_per_frame(encoded["tpkg"]["per_frame"])
    jpairs = [JE.frame_arrays_of(o, ft) for o, ft in zip(tstate, fts)]
    jdec = JE.JaxCodec(JaxCodecConfig(**kw)).decode(fts, [r for _, r in jpairs], [[]] * len(fts),
                                                    [m for m, _ in jpairs])
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in jdec]), encoded["tpkg"]["reconstructed frames"])


def test_fast_me_list_package_roundtrip(encoded, tmp_path):
    """package=True (list interchange) decodes in memory and writes the same
    bytes as the array form; a second encode of one codec repeats itself
    (the warm-start carry and the pass counts start afresh)."""
    v = VideoCodec(CodecConfig(**encoded["kw"]), encoded["clip"], device="cpu")
    pkg = v.encode(compute_ssim=False)
    np.testing.assert_array_equal(v.decode(), pkg["reconstructed frames"])
    v.transmit_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    assert (tmp_path / "mv.txt").read_bytes() == (encoded["dir"] / "jmv.txt").read_bytes()
    assert (tmp_path / "res.txt").read_bytes() == (encoded["dir"] / "jres.txt").read_bytes()
    again = v.encode(compute_ssim=False)
    assert again["fast_me_passes"] == pkg["fast_me_passes"] == encoded["tpkg"]["fast_me_passes"]
    np.testing.assert_array_equal(again["reconstructed frames"], pkg["reconstructed frames"])


@pytest.mark.parametrize("one", ["vbs_enable", "fme_enable"])
def test_fast_me_with_one_of_vbs_fme_refused_by_name(one):
    """Fast ME with exactly one of VBS and FME is ported (its parity with
    JaxCodec is ``tests/test_torch_tools.py``'s), on one device and on the
    mesh, and so is rate control beside it: the mesh encodes it as one
    device does."""
    cfg = CodecConfig(**BASE, **{one: True})
    check_slice(cfg)
    VideoCodec(cfg, device="cpu")
    VideoCodec(cfg, mesh=make_mesh(cfg, devices=["cpu"] * 2))
    rc = CodecConfig(**BASE, **{one: True}, rc_flag=1, target_br="1 mbps", qp_rate_tables=[[1.0] * 12] * 2)
    check_slice(rc)
    clip = _clip(BASE["height"], BASE["width"], BASE["frames"])
    pkg = VideoCodec(rc, clip, mesh=make_mesh(rc, devices=["cpu"] * 2)).encode(compute_ssim=False, package=False)
    single = VideoCodec(rc, clip, device="cpu").encode(compute_ssim=False, package=False)
    assert pkg["Qp_per_row_per_frame"] == single["Qp_per_row_per_frame"] != [[]] * BASE["frames"]
    for a, b in zip(pkg["per_frame"], single["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "recon"):
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kw,feature", [({"parallel_mode": 2}, "parallel_mode"), ({"n_ref_frames": 2}, "n_ref_frames"),
                                        ({"intra_mode": 1}, "intra_mode=1")])
def test_fast_me_outside_the_slice_still_refused_by_name(kw, feature):
    """``feature`` is ported with every fast-ME mode, and so is an ROI map
    beside it, on one device and on the mesh.  The mesh refuses parallel
    modes with ValueError, as the JAX mesh does."""
    for mode in MODES.values():
        roi = np.zeros(mode["height"] * mode["width"] // 256, np.int32)
        TorchCodec(CodecConfig(**mode, **kw), device="cpu")
        cfg = CodecConfig(**mode, **kw, roi_qp_map=roi)
        TorchCodec(cfg, device="cpu")
        if "parallel_mode" in kw:
            with pytest.raises(ValueError, match="parallel_mode"):
                ShardedCodec(cfg, make_mesh(cfg, devices=["cpu"] * 2))
        else:
            ShardedCodec(cfg, make_mesh(cfg, devices=["cpu"] * 2))
    if "parallel_mode" not in kw:  # and on the smallest mode, the mesh encodes as one device does
        mode = MODES["fast"]
        roi = np.arange(mode["height"] * mode["width"] // 256, dtype=np.int32) % 5 - 2
        cfg = CodecConfig(**mode, **kw, roi_qp_map=roi)
        clip = _clip(mode["height"], mode["width"], mode["frames"])
        pkg = ShardedCodec(cfg, make_mesh(cfg, devices=["cpu"] * 2), clip).encode()
        single = TorchCodec(cfg, clip, device="cpu").encode()
        assert pkg["residual size per frame"] == single["residual size per frame"]
        np.testing.assert_array_equal(pkg["reconstructed frames"], single["reconstructed frames"])
