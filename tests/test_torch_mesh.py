"""PyTorch port, the mesh slice: GOP- and row-tile-sharded full search.

The port's ``ShardedCodec`` on an 8-device CPU mesh (``devices=["cpu"] * 8``,
data 2 x tile 4 at 64x64) against the JAX package's ``JaxCodec`` (the
package comparison of ``tests/test_parallel.py``, PSNR to 1e-4: float32 in
another order) and against the port's own ``TorchCodec`` (bit for bit,
PSNR and MAE included).  Below the codec, the plain band versions of the
search and the gather, which the CUDA kernels are held against on the card,
run against the JAX package's band functions on the top, middle and bottom
tiles, and once against ``full_search_pallas`` in interpret mode.  The JAX
``ShardedCodec`` itself runs in two tests only: its XLA:CPU collectives are
what aborts test workers under load (ROADMAP.md).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import smooth_clip, synthetic_clip
from test_parallel import CASES, _compare_packages

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu.core import me as JME
from streamoptima_tpu.core import me_pallas as MP
from streamoptima_tpu.core import pred as JP
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as TME
from streamoptima_tpu_torch.core.pred import gather_predictions
from streamoptima_tpu_torch.engine import TorchCodec
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh
from streamoptima_tpu_torch.parallel.mesh import _halo_band

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8
KW = dict(height=64, width=64, frames=6, block_size=16, search_range=4, qp=3, intra_dur=3)  # test_parallel's
MESH_CASES = CASES[0:5]  # plain, VBS, FME, VBS + FME, nref 3
IDS = [",".join(sorted(c)) or "plain" for c in MESH_CASES]


def _lists(pkg):
    return pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]


def _assert_same_as_torch_codec(a, b):
    """Bit for bit: PSNR and MAE are computed on the same frames alike."""
    for k in ("frame_type_seq", "residual size per frame", "PSNR per frame", "MAE per Frame", "MVS per Frame"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    _compare_packages(a, b)


# ------------------------------------------------------------ the mesh itself
@pytest.mark.parametrize("h", [64, 128, 256])
@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("sr", [4, 16, 31])
def test_make_mesh_factors_as_jax(h, ndev, sr):
    """``test_make_mesh_halo_always_fits``'s grid: the same (data, tile)."""
    from streamoptima_tpu.parallel import make_mesh as jax_make_mesh

    kw = dict(height=h, width=64, frames=2, search_range=sr)
    mesh = make_mesh(CodecConfig(**kw), devices=["cpu"] * ndev)
    assert mesh.devices.shape == jax_make_mesh(JaxCodecConfig(**kw), devices=jax.devices()[:ndev]).devices.shape
    assert mesh.axis_names == ("data", "tile")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_make_mesh_refuses_as_jax():
    from streamoptima_tpu.parallel import make_mesh as jax_make_mesh

    for kw in (dict(intra_mode=1, tile=2), dict(tile=3)):
        tile = kw.pop("tile")
        cfg = dict(height=64, width=64, frames=2, search_range=4, **kw)
        with pytest.raises(ValueError):
            jax_make_mesh(JaxCodecConfig(**cfg), devices=jax.devices()[:8], tile=tile)
        with pytest.raises(ValueError):
            make_mesh(CodecConfig(**cfg), devices=CPU8, tile=tile)


def test_make_mesh_takes_the_cpu_only_when_listed():
    cfg = CodecConfig(**KW)
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh(cfg).devices.flat)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(cfg)
    assert make_mesh(cfg, devices=["cpu"] * 6, tile=2).devices.shape == (3, 2)


def test_halo_band_edges_are_zero():
    tiles = list(torch.arange(64 * 8, dtype=torch.int32).reshape(64, 8).to(torch.uint8).split(16))
    top, mid, bot = (_halo_band(tiles, t, 5, "cpu") for t in (0, 1, 3))
    assert top.shape == mid.shape == (26, 8)
    assert not top[:5].any() and not bot[-5:].any()
    assert torch.equal(mid, torch.cat(tiles)[11:37])
    assert torch.equal(top[5:], torch.cat(tiles)[:21]) and torch.equal(bot[:21], torch.cat(tiles)[43:])


# ------------------------------------- the plain band versions against JAX's
def _band(frames, t, ntile, halo):
    """Tile t's halo band of (nref, h, w) uint8 frames."""
    h_t = frames.shape[1] // ntile
    return torch.stack([_halo_band(list(f.split(h_t)), t, halo, "cpu") for f in frames])


@pytest.mark.parametrize("vbs", [False, True], ids=["blocks", "vbs"])
@pytest.mark.parametrize("fme", [False, True], ids=["whole_pel", "fme"])
@pytest.mark.parametrize("t", [0, 1, 3], ids=["top", "middle", "bottom"])
def test_band_search_matches_jax(t, fme, vbs):
    """``full_search_materialized`` with ``row_offset`` / ``grid_dims`` /
    ``valid_row_offset`` on tile t of a tile-4 split (halo sr + 1, zeros past
    the frame), and the search wrappers' plain versions with the band
    arguments, against the JAX package's numpy band search."""
    rng = np.random.default_rng(t + 4 * fme + 8 * vbs)
    h, w, sr, ntile = 64, 96, 4, 4
    h_t, halo = h // ntile, sr + 1
    frames = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    cur = frames[0, t * h_t:(t + 1) * h_t].copy()
    cur[:, 8:] = rng.integers(0, 256, (h_t, w - 8))  # mostly new content: winners anywhere
    band = _band(torch.from_numpy(frames), t, ntile, halo)
    scale = 2 if fme else 1
    grid_dims = (2 * h - 1, 2 * w - 1) if fme else (h, w)
    if fme:
        jrefs = np.stack([JME.fme_upsample(b, np, wrap_row_pass=True) for b in band.numpy()]).astype(np.int32)
        trefs = TME.grid_of_planes(TME.fme_parity_planes(band, True)).to(torch.int32)
    else:
        jrefs, trefs = band.numpy().astype(np.int32), band.to(torch.int32)
    band_kw = dict(row_offset=scale * halo, grid_dims=grid_dims, valid_row_offset=scale * t * h_t)
    want = JME.full_search_materialized(cur.astype(np.int32), jrefs, scale * sr, 16, 8, scale, fme, vbs, np, **band_kw)
    got = TME.full_search_materialized(torch.from_numpy(cur), trefs, scale * sr, 16, fme=fme, vbs=vbs, **band_kw)
    name = {(False, False): "full_search", (False, True): "full_search_vbs", (True, False): "full_search_fme",
            (True, True): "full_search_fme_vbs"}[fme, vbs]
    inp = TME.fme_parity_planes(band, True) if fme else band
    wrapped = getattr(K, name)(torch.from_numpy(cur), inp, sr, 16, band_row0=halo, g_row0=t * h_t, grid=(h, w))
    for k in ("mv", "sad", "ok") + (("sub_mv", "sub_sad", "sub_ok") if vbs else ()):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(wrapped[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert bool(want["ok"].any()) or (fme and t == ntile - 1)  # FME's margin: the last block row has none


@pytest.mark.parametrize("fme", [False, True], ids=["whole_pel", "fme"])
@pytest.mark.parametrize("t", [0, 1, 3], ids=["top", "middle", "bottom"])
def test_band_gather_matches_jax(t, fme):
    """``gather_predictions`` with ``grid_dims`` / ``origin_row`` on tile t's
    band, blocks and quads, MVs reaching into and past the halo and out of
    the frame, against the JAX package's; and the fetch wrappers' plain
    versions with the band arguments."""
    rng = np.random.default_rng(30 + t + 4 * fme)
    h, w, sr, ntile = 64, 96, 4, 4
    h_t, halo, scale = h // ntile, sr + 1, 2 if fme else 1
    frames = torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(np.uint8))
    band = _band(frames, t, ntile, halo)
    nb = (h_t // 16) * (w // 16)
    reach = scale * 3 * halo
    mv = np.stack([rng.integers(-reach, reach + 1, nb), rng.integers(-reach, reach + 1, nb),
                   rng.integers(0, 2, nb)], 1).astype(np.int32)
    smv = np.stack([rng.integers(-reach, reach + 1, (nb, 4)), rng.integers(-reach, reach + 1, (nb, 4)),
                    rng.integers(0, 2, (nb, 4))], 2).astype(np.int32)
    mv[0, :2] = (3, 4999)
    if fme:
        jgrid = np.stack([JME.fme_upsample(b, np, wrap_row_pass=True) for b in band.numpy()]).astype(np.int32)
        planes = TME.fme_parity_planes(band, True)
        tgrid = TME.grid_of_planes(planes)
    else:
        jgrid, planes, tgrid = band.numpy().astype(np.int32), band, band
    dims = (2 * h - 1, 2 * w - 1) if fme else (h, w)
    origin = scale * (t * h_t - halo)
    bx, by = TME.block_origins(h_t, w, 16, "cpu")
    qx, qy = TME.quad_origins(h_t, w, 16, "cpu")
    by, qy = by + t * h_t, qy + t * h_t
    for m, x, y, n in ((mv, bx, by, 16), (smv.reshape(-1, 3), qx.reshape(-1), qy.reshape(-1), 8)):
        want = JP.gather_predictions(m, jgrid, x.numpy(), y.numpy(), n, fme, np, grid_dims=dims, origin_row=origin)
        got = gather_predictions(torch.from_numpy(m), tgrid, x, y, n, fme=fme, grid_dims=dims, origin_row=origin)
        np.testing.assert_array_equal(got.numpy(), want)
    kw = dict(band_row0=halo, g_row0=t * h_t, grid=(h, w))
    tmv, tsmv = torch.from_numpy(mv), torch.from_numpy(smv)
    pf, pq = (K.pred_fetch_fme_vbs if fme else K.pred_fetch_vbs)(tmv, tsmv, planes, 16, **kw)
    want_f = JP.gather_predictions(mv, jgrid, bx.numpy(), by.numpy(), 16, fme, np, grid_dims=dims, origin_row=origin)
    np.testing.assert_array_equal(pf.numpy(), want_f.reshape(1, 6, 16, 16).swapaxes(1, 2).reshape(16, 96))
    assert torch.equal((K.pred_fetch_fme if fme else K.pred_fetch)(tmv, planes, 16, **kw), pf)
    assert pq.shape == (16, 96)


def test_band_search_matches_pallas_kernel_in_interpret_mode():
    """``full_search_pallas`` with ``read_row0 = 8``, ``g_px0 = 16`` and
    ``grid_dims``: cur is frame rows [16, 32) of a 64x64 frame, the band
    frame rows [8, 48)."""
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (2, 64, 64)).astype(np.uint8)
    cur, band = frames[0, 16:32].copy(), frames[:, 8:48].copy()
    cur[:, 24:] = rng.integers(0, 256, (16, 40))
    want = MP.full_search_pallas(jnp.asarray(cur, jnp.int32), jnp.asarray(band, jnp.int32), 4, 16, 8, False,
                                 interpret=True, read_row0=8, g_px0=16, grid_dims=(64, 64))
    got = K.full_search(torch.from_numpy(cur), torch.from_numpy(band), 4, 16, band_row0=8, g_row0=16, grid=(64, 64))
    for k in ("mv", "sad", "ok", "pred"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_band_wrappers_refuse_a_band_short_of_the_search():
    cur = torch.zeros((16, 64), dtype=torch.uint8)
    band = torch.zeros((1, 26, 64), dtype=torch.uint8)
    planes = torch.zeros((1, 4, 26, 64), dtype=torch.uint8)
    K.full_search(cur, band, 5, 16, band_row0=5, g_row0=16, grid=(64, 64))
    with pytest.raises(ValueError, match="search reads"):
        K.full_search(cur, band, 6, 16, band_row0=5, g_row0=16, grid=(64, 64))
    with pytest.raises(ValueError, match="search reads"):
        K.full_search_fme(cur, planes, 5, 16, band_row0=5, g_row0=16, grid=(64, 64))  # sr + 1 rows below
    with pytest.raises(ValueError, match="refs"):
        K.pred_fetch(torch.zeros((4, 3), dtype=torch.int32), band, 16, band_row0=11, g_row0=0, grid=(64, 64))


# ------------------------------------------------- the mesh against the engines
@pytest.fixture(scope="module", params=MESH_CASES, ids=IDS)
def case(request):
    """One CASE: JaxCodec's, TorchCodec's and the port mesh's encodes of
    test_parallel's clip, and the mesh codec."""
    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    jpkg = JaxCodec(JaxCodecConfig(**KW, **request.param), clip).encode()
    cfg = CodecConfig(**KW, **request.param)
    tpkg = TorchCodec(cfg, clip, device="cpu").encode()
    mesh = make_mesh(cfg, devices=CPU8)
    assert mesh.devices.shape == (2, 4)
    sc = ShardedCodec(cfg, mesh, clip)
    return {"kw": request.param, "clip": clip, "jpkg": jpkg, "tpkg": tpkg, "sc": sc, "pkg": sc.encode()}


def test_mesh_matches_jax_codec(case):
    _compare_packages(case["jpkg"], case["pkg"])


def test_mesh_matches_torch_codec_bit_for_bit(case):
    _assert_same_as_torch_codec(case["pkg"], case["tpkg"])


def test_mesh_decode_equals_recon(case):
    dec = case["sc"].decode(*_lists(case["pkg"]))
    np.testing.assert_array_equal(torch.stack(dec).numpy(), case["pkg"]["reconstructed frames"])


def test_jax_codec_decodes_the_mesh_stream(case):
    dec = JaxCodec(JaxCodecConfig(**KW, **case["kw"])).decode(*_lists(case["pkg"]))
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in dec]), case["pkg"]["reconstructed frames"])


def test_mesh_decodes_the_jax_codec_stream(case):
    dec = case["sc"].decode(*_lists(case["jpkg"]))
    np.testing.assert_array_equal(torch.stack(dec).numpy(), case["jpkg"]["reconstructed frames"])


@pytest.mark.parametrize("tile", [2, 4])
def test_halo_equals_all_gather(tile):
    clip = synthetic_clip(h=64, w=64, frames=5, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=5, search_range=4, qp=4, intra_dur=3, vbs_enable=True,
                      fme_enable=True, lam=0.015, n_ref_frames=2)
    mesh = make_mesh(cfg, devices=CPU8, tile=tile)
    a = ShardedCodec(cfg, mesh, clip, tile_comm="halo").encode()
    b = ShardedCodec(cfg, mesh, clip, tile_comm="all_gather")
    _assert_same_as_torch_codec(a, b.encode())
    np.testing.assert_array_equal(torch.stack(b.decode(*_lists(a))).numpy(), a["reconstructed frames"])


def test_uneven_tail_and_gop_padding():
    """5 frames, intra_dur 3, data 2: the second GOP is short and the last
    batch has one GOP."""
    clip = synthetic_clip(h=64, w=64, frames=5, motion=1)
    kw = dict(height=64, width=64, frames=5, search_range=4, qp=4, intra_dur=3)
    cfg = CodecConfig(**kw)
    sc = ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), clip)
    pkg = sc.encode()
    _compare_packages(JaxCodec(JaxCodecConfig(**kw), clip).encode(), pkg)
    _assert_same_as_torch_codec(pkg, TorchCodec(cfg, clip, device="cpu").encode())
    np.testing.assert_array_equal(torch.stack(sc.decode(*_lists(pkg))).numpy(), pkg["reconstructed frames"])


def test_mesh_fetch_light_and_metrics():
    clip = synthetic_clip(h=64, w=64, frames=4, motion=1)
    cfg = CodecConfig(height=64, width=64, frames=4, search_range=4, qp=4, intra_dur=2)
    sc = ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), clip)
    full, light, metrics = sc.encode(), sc.encode(fetch="light"), sc.encode(fetch="metrics")
    assert "MVS per Frame" not in light and "per_frame" not in light and metrics["reconstructed frames"] is None
    np.testing.assert_array_equal(light["reconstructed frames"], full["reconstructed frames"])
    assert light["PSNR per frame"] == metrics["PSNR per frame"] == full["PSNR per frame"]
    arrays = sc.encode(package=False)
    assert "MVS per Frame" not in arrays and len(arrays["per_frame"]) == 4


def test_mesh_decodes_mvs_past_the_halo_from_whole_frames():
    """A stream whose vertical MVs reach past the sr + 1 halo (a
    single-device fast-ME chain's, ``test_halo_decode_fast_me_large_motion``'s
    clip) decodes from whole frames, bit-exact."""
    h, w, frames, pan = 128, 64, 4, 8
    y = np.arange(h + pan * frames)
    base = np.clip(128 + 100 * np.sin(2 * np.pi * y / 32.0), 0, 255)[:, None]
    tex = np.random.default_rng(3).integers(-8, 9, size=(h + pan * frames, w))
    sheet = np.clip(base + tex, 0, 255).astype(np.uint8)
    clip = np.stack([sheet[i * pan:i * pan + h] for i in range(frames)])
    kw = dict(height=h, width=w, frames=frames, search_range=2, qp=3, intra_dur=frames)
    pkg = TorchCodec(CodecConfig(**kw, fast_me=True), clip, device="cpu").encode()
    assert max(abs(m[1][1]) for ft, f in zip(pkg["frame_type_seq"], pkg["MVS per Frame"]) if ft == 1
               for m in f if m[0] == 0) > 2, "the clip must drive the MVP chain past sr"
    cfg = CodecConfig(**kw)  # decoding needs no fast ME
    sc = ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), tile_comm="halo")
    assert sc.ntile > 1
    np.testing.assert_array_equal(torch.stack(sc.decode(*_lists(pkg))).numpy(), pkg["reconstructed frames"])


def test_mesh_decode_rejects_bad_gop_opener():
    cfg = CodecConfig(height=64, width=64, frames=4, search_range=2, intra_dur=2)
    with pytest.raises(ValueError, match="open intra"):
        ShardedCodec(cfg, make_mesh(cfg, devices=CPU8)).decode([0, 1, 1, 1], [[]] * 4, [[]] * 4, [[]] * 4)


def test_mesh_intra_mode1_on_the_data_axis():
    clip = smooth_clip(h=48, w=64, frames=4, motion=2)
    kw = dict(height=48, width=64, frames=4, search_range=4, qp=4, intra_dur=2, intra_mode=1)
    cfg = CodecConfig(**kw)
    mesh = make_mesh(cfg, devices=CPU8)
    assert mesh.devices.shape == (8, 1)
    with pytest.raises(ValueError):
        ShardedCodec(cfg, make_mesh(CodecConfig(**dict(kw, intra_mode=0)), devices=CPU8, tile=2))
    sc = ShardedCodec(cfg, mesh, clip)
    pkg = sc.encode()
    _compare_packages(JaxCodec(JaxCodecConfig(**kw), clip).encode(), pkg)
    _assert_same_as_torch_codec(pkg, TorchCodec(cfg, clip, device="cpu").encode())
    np.testing.assert_array_equal(torch.stack(sc.decode(*_lists(pkg))).numpy(), pkg["reconstructed frames"])


@pytest.mark.parametrize("kw,name", [
    (dict(fast_me=True), "fast_me"),
    (dict(rc_flag=1, target_br="1 mbps", qp_rate_tables=[[1.0] * 12] * 2), "rc_flag"),
    (dict(rc_flag=2, target_br="1 mbps", qp_rate_tables=[[1.0] * 12] * 2, intra_thresh=400),
     "scene-change promotion"),
    (dict(rc_flag=1, target_br="1 mbps", qp_rate_tables=[[1.0] * 12] * 2, two_pass=True), "two_pass"),
    (dict(roi_qp_map=np.zeros(16, np.int32)), "roi_qp_map"),
])
def test_mesh_refuses_later_slices_by_name(kw, name):
    """Fast ME, rate control, promotion, two-pass and the ROI map were each
    once a later slice of the mesh; all are ported now, and the mesh
    constructs and encodes each as one device does.  What the mesh refuses
    is refused by name: parallel modes and the compat engine."""
    cfg = CodecConfig(height=64, width=64, frames=4, search_range=4, **kw)
    clip = synthetic_clip(h=64, w=64, frames=4, motion=2)
    pkg = VideoCodec(cfg, clip, mesh=make_mesh(cfg, devices=CPU8)).encode(compute_ssim=False)
    tpkg = TorchCodec(cfg, clip, device="cpu").encode()
    _assert_same_as_torch_codec(pkg, tpkg)
    assert pkg["Qp_per_row_per_frame"] == tpkg["Qp_per_row_per_frame"]
    for bad, match in ((dict(parallel_mode=1), "parallel_mode"), (dict(engine="compat"), "engine='jax'")):
        cfg = CodecConfig(height=64, width=64, frames=4, search_range=4, **bad)
        with pytest.raises(ValueError, match=match):
            ShardedCodec(cfg, make_mesh(cfg, devices=CPU8))


def test_a_tile_engine_refuses_fast_me_and_parallel_modes():
    """A tile engine codes fast ME (the mesh solves the chain over its
    tiles); parallel modes stay refused on a tile."""
    TorchCodec(CodecConfig(**KW), device="cpu", rows=(16, 32))
    TorchCodec(CodecConfig(**KW, fast_me=True), device="cpu", rows=(16, 32))
    with pytest.raises(ValueError, match="tile"):
        TorchCodec(CodecConfig(**KW, parallel_mode=3), device="cpu", rows=(16, 32))


def test_facade_with_a_mesh_writes_and_reads_the_same_stream(tmp_path):
    clip = synthetic_clip(h=64, w=64, frames=5, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=5, search_range=4, qp=4, intra_dur=3, vbs_enable=True,
                      fme_enable=True, lam=0.015)
    mesh = make_mesh(cfg, devices=CPU8)
    v = VideoCodec(cfg, clip, mesh=mesh)
    pkg = v.encode(package=False)
    v.transmit_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    one = VideoCodec(cfg, clip, device="cpu")
    one.encode(package=False)
    one.transmit_bitstream(tmp_path / "mv1.txt", tmp_path / "res1.txt")
    for a, b in (("mv.txt", "mv1.txt"), ("res.txt", "res1.txt")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    dec = VideoCodec(cfg, mesh=mesh).decode_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])
    with pytest.raises(TypeError):
        VideoCodec(cfg, device="cpu", mesh=mesh)


# ------------------------------------ the JAX mesh module itself (two tests)
VF2 = dict(vbs_enable=True, fme_enable=True, lam=0.015, n_ref_frames=2)


def test_mesh_matches_jax_sharded_codec():
    from streamoptima_tpu.parallel import ShardedCodec as JaxShardedCodec
    from streamoptima_tpu.parallel import make_mesh as jax_make_mesh

    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    jcfg = JaxCodecConfig(**KW, **VF2)
    jpkg = JaxShardedCodec(jcfg, jax_make_mesh(jcfg), clip).encode()
    cfg = CodecConfig(**KW, **VF2)
    _compare_packages(jpkg, ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), clip).encode())


def test_jax_sharded_codec_decodes_the_mesh_stream():
    from streamoptima_tpu.parallel import ShardedCodec as JaxShardedCodec
    from streamoptima_tpu.parallel import make_mesh as jax_make_mesh

    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    cfg = CodecConfig(**KW, **VF2)
    pkg = ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), clip).encode()
    jcfg = JaxCodecConfig(**KW, **VF2)
    dec = JaxShardedCodec(jcfg, jax_make_mesh(jcfg)).decode(*_lists(pkg))
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in dec]), pkg["reconstructed frames"])
