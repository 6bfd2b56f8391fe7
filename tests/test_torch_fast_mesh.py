"""PyTorch port, fast ME on the mesh, and the mesh facade's decoder choice.

Kernel level: the plain version of ``rowscan_pass`` with a tile's inputs (the
tile's rows of the current frame, the whole frame's planes, ``g_row0``)
against ``me_pallas.rowscan_pass`` in interpret mode with the tile's frame
rows as ``ys`` and the frame's ``dims``, as the JAX mesh calls it
(``streamoptima_tpu/parallel/mesh.py:456-490``), on the top, a middle and
the bottom tile of a tile-4 split.

Codec level: ``tests/test_parallel.py``'s fast-ME cases (``CASES[6:9]``) and
its noise clip with a warm-started chain on the port's 8-device CPU mesh,
held against ``JaxCodec`` on one device (the JAX ``ShardedCodec``'s XLA:CPU
collectives are what aborts test workers under load) and bit for bit against
``TorchCodec``: MVs, coefficients, sizes, row bits, reconstructions and text
bytes, with the mesh's decode equal to its reconstructions and each engine
decoding the other's stream.

Facade: ``encode(fetch=...)`` on a mesh, and a mesh's decode of a stream
whose intra frames fall off its ``intra_dur``, against the JAX facade.
Integer outputs exact; PSNR to 1e-4 (float32 in another order), SSIM to
1e-6 (host float64 against the JAX facade's device SSIM).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import synthetic_clip
from test_parallel import CASES, _compare_packages
from test_torch_fastme import _dims, _jax_pass_inputs, _planes, _setup, _t

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu import bitstream as JBS
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu.core import me_pallas as MP
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch import bitstream as TBS
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.engine import TorchCodec, frame_arrays_of
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

torch.set_num_threads(1)
BS = 16
CPU8 = ["cpu"] * 8
KW = dict(height=64, width=64, frames=6, block_size=16, search_range=4, qp=3, intra_dur=3)  # test_parallel's
FAST_CASES = CASES[6:9]  # fast ME; fast ME + VBS + FME; fast ME with nref 3
IDS = [",".join(sorted(c)) for c in FAST_CASES]


def _lists(pkg):
    return pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]


def _text_bytes(write, pkg, cfg, d, tag):
    mv, res = d / f"{tag}mv.txt", d / f"{tag}res.txt"
    write(mv, res, pkg["frame_type_seq"], pkg["MVS per Frame"], pkg["Qp_per_row_per_frame"],
          pkg["approx residual"], cfg)
    return mv.read_bytes(), res.read_bytes()


# ----------------------------------------------------- the kernel on a tile
@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_tile_rowscan_pass_plain_matches_pallas_kernel(k, fme):
    """The top, a middle and the bottom tile of a tile-4 split of a 64x64
    frame (one block row a tile), from zero and from random seeds: cur is
    the tile's rows, the planes the whole frame's.  The TPU kernel takes the
    three tiles' rows as three segments of one call, each at its frame row
    in ``ys``, with the frame's ``dims``."""
    tiles = (0, 1, 3)
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme, h=64, w=64, seed=31)
    h, w = cur.shape
    h_t = h // 4
    blocks = np.concatenate([np.arange(t * nbc, (t + 1) * nbc) for t in tiles])
    cur3 = np.concatenate([cur[t * h_t:(t + 1) * h_t] for t in tiles])
    prep, curKk, xs0, xsK, ys, cmK = _jax_pass_inputs(cur3, refs, bx[blocks], by[blocks], fme, k)
    assert list(np.asarray(ys)) == [t * h_t for t in tiles]
    planes = _planes(refs, fme)
    random = g.reshape(nbr, nbc, 3)[tiles, 0].copy()
    random[1:] = (-3, -h_t - 5, 1), (5, -2 * h_t - 3, 0)  # negative and odd, reaching into the tiles above
    for seeds in (np.zeros((3, 3), np.int32), random):
        mK, _ = MP.rowscan_pass(prep, curKk, xs0, xsK, ys, cmK, jnp.asarray(seeds), BS, k, _dims(h, w, fme),
                                interpret=True)
        ref = np.asarray(mK).reshape(-1, 3, 3)[:nbc].swapaxes(0, 1)  # (tile, L, 3)
        for i, t in enumerate(tiles):
            got = K.rowscan_pass(_t(cur[t * h_t:(t + 1) * h_t]), planes, _t(seeds[i:i + 1]), BS, fme,
                                 g_row0=t * h_t, grid=(h, w))
            np.testing.assert_array_equal(got.numpy()[0], ref[i], err_msg=f"tile {t}")
    # the bottom tile's rows read as a frame of their own give other MVs
    own = K.rowscan_pass(_t(cur[3 * h_t:]), planes[..., 3 * h_t:, :].contiguous(), _t(random[2:]), BS, fme)
    assert not torch.equal(own, got)


def test_tile_rowscan_pass_refuses_a_tile_outside_its_frame():
    cur = torch.zeros((32, 64), dtype=torch.uint8)
    refs = torch.zeros((1, 64, 64), dtype=torch.uint8)
    seeds = torch.zeros((2, 3), dtype=torch.int32)
    K.rowscan_pass(cur, refs, seeds, 16, False, g_row0=32, grid=(64, 64))
    with pytest.raises(ValueError, match="fit"):
        K.rowscan_pass(cur, refs, seeds, 16, False, g_row0=48)
    with pytest.raises(ValueError, match="grid"):
        K.rowscan_pass(cur, refs, seeds, 16, False, g_row0=0, grid=(128, 64))


# ------------------------------------------- the fast-ME mesh against the engines
@pytest.mark.parametrize("extra", FAST_CASES, ids=IDS)
def test_fast_mesh_matches_jax_codec_and_torch_codec(extra, tmp_path):
    """One fast-ME CASE of test_parallel's clip on the (2, 4) CPU mesh:
    the package against JaxCodec's and, bit for bit, TorchCodec's (per-frame
    row bits too), the text bytes against JaxCodec's, and the decodes: the
    mesh's of its own and of JaxCodec's stream, JaxCodec's of the mesh's."""
    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    jcfg, cfg = JaxCodecConfig(**KW, **extra), CodecConfig(**KW, **extra)
    jpkg = JaxCodec(jcfg, clip).encode()
    tc = TorchCodec(cfg, clip, device="cpu")
    tpkg, tarrays = tc.encode(), tc.encode(package=False)
    mesh = make_mesh(cfg, devices=CPU8)
    assert mesh.devices.shape == (2, 4)
    sc = ShardedCodec(cfg, mesh, clip)
    launches = K.rowscan_pass.launches
    pkg, arrays = sc.encode(), sc.encode(package=False)
    assert K.rowscan_pass.launches == launches  # CPU: the plain versions, no launch

    _compare_packages(jpkg, pkg)
    for k in ("frame_type_seq", "residual size per frame", "PSNR per frame", "MAE per Frame", "MVS per Frame",
              "Qp_per_row_per_frame"):
        assert pkg[k] == tpkg[k], k
    _compare_packages(tpkg, pkg)
    for a, b in zip(arrays["per_frame"], tarrays["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "row_bits", "recon"):
            assert torch.equal(a[k], b[k]), k
    passes = pkg["fast_me_passes"]
    assert len(passes) == pkg["frame_type_seq"].count(1) and min(passes) >= 1
    assert (_text_bytes(TBS.write_bitstream, pkg, cfg, tmp_path, "t")
            == _text_bytes(JBS.write_bitstream, jpkg, jcfg, tmp_path, "j"))

    np.testing.assert_array_equal(torch.stack(sc.decode(*_lists(pkg))).numpy(), pkg["reconstructed frames"])
    np.testing.assert_array_equal(torch.stack(sc.decode(*_lists(jpkg))).numpy(), jpkg["reconstructed frames"])
    dec = JaxCodec(jcfg).decode(*_lists(pkg))
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in dec]), pkg["reconstructed frames"])


def test_fast_mesh_warm_start_on_noise_crosses_tile_edges():
    """``test_sharded_fast_me_warm_start_parity``'s clip: noise, 8 frames in
    one GOP, tile 8 (one block row a tile), two references.  Every inter
    frame warm-starts from the last, and MVs leave their tile's rows: a tile
    confirm that took its own rows for the frame would differ."""
    rng = np.random.default_rng(5)
    clip = rng.integers(0, 256, size=(8, 128, 64), dtype=np.uint8)
    kw = dict(height=128, width=64, frames=8, block_size=16, search_range=4, qp=2, intra_dur=8, fast_me=True,
              n_ref_frames=2)
    cfg = CodecConfig(**kw)
    mesh = make_mesh(cfg, devices=CPU8)
    assert mesh.devices.shape == (1, 8)
    sc = ShardedCodec(cfg, mesh, clip)
    pkg = sc.encode()
    _compare_packages(JaxCodec(JaxCodecConfig(**kw), clip).encode(), pkg)
    tpkg = TorchCodec(cfg, clip, device="cpu").encode()
    assert pkg["MVS per Frame"] == tpkg["MVS per Frame"]
    np.testing.assert_array_equal(pkg["reconstructed frames"], tpkg["reconstructed frames"])
    assert pkg["fast_me_passes"] == tpkg["fast_me_passes"]  # one data row: the same warm starts
    assert any(m[0] == 0 and m[1][1] != 0 for f in pkg["MVS per Frame"][1:] for m in f)
    np.testing.assert_array_equal(torch.stack(sc.decode(*_lists(pkg))).numpy(), pkg["reconstructed frames"])


# ------------------------------------------------ the facade's two repairs
@pytest.mark.parametrize("fetch", ["full", "light", "metrics"])
def test_mesh_facade_encodes_with_every_fetch(fetch):
    """``fetch="metrics"`` returns no reconstructions, so the facade skips
    SSIM as the JAX facade does; the other fetches carry SSIM equal to the
    JAX facade's."""
    kw = dict(height=64, width=64, frames=4, search_range=4, qp=4, intra_dur=2)
    clip = synthetic_clip(64, 64, 4)
    cfg = CodecConfig(**kw)
    pkg = VideoCodec(cfg, clip, mesh=make_mesh(cfg, devices=CPU8)).encode(fetch=fetch)
    jpkg = JaxVideoCodec(JaxCodecConfig(**kw), clip).encode()
    np.testing.assert_allclose(pkg["PSNR per frame"], jpkg["PSNR per frame"], rtol=1e-4)
    if fetch == "metrics":
        assert pkg["reconstructed frames"] is None and "SSIM per frame" not in pkg
    else:
        np.testing.assert_array_equal(pkg["reconstructed frames"], jpkg["reconstructed frames"])
        np.testing.assert_allclose(pkg["SSIM per frame"], jpkg["SSIM per frame"], rtol=0, atol=1e-6)


def test_mesh_facade_decodes_a_stream_off_its_gops_on_one_device(tmp_path):
    """A stream a one-device encoder wrote at intra_dur=4 read by a mesh
    facade at intra_dur=2: its frame 2 is inter, so the mesh's GOPs do not
    hold; the facade decodes it on one device, as the JAX facade does, and a
    corrupt stream still raises (no error is swallowed)."""
    kw = dict(height=64, width=64, frames=4, search_range=4, qp=4)
    clip = synthetic_clip(64, 64, 4)
    enc = VideoCodec(CodecConfig(**kw, intra_dur=4), clip, device="cpu")
    pkg = enc.encode(compute_ssim=False)
    enc.transmit_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    cfg = CodecConfig(**kw, intra_dur=2)
    mesh = make_mesh(cfg, devices=CPU8)
    dec = VideoCodec(cfg, mesh=mesh)
    got = dec.decode_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    np.testing.assert_array_equal(got, pkg["reconstructed frames"])
    assert not dec._dec_mesh.gop_regular(pkg["frame_type_seq"])
    jdec = JaxVideoCodec(JaxCodecConfig(**kw, intra_dur=2)).decode_bitstream(tmp_path / "mv.txt",
                                                                           tmp_path / "res.txt")
    np.testing.assert_array_equal(got, jdec)
    regular = VideoCodec(cfg, clip, mesh=mesh)
    rpkg = regular.encode(compute_ssim=False)
    assert regular._dec_mesh.gop_regular(rpkg["frame_type_seq"])
    np.testing.assert_array_equal(regular.decode(), rpkg["reconstructed frames"])
    for p in (pkg, rpkg):  # off the mesh's GOPs and on them: a corrupt stream raises either way
        bad = [list(f) for f in p["MVS per Frame"]]
        bad[1][0] = (0, (0, 0, 1))  # frame 1 holds one reference: index 1 is outside it
        with pytest.raises(ValueError, match="corrupt stream"):
            dec.decode(p["frame_type_seq"], p["approx residual"], p["Qp_per_row_per_frame"], bad)


def test_tile_engines_do_not_launch_on_the_cpu():
    """The wrappers' counters stay at zero on the CPU mesh: every kernel
    took its plain version."""
    clip = synthetic_clip(64, 64, 3, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=3, search_range=4, qp=4, intra_dur=3, fast_me=True,
                      vbs_enable=True, fme_enable=True)
    before = {n: getattr(K, n).launches for n in ("rowscan_pass", "window_fetch", "pred_fetch_fme_vbs")}
    pkg = ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), clip).encode(package=False)
    assert {n: getattr(K, n).launches for n in before} == before
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(pkg["per_frame"], pkg["frame_type_seq"])]
    assert len(pairs) == 3 and len(pkg["fast_me_passes"]) == 2
