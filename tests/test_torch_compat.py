"""PyTorch port, the reference-exact engine (``engine="compat"``): parity with
the JAX package's ``CompatCodec``.

``streamoptima_tpu_torch.compat_engine.CompatCodec`` on the CPU (every
kernel's plain version) against ``streamoptima_tpu.compat_engine.
CompatCodec`` on the same seeded clips: the fourteen configurations of
``test_compat_parity.py`` on a sub-CIF clip (where the reference's 288x352
intra canvas matters most) and one CIF clip at the command line's defaults.
Every output is compared with tolerance 0 (frame types, MV lists, split
flags, quantized blocks, row QPs, reconstructions, MAE, PSNR, the decode of
either engine's package and the text bitstream bytes); SSIM within 1e-6.

The compat engine's transform replays scipy.fftpack's float64 arithmetic
(``transform.dct2_scipy_f64`` / ``idct2_scipy_f64``): held bit for bit to
scipy before rounding on random blocks and on a corpus of half-integer ties,
and the ``dct_scipy`` kernel's constants to the plain version's plan.  The
prediction gather's FME margin (quirk K18) against the JAX twin, and the
facade's and command line's handling of compat.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.fftpack import dct, idct

from conftest import smooth_clip, synthetic_clip
from test_compat_parity import CONFIGS

from streamoptima_tpu import bitstream as JBS
from streamoptima_tpu.compat_engine import CompatCodec as JaxCompatCodec
from streamoptima_tpu.config import CodecConfig as JaxCodecConfig
from streamoptima_tpu.core import pred as JP
from streamoptima_tpu.core import quant as JQ
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch import bitstream as TBS
from streamoptima_tpu_torch import main as cli
from streamoptima_tpu_torch import metrics
from streamoptima_tpu_torch import synthetic_clip as tsynthetic_clip
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.compat_engine import CompatCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as M
from streamoptima_tpu_torch.core import pred as TP
from streamoptima_tpu_torch.core import transform as T
from streamoptima_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
#: test_compat_parity.py's flags -> CodecConfig fields
FIELDS = dict(VBSEnable="vbs_enable", FMEEnable="fme_enable", fast_me="fast_me", RCFlag="rc_flag",
              targetBR="target_br", qp_tables="qp_rate_tables", intra_thresh="intra_thresh",
              ParallelMode="parallel_mode")
#: the command line's defaults (main.py) with --engine compat
CLI_DEFAULTS = dict(height=288, width=352, block_size=16, search_range=16, qp=5, intra_dur=21, lam=0.015,
                    vbs_enable=True, fme_enable=True, fast_me=True, intra_thresh=70000, engine="compat")


def _kw(flags, h=48, w=64, frames=3):
    """``test_compat_parity.run_compat``'s config for these flags."""
    kw = dict(height=h, width=w, frames=frames, block_size=16, search_range=2, qp=4, intra_dur=3, intra_mode=0,
              lam=0.015, n_ref_frames=1, frame_rate=30, engine="compat")
    kw.update({FIELDS[k]: v for k, v in flags.items()})
    return kw


def _lists(pkg):
    return pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]


def _stream(write, pkg, cfg, d: Path, tag: str) -> bytes:
    mv, res = d / f"{tag}mv.txt", d / f"{tag}res.txt"
    write(mv, res, pkg["frame_type_seq"], pkg["MVS per Frame"], pkg["Qp_per_row_per_frame"], pkg["approx residual"],
          cfg)
    return mv.read_bytes() + b"|" + res.read_bytes()


def _assert_compat_parity(kw, clip, tmp_path):
    """The port's CompatCodec on the CPU == the JAX package's, every output."""
    jcfg, cfg = JaxCodecConfig(**kw), CodecConfig(**kw)
    jc = JaxCompatCodec(jcfg, clip)
    jpkg = jc.encode()
    tc = CompatCodec(cfg, clip, device="cpu")
    tpkg = tc.encode()
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "MAE per Frame", "PSNR per frame", "MVS per Frame"):
        assert list(tpkg[k]) == list(jpkg[k]), k
    for i, (jr, tr) in enumerate(zip(jpkg["approx residual"], tpkg["approx residual"])):
        for j, (a, b) in enumerate(zip(jr, tr)):
            assert a[0] == b[0], (i, j)
            parts = (a[1], b[1]) if a[0] == 0 else (np.stack(a[1]), np.stack(b[1]))
            assert parts[0].dtype == parts[1].dtype, (i, j)  # the numpy repr the text stream writes
            np.testing.assert_array_equal(parts[1], parts[0], err_msg=f"frame {i} block {j}")
    np.testing.assert_array_equal(tpkg["reconstructed frames"], jpkg["reconstructed frames"])
    ssim = metrics.ssim_frames(tc.source, tc.recon, device="cpu")  # what the facade adds to the package
    np.testing.assert_allclose(ssim, jpkg["SSIM per frame"], rtol=0, atol=1e-6)
    assert tpkg["residual size per frame"] and len(tpkg["residual size per frame"]) == kw["frames"]
    # each engine decodes the other's package to the same reconstructions
    recon = jpkg["reconstructed frames"]
    np.testing.assert_array_equal(torch.stack(tc.decode(*_lists(jpkg))).numpy(), recon)
    np.testing.assert_array_equal(np.stack(jc.decode(*_lists(tpkg))), recon)
    # the same text bitstream bytes, read back and decoded by the port
    assert _stream(TBS.write_bitstream, tpkg, cfg, tmp_path, "t") == _stream(JBS.write_bitstream, jpkg, jcfg,
                                                                              tmp_path, "j")
    fts, mvs, qps, res = TBS.read_bitstream(tmp_path / "tmv.txt", tmp_path / "tres.txt", cfg)
    np.testing.assert_array_equal(torch.stack(tc.decode(fts, res, qps, mvs)).numpy(), recon)
    return tpkg


@pytest.mark.parametrize("clip", ["noise", "smooth"])
@pytest.mark.parametrize("name,flags", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_compat_matches_jax_compat(name, flags, clip, tmp_path):
    """The fourteen parity configurations on a 48x64 clip, 3 frames: the
    intra search reads the 288x352 canvas's 128 padding right of the frame."""
    y = synthetic_clip(48, 64, 3) if clip == "noise" else smooth_clip(48, 64, 3)
    pkg = _assert_compat_parity(_kw(flags), y, tmp_path)
    if name == "rc2_promote":
        assert 0 in pkg["frame_type_seq"][1:]  # a frame was promoted
    if flags.get("VBSEnable") and clip == "noise":
        assert any(sp for f in pkg["MVS per Frame"] for sp, _ in f)  # some block split


def test_compat_cif_cli_defaults_match_jax_compat(tmp_path):
    """CIF at the command line's defaults (fast ME + VBS + FME, sr 16, qp 5),
    3 frames of the command line's synthetic clip."""
    _assert_compat_parity(dict(CLI_DEFAULTS, frames=3), tsynthetic_clip(288, 352, 3), tmp_path)


def test_compat_refusals():
    with pytest.raises(NotImplementedError, match="B2"):
        CompatCodec(CodecConfig(height=48, width=64, frames=2, intra_mode=1, engine="compat"), device="cpu")
    with pytest.raises(ValueError, match="engine='compat'"):
        CompatCodec(CodecConfig(height=48, width=64, frames=2), device="cpu")
    big = CodecConfig(height=304, width=352, frames=1, engine="compat")  # taller than CIF: no intra canvas
    with pytest.raises(ValueError, match="288x352"):
        CompatCodec(big, np.zeros((1, 304, 352), np.uint8), device="cpu").encode()
    with pytest.raises(ValueError, match="288x352"):
        JaxCompatCodec(JaxCodecConfig(height=304, width=352, frames=1, engine="compat"),
                       np.zeros((1, 304, 352), np.uint8)).encode()


# ------------------------------------------------------ the scipy-exact DCT
def _corpus(n: int, kind: str, seed: int) -> np.ndarray:
    """Residual blocks in [-255, 255]: 10^5 random ones, or 5 * 10^4 whose sum
    is n/2 mod n, so that their DC coefficient (sum / n) is a half-integer
    tie, on which scipy's rounding follows pocketfft's float64 error."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-255, 256, (100000 if kind == "random" else 50000, n, n)).astype(np.int64)
    if kind == "ties":
        x[:, 0, 0] -= (x.sum(axis=(1, 2)) - n // 2) % n
        x[:, 0, 0] = np.where(x[:, 0, 0] < -255, x[:, 0, 0] + n, x[:, 0, 0])
        assert ((x.sum(axis=(1, 2)) % n) == n // 2).all() and np.abs(x).max() <= 255
    return x


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


def _scipy2(f, x: np.ndarray) -> np.ndarray:
    return f(f(x.astype(np.float64), axis=-2, norm="ortho"), axis=-1, norm="ortho")


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n", [8, 16])
def test_dct2_scipy_plain_equals_scipy_before_rounding(n, kind):
    x = _corpus(n, kind, n)
    got = T.dct2_scipy_f64(torch.from_numpy(x)).numpy()
    want = _scipy2(dct, x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if kind == "ties":  # the DC: sum / n exactly, a half-integer, within float64 error of it
        assert (np.abs(want[:, 0, 0] - np.floor(want[:, 0, 0]) - 0.5) < 1e-9).all()
    np.testing.assert_array_equal(K.dct_scipy(torch.from_numpy(x)).numpy(), np.round(want).astype(np.int64))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("qp", [0, 5])
@pytest.mark.parametrize("n", [8, 16])
def test_idct2_scipy_plain_equals_scipy_before_rounding(n, qp, kind):
    """The IDCT's inputs as the codec makes them: each corpus block's DCT,
    quantized and rescaled at ``qp``."""
    t = JQ.rescale(JQ.quantize(np.round(_scipy2(dct, _corpus(n, kind, 100 + n + qp))).astype(np.int64), qp), qp)
    got = T.idct2_scipy_f64(torch.from_numpy(t)).numpy()
    want = _scipy2(idct, t)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(K.dct_scipy(torch.from_numpy(t), inverse=True).numpy(),
                                  np.round(want).astype(np.int64))


@pytest.mark.parametrize("n", [8, 16])
def test_dct_scipy_kernel_constants_equal_the_plan(n):
    """The kernel's twiddles, scale and square roots (hex literals in
    csrc/dct_scipy.cu) are the plain version's pocketfft plan, exactly."""
    src = (REPO / "streamoptima_tpu_torch" / "csrc" / "dct_scipy.cu").read_text()
    body = src[src.index(f"template <> struct Plan<{n}>"):]
    body = body[:body.index("\n};")]
    hexes = [float.fromhex(v) for v in re.findall(r"-?0x[0-9a-f.]+p[+-]\d+", body)]
    plan = T.scipy_plan(n)
    assert hexes == [plan["fct"]] + plan["rfft_tw"][0] + plan["dct_tw"]
    sqrt2 = re.search(r"kSqrt2 = (0x[0-9a-f.]+p[+-]\d+)", src).group(1)
    hsqt2 = re.search(r"kHsqt2 = (0x[0-9a-f.]+p[+-]\d+)", src).group(1)
    assert (float.fromhex(sqrt2), float.fromhex(hsqt2)) == (T._SQRT2, T._HSQT2)


def test_dct_scipy_wrapper_checks():
    with pytest.raises(ValueError, match="int64"):
        K.dct_scipy(torch.zeros((2, 8, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="power-of-two"):
        K.dct_scipy(torch.zeros((2, 6, 6), dtype=torch.int64))
    assert K.dct_scipy(torch.zeros((0, 16, 16), dtype=torch.int64)).shape == (0, 16, 16)


# --------------------------------------------------- the quads' FME margin
def test_gather_fme_margin_matches_jax():
    """The plain gather with ``fme_margin`` (K18: the parent block's size on
    the quads) against the JAX twin, with MVs on both sides of every case
    boundary; the quads' plane of ``pred_fetch_fme_vbs`` at ``quad_margin``."""
    rng = np.random.default_rng(18)
    h, w, bs = 48, 64, 16
    s = bs // 2
    ref = rng.integers(0, 256, (1, h, w), dtype=np.uint8)
    planes = M.fme_parity_planes(torch.from_numpy(ref), wrap_row_pass=True)
    grid = M.grid_of_planes(planes).to(torch.int32)
    nb = (h // bs) * (w // bs)
    qx, qy = M.quad_origins(h, w, bs, "cpu")
    smv = np.zeros((nb, 4, 3), np.int32)
    smv[..., :2] = rng.integers(-12, 13, (nb, 4, 2))
    mv = np.zeros((nb, 3), np.int32)
    for margin in (None, s, bs):
        args = dict(fme=True, fme_margin=margin)
        want = JP.gather_predictions(smv.reshape(-1, 3), grid.numpy(), qx.reshape(-1).numpy(),
                                     qy.reshape(-1).numpy(), s, xp=np, **args)
        got = TP.gather_predictions(torch.from_numpy(smv.reshape(-1, 3)), grid, qx.reshape(-1), qy.reshape(-1), s,
                                    **args)
        np.testing.assert_array_equal(got.numpy(), want)
        _, pq = K.pred_fetch_fme_vbs(torch.from_numpy(mv), torch.from_numpy(smv), planes, bs, quad_margin=margin)
        np.testing.assert_array_equal(pq.numpy(), K._quad_plane(torch.from_numpy(smv), grid, h, w, bs, True, 0,
                                                                tuple(grid.shape[-2:]), 0, margin).numpy())
    full = JP.gather_predictions(smv.reshape(-1, 3), grid.numpy(), qx.reshape(-1).numpy(), qy.reshape(-1).numpy(),
                                 s, True, np, fme_margin=bs)
    assert not np.array_equal(full, JP.gather_predictions(smv.reshape(-1, 3), grid.numpy(), qx.reshape(-1).numpy(),
                                                          qy.reshape(-1).numpy(), s, True, np))  # K18 bites here


# --------------------------------------------------- facade and command line
def test_facade_runs_compat_and_refuses_mesh_and_binary(tmp_path):
    kw = _kw({"VBSEnable": True, "FMEEnable": True})
    y = synthetic_clip(48, 64, 3)
    cfg = CodecConfig(**kw)
    v = VideoCodec(cfg, y, device="cpu")
    pkg = v.encode()
    jpkg = JaxCompatCodec(JaxCodecConfig(**kw), y).encode()
    assert pkg["PSNR per frame"] == jpkg["PSNR per frame"]
    np.testing.assert_allclose(pkg["SSIM per frame"], jpkg["SSIM per frame"], rtol=0, atol=1e-6)
    v.transmit_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    dec = VideoCodec(cfg, device="cpu").decode_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    np.testing.assert_array_equal(dec, jpkg["reconstructed frames"])
    np.testing.assert_array_equal(v.decode(), jpkg["reconstructed frames"])
    with pytest.raises(ValueError, match="engine='jax'"):
        VideoCodec(cfg, y, mesh=make_mesh(CodecConfig(**dict(kw, engine="jax")), devices=["cpu"] * 2))
    v.transmit_bitstream_binary(tmp_path / "clip.sob")  # written as the JAX facade writes it; not decoded
    with pytest.raises(ValueError, match="engine='jax'"):
        VideoCodec(cfg, device="cpu").decode_bitstream_binary(tmp_path / "clip.sob")


def test_cli_runs_compat_with_the_jax_streams(tmp_path, monkeypatch):
    """``--engine compat --device cpu``: exit 0, and its text streams are the
    bytes the JAX package's CompatCodec and writer give on the same clip and
    config; ``--binary`` and ``--mesh`` with compat exit non-zero."""
    monkeypatch.chdir(tmp_path)
    argv = ["--synthetic", "--engine", "compat", "--device", "cpu", "--height", "48", "--width", "64", "--frames",
            "3", "--search-range", "4", "--intra-dur", "2"]
    assert cli.main(argv) == 0
    kw = dict(height=48, width=64, frames=3, block_size=16, search_range=4, qp=5, intra_dur=2, intra_mode=0,
              lam=0.015, vbs_enable=True, fme_enable=True, fast_me=True, intra_thresh=70000, engine="compat")
    jcfg = JaxCodecConfig(**kw)
    jpkg = JaxCompatCodec(jcfg, tsynthetic_clip(48, 64, 3)).encode()
    assert (tmp_path / "files" / "mvs_per_frame.txt").read_bytes() + b"|" + (
        tmp_path / "files" / "res_per_frame.txt").read_bytes() == _stream(JBS.write_bitstream, jpkg, jcfg, tmp_path,
                                                                           "j")
    assert (tmp_path / "yuv" / "y_only_reconstructed.yuv").read_bytes() == jpkg["reconstructed frames"].tobytes()
    for extra, message in ((["--binary", "x.sob"], "--binary requires --engine jax"),
                           (["--mesh"], "--mesh requires --engine jax")):
        with pytest.raises(SystemExit) as e:
            cli.main(argv + extra)
        assert message in str(e.value.code)


@pytest.mark.parametrize("extra", [{}, {"FMEEnable": True}], ids=["whole_pel", "fme"])
def test_compat_without_valid_candidates_matches_jax(extra, tmp_path):
    """A clip one block wide: no whole-pel candidate is valid (0 <= x + dx <
    W - bs = 0), so every block is predicted at mv (0, 0, 0) by the fetch,
    not from the search's zeros, with MAE inf."""
    _assert_compat_parity(_kw(extra, h=48, w=16), synthetic_clip(48, 16, 3), tmp_path)
