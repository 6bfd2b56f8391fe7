"""PyTorch port, the slice as a whole: TorchCodec against JaxCodec.

On the same seeded clip and config the port must reproduce the JAX engine
bit for bit (MVs, coefficients, sizes, row bits, reconstructions and the
text bitstream bytes), decode the JAX engine's streams and have its own
decoded by it.  PSNR and MAE are float32 with reductions in another order:
1e-4.  sr=8 runs the wavefront intra reconstruction, sr=16 the column scan.
Each package's ``CodecConfig`` is built from one dict of keyword arguments.
"""
import ast
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu_torch import bitstream as BS
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu import jax_engine as JE
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu.utils import synthetic_clip
from streamoptima_tpu_torch import engine as TE
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.engine import TorchCodec
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
H, W, FRAMES = 64, 96, 6


def _kw(sr, **kw):
    return dict(height=H, width=W, frames=FRAMES, search_range=sr, qp=4, intra_dur=4, **kw)


def _cfg(sr, **kw):
    return CodecConfig(**_kw(sr, **kw))


def _jcfg(sr, **kw):
    return JaxCodecConfig(**_kw(sr, **kw))


@pytest.fixture(scope="module", params=[8, 16], ids=["sr8_wavefront", "sr16_select"])
def encoded(request, tmp_path_factory):
    """Both engines' encodes and text bitstreams of one clip."""
    sr = request.param
    clip = synthetic_clip(H, W, FRAMES, seed=sr)
    d = tmp_path_factory.mktemp(f"sr{sr}")
    jv = JaxVideoCodec(_jcfg(sr), clip)
    jpkg = jv.encode(compute_ssim=False, package=False)
    jv.transmit_bitstream(d / "jmv.txt", d / "jres.txt")
    tv = VideoCodec(_cfg(sr), clip, device="cpu")
    tpkg = tv.encode(package=False)
    tv.transmit_bitstream(d / "tmv.txt", d / "tres.txt")
    return {"sr": sr, "clip": clip, "dir": d, "jpkg": jpkg, "tpkg": tpkg}


@pytest.mark.parametrize("key", ["mv", "split", "qtc_full", "size", "row_bits", "recon"])
def test_per_frame_outputs_bit_identical(encoded, key):
    for i, (a, b) in enumerate(zip(encoded["tpkg"]["per_frame"], encoded["jpkg"]["per_frame"])):
        np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=f"frame {i} {key}")


def test_package_metrics_agree(encoded):
    t, j = encoded["tpkg"], encoded["jpkg"]
    assert t["frame_type_seq"] == j["frame_type_seq"] == [0, 1, 1, 1, 0, 1]
    assert t["residual size per frame"] == j["residual size per frame"]
    np.testing.assert_array_equal(t["reconstructed frames"], j["reconstructed frames"])
    np.testing.assert_allclose(t["PSNR per frame"], j["PSNR per frame"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["MAE per Frame"], j["MAE per Frame"], rtol=0, atol=1e-4)
    assert len(t["SSIM per frame"]) == FRAMES and all(0.5 < s <= 1 for s in t["SSIM per frame"])


def test_text_bitstream_bytes_identical(encoded):
    d = encoded["dir"]
    assert (d / "tmv.txt").read_bytes() == (d / "jmv.txt").read_bytes()
    assert (d / "tres.txt").read_bytes() == (d / "jres.txt").read_bytes()


def test_port_decodes_jax_bitstream(encoded):
    d = encoded["dir"]
    dec = VideoCodec(_cfg(encoded["sr"]), device="cpu").decode_bitstream(d / "jmv.txt", d / "jres.txt")
    np.testing.assert_array_equal(dec, encoded["jpkg"]["reconstructed frames"])


def test_jax_decodes_port_bitstream(encoded):
    d = encoded["dir"]
    dec = JaxVideoCodec(_jcfg(encoded["sr"])).decode_bitstream(d / "tmv.txt", d / "tres.txt")
    np.testing.assert_array_equal(dec, encoded["tpkg"]["reconstructed frames"])


def test_cross_decode_in_memory_per_frame_state(encoded):
    """from_jax_per_frame / to_numpy_per_frame carry the per-frame state
    across: each engine decodes the other's encode from arrays."""
    cfg, fts = _cfg(encoded["sr"]), encoded["jpkg"]["frame_type_seq"]
    jstate = TE.from_jax_per_frame([{k: np.asarray(v) for k, v in o.items()} for o in encoded["jpkg"]["per_frame"]],
                                   "cpu")
    pairs = [TE.frame_arrays_of(o, ft) for o, ft in zip(jstate, fts)]
    dec = TorchCodec(cfg, device="cpu").decode(fts, [r for _, r in pairs], [[]] * FRAMES, [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).numpy(), encoded["jpkg"]["reconstructed frames"])

    tstate = TE.to_numpy_per_frame(encoded["tpkg"]["per_frame"])
    jpairs = [JE.frame_arrays_of(o, ft) for o, ft in zip(tstate, fts)]
    jdec = JE.JaxCodec(_jcfg(encoded["sr"])).decode(fts, [r for _, r in jpairs], [[]] * FRAMES, [m for m, _ in jpairs])
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in jdec]), encoded["tpkg"]["reconstructed frames"])


def test_list_package_roundtrip_and_files(encoded, tmp_path):
    """package=True (list interchange) decodes in memory and writes the
    same bitstream bytes as the array form; the file savers write raw Y."""
    v = VideoCodec(_cfg(encoded["sr"]), encoded["clip"], device="cpu")
    pkg = v.encode(compute_ssim=False)
    dec = v.decode()
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])
    v.transmit_bitstream(tmp_path / "mv.txt", tmp_path / "res.txt")
    assert (tmp_path / "mv.txt").read_bytes() == (encoded["dir"] / "jmv.txt").read_bytes()
    assert (tmp_path / "res.txt").read_bytes() == (encoded["dir"] / "jres.txt").read_bytes()
    v.save_decoded_frames(tmp_path / "dec.yuv")
    v.save_reconstructed(tmp_path / "rec.yuv")
    assert (tmp_path / "dec.yuv").read_bytes() == (tmp_path / "rec.yuv").read_bytes() == dec.tobytes()


@pytest.mark.parametrize("kw,feature", [
    ({"vbs_enable": True}, "vbs_enable"),
    ({"fme_enable": True}, "fme_enable"),
    ({"fast_me": True, "vbs_enable": True}, "fast_me"),
    ({"rc_flag": 1, "target_br": "1 mbps", "qp_rate_tables": [[1.0] * 12] * 2}, "rc_flag"),
    ({"roi_qp_map": np.zeros(24, np.int32)}, "roi_qp_map"),
    ({"intra_mode": 1}, "intra_mode=1"),
    ({"parallel_mode": 1}, "parallel_mode"),
    ({"n_ref_frames": 2}, "n_ref_frames"),
    ({"fast_me": True, "fme_enable": True}, "fast_me"),
    ({"n_ref_frames": 2, "vbs_enable": True, "fme_enable": True}, "n_ref_frames"),
    ({"parallel_mode": 2, "vbs_enable": True, "fme_enable": True}, "parallel_mode"),
])
def test_unported_features_raise_by_name(kw, feature):
    """Every feature of the list is ported to one device, rate control and
    the ROI map included: each constructs there, alone and beside an ROI
    map.  The mesh runs each beside an ROI map too, and encodes it as one
    device does, but the parallel modes, which it refuses with ValueError as
    the JAX mesh does."""
    roi = {} if "roi_qp_map" in kw else {"roi_qp_map": np.arange(24, dtype=np.int32) % 5 - 2}
    for k in (kw, dict(kw, **roi)):
        TorchCodec(_cfg(8, **k), device="cpu")
        VideoCodec(_cfg(8, **k), device="cpu")
    cfg = _cfg(8, **kw, **roi)
    mesh = make_mesh(cfg, devices=["cpu"] * 2)
    if "parallel_mode" in kw:
        with pytest.raises(ValueError, match="parallel_mode"):
            ShardedCodec(cfg, mesh)
        with pytest.raises(ValueError, match="parallel_mode"):
            VideoCodec(cfg, mesh=mesh)
        return
    clip = synthetic_clip(H, W, FRAMES)
    pkg = VideoCodec(cfg, clip, mesh=mesh).encode(compute_ssim=False)
    one = TorchCodec(cfg, clip, device="cpu").encode()
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame", "PSNR per frame", "MVS per Frame"):
        assert pkg[k] == one[k], k
    np.testing.assert_array_equal(pkg["reconstructed frames"], one["reconstructed frames"])


def test_two_pass_and_compat_refused():
    """Two-pass runs on one device and on the mesh, with the same row QPs;
    ``TorchCodec`` and the mesh refuse ``engine='compat'`` (``CompatCodec``'s)."""
    cfg = _cfg(8, rc_flag=1, target_br="1 mbps", qp_rate_tables=[[1.0] * 12] * 2, two_pass=True)
    clip = synthetic_clip(H, W, FRAMES)
    one = TorchCodec(cfg, clip, device="cpu").encode()
    pkg = ShardedCodec(cfg, make_mesh(cfg, devices=["cpu"] * 2), clip).encode()
    assert pkg["Qp_per_row_per_frame"] == one["Qp_per_row_per_frame"]
    assert pkg["residual size per frame"] == one["residual size per frame"]
    with pytest.raises(ValueError, match="compat"):
        TorchCodec(_cfg(8, engine="compat"), device="cpu")
    with pytest.raises(ValueError, match="engine='jax'"):
        ShardedCodec(_cfg(8, engine="compat"), make_mesh(cfg, devices=["cpu"] * 2))


def test_device_is_required():
    """No silent CPU fallback: without ``device=`` the engine takes the card
    ("cuda"); the CPU runs only when asked for, so without a card this raises."""
    if torch.cuda.is_available():
        assert TorchCodec(_cfg(8)).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TorchCodec(_cfg(8))


def test_corrupt_reference_index_rejected_before_launch(encoded):
    cfg, fts = _cfg(encoded["sr"]), encoded["tpkg"]["frame_type_seq"]
    pairs = [TE.frame_arrays_of(o, ft) for o, ft in zip(encoded["tpkg"]["per_frame"], fts)]
    mvs = [m for m, _ in pairs]
    bad = mvs[1].mv.copy()
    bad[5, 2] = 1  # the decoder holds one reference frame at frame 1
    mvs[1] = BS.FrameMVArrays(1, bad, mvs[1].split, mvs[1].smv)
    with pytest.raises(ValueError, match="corrupt stream"):
        TorchCodec(cfg, device="cpu").decode(fts, [r for _, r in pairs], [[]] * FRAMES, mvs)


def test_port_runs_without_importing_jax(tmp_path):
    """A fresh interpreter (not a fork of this JAX process) drives the port's
    encode -> text bitstream -> decode, whole-pel and VBS + FME, full search
    and fast ME, VBS alone with two references and intra mode 1, fast ME
    with FME alone under parallel mode 2, rate control with promotion,
    two-pass and an ROI map, the compat engine with VBS + FME, and VBS +
    FME, fast ME and rate control with
    promotion, two-pass and an ROI map on a (2, 2) CPU mesh
    (``streamoptima_tpu_torch.parallel``) with the binary container, imports
    the dry run, ``profiling`` and ``viz``, runs the command line once
    (``main``, on the CPU, with the binary container and the VBS overlay),
    and never imports jax or the JAX package, nor matplotlib (which the
    card's machine does not have)."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from streamoptima_tpu_torch import CodecConfig, VideoCodec, synthetic_clip
        import streamoptima_tpu_torch.profile_main_path
        import streamoptima_tpu_torch.core.fastme
        vf = {{"vbs_enable": True, "fme_enable": True}}
        tools = {{"vbs_enable": True, "n_ref_frames": 2, "intra_mode": 1}}
        pm2 = {{"fast_me": True, "fme_enable": True, "parallel_mode": 2}}
        tables = [[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180]] * 2
        rc = {{"rc_flag": 2, "intra_thresh": 300, "target_br": "100 kbps", "qp_rate_tables": tables,
              "two_pass": True, "roi_qp_map": np.arange(6) % 3 - 1}}
        for extra in ({{}}, vf, {{"fast_me": True}}, {{"fast_me": True, **vf}}, tools, pm2, rc):
            cfg = CodecConfig(height=32, width=48, frames=3, search_range=4, qp=4, intra_dur=2, **extra)
            v = VideoCodec(cfg, synthetic_clip(32, 48, 3), device="cpu")
            pkg = v.encode(package=False)
            v.transmit_bitstream(r"{tmp_path / 'mv.txt'}", r"{tmp_path / 'res.txt'}")
            dec = VideoCodec(cfg, device="cpu").decode_bitstream(r"{tmp_path / 'mv.txt'}",
                                                                 r"{tmp_path / 'res.txt'}")
            assert np.array_equal(dec, pkg["reconstructed frames"])
        ccfg = CodecConfig(height=32, width=48, frames=3, search_range=4, qp=4, intra_dur=2, engine="compat", **vf)
        v = VideoCodec(ccfg, synthetic_clip(32, 48, 3), device="cpu")
        pkg = v.encode()
        v.transmit_bitstream(r"{tmp_path / 'mv.txt'}", r"{tmp_path / 'res.txt'}")
        dec = VideoCodec(ccfg, device="cpu").decode_bitstream(r"{tmp_path / 'mv.txt'}", r"{tmp_path / 'res.txt'}")
        assert np.array_equal(dec, pkg["reconstructed frames"])
        from streamoptima_tpu_torch.parallel import make_mesh
        from streamoptima_tpu_torch.parallel.dryrun import dryrun_multichip
        for extra in (vf, {{"fast_me": True, **vf}}, rc):
            cfg = CodecConfig(height=32, width=48, frames=3, search_range=4, qp=4, intra_dur=2, **extra)
            mesh = make_mesh(cfg, devices=["cpu"] * 4)
            assert mesh.devices.shape == (2, 2)
            v = VideoCodec(cfg, synthetic_clip(32, 48, 3), mesh=mesh)
            pkg = v.encode(package=False)
            v.transmit_bitstream(r"{tmp_path / 'mv.txt'}", r"{tmp_path / 'res.txt'}")
            dec = VideoCodec(cfg, mesh=mesh).decode_bitstream(r"{tmp_path / 'mv.txt'}", r"{tmp_path / 'res.txt'}")
            assert np.array_equal(dec, pkg["reconstructed frames"])
            v.transmit_bitstream_binary(r"{tmp_path / 'clip.sob'}")
            dec = VideoCodec(cfg, mesh=mesh).decode_bitstream_binary(r"{tmp_path / 'clip.sob'}")
            assert np.array_equal(dec, pkg["reconstructed frames"])
        assert callable(dryrun_multichip)  # imported, not run: tests/test_torch_mesh_rc.py runs it
        import os
        from streamoptima_tpu_torch import profiling, viz
        from streamoptima_tpu_torch.main import main
        os.chdir(r"{tmp_path}")
        assert main(["--synthetic", "--device", "cpu", "--height", "32", "--width", "48", "--frames", "3",
                     "--search-range", "4", "--intra-dur", "2", "--binary", "clip.sob", "--vbs-overlay", "ov.yuv"]) == 0
        assert callable(profiling.time_steps) and callable(viz.mv_field)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "streamoptima_tpu", "matplotlib"))
        assert not bad, bad
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


#: the search and fetch wrappers (their plain versions too), the window, confirm and chain-pass wrappers
MOTION_CALLS = re.compile(r"^(full_search\w*|pred_fetch\w*|window_fetch|fast_confirm|rowscan_pass)$")
#: ``TorchCodec``'s search and fetch methods before the motion layer held them
ENGINE_MOTION = ("_planes", "_fetch", "_band", "_confirm", "_full_search", "_fast_search_rowscan")


def _used_names(tree: ast.AST) -> set:
    """The names a module reads, called or not: ``f``, ``X.f`` and
    ``getattr(X, "f")`` (so that a dispatch table or a conditional
    expression counts as a call)."""
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            used.add(node.id)
        elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            used.add(node.attr)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "getattr" \
                and len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
            used.add(node.args[1].value)
    return used


def test_only_the_motion_layer_launches_the_search_and_fetch_kernels():
    """Among the package's modules, only ``core/motion.py`` (and the wrappers'
    own ``core/kernels.py``) calls the search, fetch, window, confirm and chain
    wrappers: each tool set's kernel choice is made in one place (the mesh
    solves its tiles' chain through ``motion.fast_chain``), and no module
    reaches into ``TorchCodec``'s search or fetch."""
    pkg = REPO / "streamoptima_tpu_torch"
    own = {pkg / "core" / "motion.py", pkg / "core" / "kernels.py"}
    callers, private = {}, {}
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        hits = sorted(n for n in _used_names(tree) if MOTION_CALLS.match(n))
        if hits and path not in own:
            callers[str(path.relative_to(REPO))] = hits
        reach = sorted({n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr in ENGINE_MOTION
                        and not (isinstance(n.value, ast.Name) and n.value.id == "self")})
        if reach and path not in own:
            private[str(path.relative_to(REPO))] = reach
    assert not callers, callers
    assert not private, private
    motion = _used_names(ast.parse((pkg / "core" / "motion.py").read_text()))
    assert {"pred_fetch", "pred_fetch_vbs", "pred_fetch_fme", "pred_fetch_fme_vbs", "window_fetch", "fast_confirm",
            "rowscan_pass", "fast_chain"} <= motion  # the layer holds what it says (the searches: by name)
