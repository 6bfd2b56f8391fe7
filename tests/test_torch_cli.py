"""PyTorch port: the command line (``python -m streamoptima_tpu_torch``),
``viz``, the facade's VBS overlay and ``profiling``, against the JAX
package's.

The command line on the CPU (``--device cpu``) and the JAX command line, on
the same argv and the same 4:2:0 input (seeded chroma, so the colour
pipeline reads real data), each in its own directory, write byte-equal
``mv.txt``, ``res.txt``, decoded and reconstructed YUV files, binary
container and overlay clip.  ``--mesh`` on the CPU (8 devices) writes the
bytes one device writes.  The refusals (``--engine compat`` with
``--binary``, ``--two-pass`` without ``--rc-flag``, and the default
``--device cuda`` without a card)
exit non-zero before anything is encoded.  Twins of
``tests/test_cli_facade.py::test_viz_helpers`` and the overlay half of
``test_facade_roundtrip``, and of ``tests/test_profiling.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, synthetic_clip

from streamoptima_tpu import viz as jviz
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu.config import CodecConfig as JaxCodecConfig
from streamoptima_tpu.io.video import VideoManager as JVM
from streamoptima_tpu.main import main as jax_main
from streamoptima_tpu_torch import CodecConfig, profiling, viz
from streamoptima_tpu_torch import main as cli
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.io.video import VideoManager

OUTPUTS = ("files/mvs_per_frame.txt", "files/res_per_frame.txt", "yuv/y_only_decoded.yuv",
           "yuv/y_only_reconstructed.yuv", "clip.sob")
# tests/test_cli_facade.py::test_cli_main's argv, and the command line's default tools (fast ME + VBS + FME)
ARGV = ["--height", "64", "--width", "64", "--frames", "4", "--search-range", "4", "--intra-dur", "2", "--qp", "4",
        "--binary", "clip.sob"]
WHOLE_PEL = ["--no-fast-me", "--no-fme", "--no-vbs"]


@pytest.fixture(scope="module")
def yuv420(tmp_path_factory):
    """The test clip as 4:2:0 with seeded chroma."""
    clip = synthetic_clip(h=64, w=64, frames=4)
    rng = np.random.default_rng(4)
    path = tmp_path_factory.mktemp("in") / "in.yuv"
    with open(path, "wb") as f:
        for fr in clip:
            f.write(fr.tobytes())
            f.write(rng.integers(0, 256, 64 * 64 // 2, dtype=np.uint8).tobytes())
    return str(path)


def _run(main, argv, where, monkeypatch) -> dict:
    where.mkdir()
    monkeypatch.chdir(where)
    assert main(argv) == 0
    return {f: (where / f).read_bytes() for f in OUTPUTS + (("ov.yuv",) if "--vbs-overlay" in argv else ())}


@pytest.mark.parametrize("tools", [WHOLE_PEL, ["--vbs-overlay", "ov.yuv"]], ids=["whole_pel", "default_tools"])
def test_cli_matches_jax_cli(tools, yuv420, tmp_path, monkeypatch):
    argv = ["--input", yuv420] + ARGV + tools
    port = _run(cli.main, argv + ["--device", "cpu"], tmp_path / "port", monkeypatch)
    jax = _run(jax_main, argv, tmp_path / "jax", monkeypatch)
    for f in port:
        assert port[f] == jax[f], f
    recon = np.frombuffer(port["yuv/y_only_reconstructed.yuv"], np.uint8).reshape(4, 64, 64)
    y = VideoManager(yuv420, 64, 64, 4).upscale_yuv420_to_yuv444()[:, 0]
    assert np.abs(recon.astype(int) - y).mean() < 40  # a reconstruction of the input's Y planes


def test_cli_mesh_on_cpu_writes_one_device_bytes(yuv420, tmp_path, monkeypatch, capsys):
    argv = ["--input", yuv420] + ARGV + WHOLE_PEL + ["--device", "cpu"]
    one = _run(cli.main, argv, tmp_path / "one", monkeypatch)
    mesh = _run(cli.main, argv + ["--mesh"], tmp_path / "mesh", monkeypatch)
    assert "Mesh: data=2 x tile=4 devices." in capsys.readouterr().out
    assert mesh == one


def _no_encode(*a, **k):
    raise AssertionError("a refused command line reached the codec")


@pytest.mark.parametrize("argv, message", [
    (["--engine", "compat", "--binary", "x.sob", "--device", "cpu"], "--binary requires --engine jax"),
    (["--two-pass", "--device", "cpu"], "--two-pass requires --rc-flag"),
    ([], "no CUDA card"),
    (["--mesh", "--device", "cuda:1"], "it takes --device cuda, not cuda:1"),
], ids=["compat", "two_pass_without_rc", "default_device_without_a_card", "mesh_on_an_indexed_card"])
def test_cli_refuses_before_encoding(argv, message, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "VideoCodec", _no_encode)
    with pytest.raises(SystemExit) as e:
        cli.main(["--synthetic", "--height", "32", "--width", "32", "--frames", "2"] + argv)
    assert message in str(e.value.code) and e.value.code not in (0, None)
    assert not os.listdir(tmp_path)


def test_module_without_a_card_exits_non_zero(tmp_path):
    """``python -m streamoptima_tpu_torch`` with no ``--device``, no card
    visible: a message and a non-zero exit, nothing written."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "streamoptima_tpu_torch", "--synthetic", "--frames", "2"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA card" in res.stderr, res.stderr
    assert not os.listdir(tmp_path)


# --------------------------------------------------- viz, overlay, profiling
def _cfg(frames=3, **kw):
    return dict(height=64, width=64, frames=frames, block_size=16, search_range=4, qp=4, intra_dur=2, **kw)


@pytest.fixture(scope="module")
def vbs_encode():
    """The port's and the JAX facade's encode of test_viz_helpers's config."""
    clip = synthetic_clip(h=64, w=64, frames=3)
    kw = _cfg(vbs_enable=True, lam=0.02)
    port = VideoCodec(CodecConfig(**kw), clip, device="cpu")
    jax = JaxVideoCodec(JaxCodecConfig(**kw), clip)
    return clip, port, port.encode(), jax, jax.encode()


def test_viz_helpers(vbs_encode, tmp_path):
    clip, port, pkg, _, jpkg = vbs_encode
    f = 1  # inter frame
    assert pkg["MVS per Frame"] == jpkg["MVS per Frame"]
    for mvs in pkg["MVS per Frame"]:
        np.testing.assert_array_equal(viz.mv_field(mvs, port.cfg), jviz.mv_field(mvs, port.cfg))
    viz.visualize_motion_vectors(clip[f], pkg["MVS per Frame"][f], port.cfg, save=tmp_path / "mv.png")
    viz.visualize_reference_frames(clip[f], pkg["MVS per Frame"][f], port.cfg, save=tmp_path / "rf.png")
    viz.plot_psnr_ssim(pkg["PSNR per frame"], pkg["SSIM per frame"], save=tmp_path / "q.png")
    viz.visualize_comparison(clip[0], pkg["reconstructed frames"][0], save=tmp_path / "cmp.png")
    for name in ("mv.png", "rf.png", "q.png", "cmp.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_facade_overlay_matches_jax(vbs_encode, tmp_path):
    clip, port, pkg, jax, jpkg = vbs_encode
    for tag, codec in (("t", port), ("j", jax)):
        codec.transmit_bitstream(tmp_path / f"{tag}mv.txt", tmp_path / f"{tag}res.txt")
        codec.decode_bitstream(tmp_path / f"{tag}mv.txt", tmp_path / f"{tag}res.txt")
        codec.save_decoded_frames(tmp_path / f"{tag}out.yuv", overlay_path=tmp_path / f"{tag}ovl.yuv")
    ov = np.fromfile(tmp_path / "tovl.yuv", dtype=np.uint8).reshape(3, 64, 64)
    assert (ov[:, ::16, :] == 0).all() and (ov[:, :, ::16] == 0).all()  # the block grid
    assert (tmp_path / "tovl.yuv").read_bytes() == (tmp_path / "jovl.yuv").read_bytes()
    np.testing.assert_array_equal(ov, jviz.vbs_overlay_frames(pkg["reconstructed frames"], jpkg["MVS per Frame"],
                                                              jpkg["frame_type_seq"], jax.cfg))
    # the overlay reads the list-form package
    arrays = VideoCodec(CodecConfig(**_cfg(vbs_enable=True, lam=0.02)), clip, device="cpu")
    arrays.encode(package=False)
    arrays.transmit_bitstream(tmp_path / "amv.txt", tmp_path / "ares.txt")
    arrays.decode_bitstream(tmp_path / "amv.txt", tmp_path / "ares.txt")
    with pytest.raises(ValueError, match="list-form package"):
        arrays.save_decoded_frames(tmp_path / "a.yuv", overlay_path=tmp_path / "aovl.yuv")


def test_time_steps_report_and_trace(tmp_path):
    clip = synthetic_clip(h=64, w=64, frames=2)
    cfg = CodecConfig(height=64, width=64, frames=2, search_range=2, qp=4, intra_dur=2)
    with profiling.trace(tmp_path / "trace") as prof:
        t = profiling.time_steps(cfg, clip, warmup=1, iters=2, device="cpu")
    assert set(t) == {"intra_s", "inter_s", "decode_inter_s", "decode_intra_s"}
    assert all(len(v) == 2 and all(x > 0 for x in v) for v in t.values())
    rep = profiling.report(t)
    assert "intra_s" in rep and "ms" in rep
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_viewers(tmp_path):
    clip = synthetic_clip(h=64, w=64, frames=1)
    viz.view_frame(clip[0], save=tmp_path / "f.png")
    yuv = np.stack([clip[0], np.full((64, 64), 128, np.uint8), np.full((64, 64), 128, np.uint8)])
    viz.view_frame_yuv(yuv, save=tmp_path / "yuv.png")
    raw = np.concatenate([clip[0].reshape(-1), np.full(64 * 64 // 2, 128, np.uint8)])
    vm = VideoManager(raw, 64, 64, 1)
    vm.upscale_yuv420_to_yuv444()
    rgb = vm.convert_yuv444_to_rgb()
    jvm = JVM(raw, 64, 64, 1)
    jvm.upscale_yuv420_to_yuv444()
    np.testing.assert_array_equal(rgb, jvm.convert_yuv444_to_rgb())
    viz.view_frame_rgb(rgb[0], save=tmp_path / "rgb.png")
    for f in ("f.png", "yuv.png", "rgb.png"):
        assert (tmp_path / f).stat().st_size > 0
