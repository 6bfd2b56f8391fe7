"""PyTorch port against the JAX package on random configurations, and the
two faults the two packages share, pinned.

Twin of ``tests/test_fuzz_roundtrip.py`` over the port's whole tool set:
bs 8 or 16, qp 0-7, sr 1-16, VBS, FME and fast ME each on or off, nref 1-4,
intra modes 0 and 1, parallel modes 0-3, rate control (``rc_flag`` 0-3,
promotion above ``intra_thresh``), two-pass and ROI maps, on small seeded
clips.  Each draw holds the port (``TorchCodec`` on the CPU, the kernels'
plain versions) to ``JaxCodec``: frame types, row QPs, MVs, coefficients,
sizes and reconstructions, the text and binary bitstream bytes, and the
in-memory, text and binary decodes.  Where the mesh takes the config (no
parallel mode), a CPU mesh of 2 to 4 devices encodes as one device does.
Every draw's decodes must equal the reconstructions.

Two faults make decode differ from the reconstructions in both packages
alike (the port's outputs equal the JAX engine's there too, so neither is a
divergence; both are the reference's behaviour, and the outputs are kept):

- A: intra mode 1 with VBS and rate control.  The text stream's row-head
  QP field of a split intra block holds its first sub-MV difference (quirk
  K11); under intra mode 1 a row head can be split, so the parsed row QPs
  differ.  The in-memory and binary decodes are exact.
- B: parallel mode 1 with promotion (``rc_flag > 1``).  The encoder codes a
  promoted frame intra; the decoder decodes every mode-1 frame as an inter
  frame against the all-128 plane.  No stream form decodes.

A draw whose encode meets A's or B's conditions (``_fault``: they depend on
the split and promotion decisions, so they are read from the encode) is
marked a strict expected failure, raised only by the decode ==
reconstruction check (``DecodeMismatch``): under A only the text decode's,
the in-memory and binary decodes held to the reconstructions before it;
under B every form's.  The parity checks before it must pass, and a draw
so marked whose decodes all close fails.  The seeds are
55-64, the first ten consecutive draws of ``_draw`` that hold both faults
(A at 55 and 59, B at 62 and 63), so that the expected failures run too.
``test_fault_a_*`` and ``test_fault_b_*`` pin each fault's reproducer.
"""
import numpy as np
import pytest
import torch

from conftest import synthetic_clip
from test_fuzz_roundtrip import TABLES
from test_parallel import _compare_packages

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu import binstream as JBIN
from streamoptima_tpu import bitstream as JBS
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch import binstream as TBIN
from streamoptima_tpu_torch import bitstream as TBS
from streamoptima_tpu_torch.engine import TorchCodec
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

torch.set_num_threads(1)


class DecodeMismatch(AssertionError):
    """A decode differs from the encoder's reconstructions."""


def _draw(seed: int) -> tuple[dict, int, int, str]:
    """One random configuration: (CodecConfig kwargs, clip motion, mesh
    devices, tile_comm)."""
    rng = np.random.default_rng(3000 + seed)
    bs = int(rng.choice([8, 16]))
    frames = int(rng.integers(2, 7))
    kw = dict(
        height=bs * int(rng.integers(2, 6)), width=bs * int(rng.integers(2, 7)), frames=frames, block_size=bs,
        qp=int(rng.integers(0, 8)), intra_dur=int(rng.choice([1, 2, 3, frames])),
        search_range=int(rng.integers(1, 17)), vbs_enable=bool(rng.integers(0, 2)),
        fme_enable=bool(rng.integers(0, 2)), fast_me=bool(rng.integers(0, 2)),
        n_ref_frames=int(rng.integers(1, 5)), intra_mode=int(rng.integers(0, 2)),
        parallel_mode=int(rng.choice([0, 0, 1, 2, 3])),
    )
    if kw["vbs_enable"]:
        kw["lam"] = float(rng.choice([0.0, 0.015, 0.3]))
    rc_flag = int(rng.integers(0, 4))
    if rc_flag:
        kw.update(rc_flag=rc_flag, target_br="480 kbps", frame_rate=30, qp_rate_tables=TABLES,
                  two_pass=bool(rng.integers(0, 2)))
        if rc_flag > 1:
            kw["intra_thresh"] = int(rng.choice([100, 1000, 10000]))
    if rng.integers(0, 3) == 0:
        kw["roi_qp_map"] = rng.integers(-3, 4, size=(kw["height"] // bs, kw["width"] // bs)).astype(np.int32)
    return kw, int(rng.integers(1, 4)), int(rng.integers(2, 5)), str(rng.choice(["halo", "all_gather"]))


def _fault(kw: dict, pkg: dict) -> str | None:
    """The shared fault whose conditions this encode meets, if any: A, an
    intra frame of intra mode 1 under rate control with a split block at
    the head of a stream row (where the writer puts the row's QP, K11); B, a
    frame of parallel mode 1 coded intra (only promotion does that)."""
    types = pkg["frame_type_seq"]
    if kw["parallel_mode"] == 1 and 0 in types:
        return "fault B"
    nbc = kw["width"] // kw["block_size"]
    if kw["intra_mode"] == 1 and kw.get("rc_flag", 0) > 0 and any(
            mvs[j][0] for ft, mvs in zip(types, pkg["MVS per Frame"]) if ft == 0 for j in range(0, len(mvs), nbc)):
        return "fault A"
    return None


def _lists(pkg):
    return pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]


def _frames(dec) -> np.ndarray:
    return np.stack([np.asarray(f) for f in dec])


def _both_ways(kw: dict, clip: np.ndarray, tmp_path) -> dict:
    """Encode with both packages, hold the port to ``JaxCodec`` on every
    output, stream byte and decode, and return the port's package and its
    three decodes (in-memory, text, binary)."""
    jpkg = JaxCodec(JaxCodecConfig(**kw), clip).encode()
    tpkg = TorchCodec(CodecConfig(**kw), clip, device="cpu").encode()
    assert tpkg["Qp_per_row_per_frame"] == jpkg["Qp_per_row_per_frame"]
    _compare_packages(jpkg, tpkg)  # frame types, sizes, reconstructions, MVs, coefficients, PSNR
    # the streams, read back with a bare config: ROI streams describe themselves
    bare = {k: v for k, v in kw.items() if k != "roi_qp_map"}
    files = {}
    for tag, (BS, BIN, Cfg, pkg) in {"j": (JBS, JBIN, JaxCodecConfig, jpkg), "t": (TBS, TBIN, CodecConfig, tpkg)}.items():
        mv, res, sob = tmp_path / f"{tag}mv.txt", tmp_path / f"{tag}res.txt", tmp_path / f"{tag}.sob"
        fts, res_l, qps, mvs = _lists(pkg)
        BS.write_bitstream(mv, res, fts, mvs, qps, res_l, Cfg(**kw))
        BIN.write_binary(sob, fts, mvs, qps, res_l, Cfg(**kw))
        files[tag] = [mv.read_bytes(), res.read_bytes(), sob.read_bytes()]
        text_cfg, bin_cfg = Cfg(**bare), Cfg(**bare)
        fts, mvs, qps, rs = BS.read_bitstream(mv, res, text_cfg)
        files[tag + "text"] = (text_cfg, (fts, rs, qps, mvs))
        fts, mvs, qps, rs = BIN.read_binary(sob, bin_cfg)
        files[tag + "bin"] = (bin_cfg, (fts, rs, qps, mvs))
    for a, b, what in zip(files["t"], files["j"], ("mv.txt", "res.txt", "binary container")):
        assert a == b, f"{what} bytes differ from the JAX package's"
    decodes = {}
    for form in ("memory", "text", "bin"):
        if form == "memory":
            (jcfg, jargs), (tcfg, targs) = (JaxCodecConfig(**kw), _lists(jpkg)), (CodecConfig(**kw), _lists(tpkg))
        else:
            (jcfg, jargs), (tcfg, targs) = files["j" + form], files["t" + form]
        got = _frames(TorchCodec(tcfg, device="cpu").decode(*targs))
        np.testing.assert_array_equal(got, _frames(JaxCodec(jcfg).decode(*jargs)),
                                      err_msg=f"the port's {form} decode differs from the JAX package's")
        decodes[form] = got
    return {"pkg": tpkg, "decodes": decodes}


def _require_closed(pkg: dict, decodes: dict) -> None:
    bad = [form for form, got in decodes.items() if not np.array_equal(got, pkg["reconstructed frames"])]
    if bad:
        raise DecodeMismatch(f"decodes differing from the reconstructions: {bad}")


@pytest.mark.parametrize("seed", range(55, 65))
def test_random_config_port_matches_jax(seed, tmp_path, request):
    kw, motion, n_dev, tile_comm = _draw(seed)
    clip = synthetic_clip(kw["height"], kw["width"], kw["frames"], motion=motion, seed=seed)
    out = _both_ways(kw, clip, tmp_path)
    if kw["parallel_mode"] == 0:  # the mesh runs every tool set but the parallel modes
        cfg = CodecConfig(**kw)
        mesh = ShardedCodec(cfg, make_mesh(cfg, devices=["cpu"] * n_dev), clip, tile_comm=tile_comm).encode()
        assert mesh["Qp_per_row_per_frame"] == out["pkg"]["Qp_per_row_per_frame"]
        _compare_packages(out["pkg"], mesh)
    fault, decodes = _fault(kw, out["pkg"]), out["decodes"]
    if fault == "fault A":  # the text stream's alone: the in-memory and binary decodes must close
        _require_closed(out["pkg"], {form: got for form, got in decodes.items() if form != "text"})
        decodes = {"text": decodes["text"]}
    if fault:
        request.applymarker(pytest.mark.xfail(strict=True, raises=DecodeMismatch, reason=fault))
    _require_closed(out["pkg"], decodes)


# each fault's smallest known reproducer: the config and tests/conftest.synthetic_clip of its shape
FAULT_A = dict(height=80, width=32, frames=2, qp=3, intra_dur=1, search_range=2, vbs_enable=True, lam=0.3,
               intra_mode=1, rc_flag=1, target_br="480 kbps", frame_rate=30, qp_rate_tables=TABLES)
FAULT_B = dict(height=64, width=64, frames=3, qp=4, intra_dur=3, search_range=4, parallel_mode=1, rc_flag=2,
               intra_thresh=100, target_br="480 kbps", frame_rate=30, qp_rate_tables=TABLES)


def test_fault_a_text_stream_loses_row_qps(tmp_path):
    """Intra mode 1 + VBS + RC: the port's decodes equal the JAX package's in
    every form; only the text stream's differs from the reconstructions,
    from the row QPs it parses."""
    out = _both_ways(FAULT_A, synthetic_clip(80, 32, 2), tmp_path)
    pkg, dec = out["pkg"], out["decodes"]
    assert pkg["frame_type_seq"] == [0, 0]
    recon = pkg["reconstructed frames"]
    assert np.array_equal(dec["memory"], recon) and np.array_equal(dec["bin"], recon)
    assert not np.array_equal(dec["text"], recon)
    fts, mvs, qps, res = TBS.read_bitstream(tmp_path / "tmv.txt", tmp_path / "tres.txt", CodecConfig(**FAULT_A))
    assert pkg["Qp_per_row_per_frame"][0] == [8, 8, 8, 8, 8] and qps[0] == [8, 8, 8, 8, 6]


def test_fault_b_parallel_mode_1_promotion_does_not_decode(tmp_path):
    """Parallel mode 1 + promotion: every frame is promoted; the port's
    decodes equal the JAX package's in every form, and none equals the
    reconstructions."""
    out = _both_ways(FAULT_B, synthetic_clip(64, 64, 3), tmp_path)
    pkg, dec = out["pkg"], out["decodes"]
    assert pkg["frame_type_seq"] == [0, 0, 0]
    for form, got in dec.items():
        assert not np.array_equal(got, pkg["reconstructed frames"]), form
