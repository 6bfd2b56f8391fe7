"""The benchmark's ``full-vbs-fme-nref4-1088p`` configuration (half-pel full
search with VBS over up to four references) at a tiny size on the CPU.

``VideoCodec`` against the benchmark's plain reference
(``portbench.reference.ReferenceEncoder``) on segments of the
``segments-encode`` traffic: the binary container's bytes, the
reconstructions, and the container decoded back; the FIFO reaches four
references, and MVs name the fourth.  Then the half-pel search's kernel
count (``portbench/kernels/full_search_fme_kernel.py``) against a count by
hand, the two search metrics' readers on a synthetic profile, and the
tracer's ``engine.search`` span and ``search_positions`` counter.  The
kernels themselves at the production shape are ``tests/test_torch_gpu.py``'s.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness.correct import reference_slots  # noqa: E402
from portbench.harness.generator import segment_pool  # noqa: E402
from portbench.harness.runner import load_module  # noqa: E402
from portbench.reference import ReferenceEncoder  # noqa: E402
from streamoptima_tpu_torch import CodecConfig, VideoCodec  # noqa: E402
from streamoptima_tpu_torch.core import kernels as K  # noqa: E402
from streamoptima_tpu_torch.core.me import valid_candidates  # noqa: E402
from streamoptima_tpu_torch.profiling import tracer  # noqa: E402

CONF = json.loads((REPO / "portbench/configs/full-vbs-fme-nref4-1088p.json").read_text())
TRAFFIC = json.loads((REPO / "portbench/traffic/segments-encode.json").read_text())
#: the configuration cut to a tiny frame and range; every tool (FME, VBS, full search, four references) kept
TINY = dict(CONF["codec"], height=48, width=64, search_range=4)
PEAKS = json.loads((REPO / "portbench/peaks.json").read_text())
COUNT = load_module(REPO / "portbench/kernels/full_search_fme_kernel.py")
SEARCH_MS = load_module(REPO / "portbench/metrics/search_ms_per_inter_frame.py")
SEARCH_ROOFLINE = load_module(REPO / "portbench/metrics/search_roofline.py")


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


def test_configuration_states_the_deployment():
    codec = CONF["codec"]
    assert (codec["height"], codec["width"], codec["frames"], codec["search_range"]) == (1088, 1920, 16, 16)
    assert codec["vbs_enable"] and codec["fme_enable"] and not codec["fast_me"] and codec["n_ref_frames"] == 4
    assert CONF["reduced"] == [] and set(CONF["assumed"]) == {"qp", "intra_dur", "height"}
    CodecConfig(**codec)  # the program takes it as it stands


@pytest.mark.parametrize("seed", [11, 2**33 + 19])
def test_program_equals_reference_at_four_references(seed, tmp_path):
    """The pool slots a run of the seed compares: the container's bytes, the
    reconstructions and the binary decode."""
    cfg = CodecConfig(**TINY)
    pool = segment_pool(TINY["height"], TINY["width"], TRAFFIC, seed)
    ref = ReferenceEncoder(TINY, "cpu")
    tracer.enable()
    for slot in sorted(reference_slots(TRAFFIC, seed)):
        frames = pool[slot]["frames"]
        path = tmp_path / f"{slot}.sob"
        enc = VideoCodec(cfg, frames, device="cpu")
        pkg = enc.encode(compute_ssim=False, package=False)
        enc.transmit_bitstream_binary(str(path))
        want_bytes, want_recon = ref.encode(frames)
        assert path.read_bytes() == want_bytes
        np.testing.assert_array_equal(pkg["reconstructed frames"], want_recon)
        decoded = VideoCodec(cfg, device="cpu").decode_bitstream_binary(str(path))
        np.testing.assert_array_equal(np.asarray(decoded), want_recon)
        inter = [o for o, ft in zip(pkg["per_frame"], pkg["frame_type_seq"]) if ft == 1]
        assert max(int(o["mv"][:, 2].max()) for o in inter) == 3  # a block predicts from the fourth reference
        assert max(int(o["sub_mv"][..., 2].max()) for o in inter) == 3  # and a quad
    searched = [r[6]["refs"] for r in tracer.records if r[0] == "engine.search"]
    assert max(searched) == 4
    assert set(tracer.search_positions) == {"full_search_fme_vbs"}


# ------------------------------------------------------------ the count file
def _hand(h: int, w: int, bs: int, sr: int, fme: bool = True, vbs: bool = True) -> tuple[int, int]:
    """By loops: (the candidates valid for a block or, with VBS, one of its
    quads, the abs-diffs they need: bs^2 where the block is valid, else
    (bs / 2)^2 a valid quad).  An n x n block at grid (gx, gy) + (dx, dy) is
    valid where 0 <= g and g + m n < D on each axis: m = 3 with the FME
    margin on the (2h - 1, 2w - 1) grid, m = 1 on the whole-pel (h, w)."""
    f, m, s = (2, 3, bs // 2) if fme else (1, 1, bs // 2)
    H, W = f * (h - 1) + 1, f * (w - 1) + 1
    cands = diffs = 0
    for by in range(0, h, bs):
        for bx in range(0, w, bs):
            for dy in range(-f * sr, f * sr + 1):
                for dx in range(-f * sr, f * sr + 1):
                    def ok(x, y, n):
                        return 0 <= f * x + dx < W - m * n and 0 <= f * y + dy < H - m * n
                    quads = [ok(bx + qx, by + qy, s) for qy in (0, s) for qx in (0, s)] if vbs else []
                    cands += ok(bx, by, bs) or any(quads)
                    diffs += bs * bs if ok(bx, by, bs) else s * s * sum(quads)
    return cands, diffs


@pytest.mark.parametrize("vbs", [True, False])
def test_count_file_equals_a_count_by_hand(vbs):
    cfg = {"height": 48, "width": 64, "block_size": 16, "search_range": 3, "vbs_enable": vbs, "n_ref_frames": 4}
    frames = [{"type": int(i % 8 != 0), "nsplit": 0} for i in range(16)]
    _, diffs = _hand(48, 64, 16, 3, vbs=vbs)
    template = ["true" if vbs else "false", "16"]
    px, nb = 48 * 64, 12
    # the nth inter launch: frames 1..7 and 9..15 search 1, 2, 3, 4, 4, 4, 4 references
    for nth, nref in ((0, 1), (2, 3), (3, 4), (6, 4), (7, 1), (10, 4)):
        nbytes, ops = COUNT.count({"template": template, "nth": nth, "span": "encode"}, cfg, frames)
        assert ops == diffs * nref // COUNT.PACKED  # two abs-diffs to an operation
        assert nbytes == (1 + 4 * nref) * px + nb * (5 if vbs else 1) * 17
    assert COUNT.count({"template": template, "nth": 14, "span": "encode"}, cfg, frames) is None


def test_count_file_gives_the_recorded_bound():
    """At 720p, sr 8, one reference, VBS: below the 0.0297 ms packed basis
    recorded for the kernel (PERF.md, kernel 2) by the quads' share, which
    that basis charged a whole block's pixels."""
    cfg = {"height": 720, "width": 1280, "block_size": 16, "search_range": 8, "vbs_enable": True,
           "n_ref_frames": 1}
    nbytes, ops = COUNT.count({"template": ["true", "16"], "nth": 0}, cfg, [{"type": 0}, {"type": 1}])
    rate = PEAKS["sms"] * PEAKS["int32_lanes_per_sm"] * PEAKS["sm_clock_hz"]
    assert ops / rate > nbytes / PEAKS["hbm_bytes_per_s"]
    assert round(1e3 * ops / rate, 4) == 0.0292


@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("vbs", [False, True])
def test_valid_candidates_from_the_shapes_equal_a_count_by_hand(fme, vbs):
    """The tracer's count, whole frames and row bands of a frame (the mesh's
    instances) alike."""
    whole = valid_candidates(48, 64, 16, 3, fme=fme, vbs=vbs)
    assert whole == _hand(48, 64, 16, 3, fme, vbs)[0]
    assert sum(valid_candidates(16, 64, 16, 3, fme=fme, vbs=vbs, row0=r, H=48) for r in (0, 16, 32)) == whole


# ------------------------------------------------------------ the readers
def _run(ops, kind="encode", kernels=True):
    frames = [{"type": int(i % 8 != 0), "nsplit": 0} for i in range(16)]
    prof = {"ops": ops, "segments": [{"slot": 0, "frames": 16, "frame_info": frames}] * 2, "frames": 32,
            "window_s": 1.0, "busy_s": 0.5}
    cfg = dict(CONF["codec"], height=48, width=64, search_range=3)
    return {"kind": kind, "cfg": cfg, "profile": prof, "peaks": PEAKS,
            "kernels": {"full_search_fme_kernel": COUNT} if kernels else {}}


def _op(base, seg, nth, dur, span="encode"):
    return {"name": base, "base": base, "template": ["true", "16"], "seg": seg, "span": span, "nth": nth,
            "dur_s": dur}


def test_search_readers_on_a_synthetic_profile():
    ops = [_op("full_search_fme_kernel", seg, nth, 1e-3 * (nth + 1)) for seg in (0, 1) for nth in range(14)]
    ops += [_op("pred_fetch_kernel", 0, 0, 5e-3), _op("full_search_fme_kernel", 1, 14, 9.0, span="write")]
    run = _run(ops)
    # 2 segments x 14 inter frames; each segment's launches last 1 .. 14 ms
    assert SEARCH_MS.read(run) == pytest.approx(2 * 105 / 28)
    rate = PEAKS["sms"] * PEAKS["int32_lanes_per_sm"] * PEAKS["sm_clock_hz"]
    least = 0.0
    for nth in range(14):
        nbytes, n_ops = COUNT.count({"template": ["true", "16"], "nth": nth}, run["cfg"],
                                    run["profile"]["segments"][0]["frame_info"])
        least += 2 * max(nbytes / PEAKS["hbm_bytes_per_s"], n_ops / rate)
    assert SEARCH_ROOFLINE.read(run) == pytest.approx(100 * least / (2 * 0.105))


@pytest.mark.parametrize("case", ["decode", "untraced", "no_launches", "no_count_file"])
def test_search_readers_read_nothing_where_there_is_nothing(case):
    ops = [_op("full_search_fme_kernel", 0, 0, 1e-3)]
    run = {"decode": lambda: _run(ops, kind="decode"), "untraced": lambda: dict(_run(ops), profile=None),
           "no_launches": lambda: _run([_op("rowscan_pass_kernel", 0, 0, 1e-3)]),
           "no_count_file": lambda: _run(ops, kernels=False)}[case]()
    assert SEARCH_ROOFLINE.read(run) is None
    if case != "no_count_file":  # the time needs no count
        assert SEARCH_MS.read(run) is None


# ------------------------------------------------------------ the tracer
def _encode(cfg, frames):
    enc = VideoCodec(cfg, frames, device="cpu")
    return enc.encode(compute_ssim=False, package=False)


def test_search_span_and_positions():
    cfg = CodecConfig(**TINY)
    frames = segment_pool(TINY["height"], TINY["width"], TRAFFIC, 3)[1]["frames"]
    tracer.enable()
    pkg = _encode(cfg, frames)
    spans = {r[1]: r for r in tracer.records}
    searches = [r for r in tracer.records if r[0] == "engine.search"]
    assert [r[6]["refs"] for r in searches] == [1, 2, 3, 4, 4, 4, 4] * 2
    assert all(spans[r[2]][0] == "engine.inter_step" for r in searches)
    fetches = [r for r in tracer.records if r[0] == "engine.fetch"]
    assert len(fetches) == 14 and all(spans[r[2]][0] == "engine.search" for r in fetches)
    cands, _ = _hand(TINY["height"], TINY["width"], 16, TINY["search_range"])
    assert tracer.snapshot()["search_positions"] == {"full_search_fme_vbs": cands * (1 + 2 + 3 + 4 * 4) * 2}
    assert sum(ft == 1 for ft in pkg["frame_type_seq"]) == len(searches)


@pytest.mark.parametrize("tools", ["whole", "vbs", "fme"])
def test_search_positions_in_the_other_modes(tools):
    over = {"whole": {"vbs_enable": False, "fme_enable": False}, "vbs": {"fme_enable": False},
            "fme": {"vbs_enable": False}}[tools]
    cfg = CodecConfig(**dict(TINY, frames=5, intra_dur=4, n_ref_frames=2, **over))
    frames = segment_pool(48, 64, dict(TRAFFIC, frames=5), 4)[0]["frames"]
    tracer.enable()
    _encode(cfg, frames)
    cands, _ = _hand(48, 64, 16, TINY["search_range"], fme=cfg.fme_enable, vbs=cfg.vbs_enable)
    name = {"whole": "full_search", "vbs": "full_search_vbs", "fme": "full_search_fme"}[tools]
    assert tracer.snapshot()["search_positions"] == {name: cands * (1 + 2 + 2)}
    assert [r[6]["refs"] for r in tracer.records if r[0] == "engine.search"] == [1, 2, 2]


def test_tracer_off_records_no_search():
    cfg = CodecConfig(**TINY)
    frames = segment_pool(TINY["height"], TINY["width"], TRAFFIC, 3)[1]["frames"]
    n0 = K.full_search_fme_vbs.launches
    _encode(cfg, frames)
    assert tracer.records == [] and tracer.snapshot()["search_positions"] == {}
    assert K.full_search_fme_vbs.launches == n0  # the CPU runs the plain versions: no launch
