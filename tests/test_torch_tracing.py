"""The port's tracer (``profiling.tracer``): spans and counters inside the
codec, off by default.

On the CPU, at 64x64 with fast ME + VBS + FME: off, the codec records
nothing and a profiler sees none of its ranges; on, every frame is one
``engine.frame`` span under its encode or decode, spans nest in time and
carry their codec's request id, the counters equal the sizes of what was
copied, the outputs are the same as with the tracer off, and
``profiling.trace`` exports the spans beside the profiler's events.  The
per-frame launch counts need the card (``tests/test_torch_gpu.py``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from streamoptima_tpu_torch import CodecConfig, VideoCodec, binstream, profiling, synthetic_clip
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.engine import pack_stream
from streamoptima_tpu_torch.parallel import make_mesh
from streamoptima_tpu_torch.profile_main_path import _idle_by_span, _union
from streamoptima_tpu_torch.profiling import host_flag, to_device, to_host, tracer

CFG = CodecConfig(height=64, width=64, frames=6, search_range=16, qp=4, intra_dur=4, lam=0.015,
                  vbs_enable=True, fme_enable=True, fast_me=True)
SEQ = ("name", "id", "parent", "request", "t0", "t1", "attrs")


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


@pytest.fixture(scope="module")
def clip():
    return synthetic_clip(64, 64, CFG.frames)


def _spans() -> list[dict]:
    return [dict(zip(SEQ, r)) for r in tracer.records]


def _round_trip(clip, path):
    """Encode, write the binary container, read it back and decode: the
    container's bytes, the package and the decoded frames."""
    enc = VideoCodec(CFG, clip, device="cpu")
    pkg = enc.encode(compute_ssim=False, package=False)
    enc.transmit_bitstream_binary(path)
    frames = VideoCodec(CFG, device="cpu").decode_bitstream_binary(path)
    return path.read_bytes(), pkg, frames


def test_off_records_nothing(clip, tmp_path):
    assert not tracer.on
    _round_trip(clip, tmp_path / "c.sob")
    snap = tracer.snapshot()
    assert tracer.records == [] and snap == {"spans": {}, "host_syncs": {}, "d2h_bytes": {}, "h2d_bytes": {},
                                             "pageable_bytes": {}, "rle_frames": {}, "rle_decoded_frames": {},
                                             "search_positions": {}, "confirm_blocks": {}}


@pytest.mark.parametrize("on", [False, True])
def test_profiler_sees_the_spans_only_when_on(clip, tmp_path, on):
    from torch.profiler import ProfilerActivity, profile

    if on:
        tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _round_trip(clip, tmp_path / "c.sob")
    names = {e.name for e in prof.events() if e.name.startswith("streamoptima.")}
    if on:
        assert {"streamoptima.engine.frame", "streamoptima.engine.fast_chain", "streamoptima.sync.chain_flag",
                "streamoptima.binstream.write", "streamoptima.engine.pack_stream"} <= names
    else:
        assert names == set()


def test_outputs_identical_on_and_off(clip, tmp_path):
    off = _round_trip(clip, tmp_path / "off.sob")
    tracer.enable()
    on = _round_trip(clip, tmp_path / "on.sob")
    assert on[0] == off[0]
    np.testing.assert_array_equal(on[1]["reconstructed frames"], off[1]["reconstructed frames"])
    np.testing.assert_array_equal(on[2], off[2])
    assert on[1]["fast_me_passes"] == off[1]["fast_me_passes"]
    assert tracer.records


def test_one_frame_span_a_frame_under_its_encode_or_decode(clip, tmp_path):
    tracer.enable()
    _, pkg, _ = _round_trip(clip, tmp_path / "c.sob")
    spans = _spans()
    by_id = {s["id"]: s for s in spans}
    for root in ("engine.encode", "engine.decode"):
        frames = []
        for s in spans:
            if s["name"] == "engine.frame":
                above = by_id[s["parent"]]
                if above["name"] == root:
                    frames.append(s)
        assert [f["attrs"]["index"] for f in frames] == list(range(CFG.frames)), root
        assert [f["attrs"]["type"] for f in frames] == list(pkg["frame_type_seq"]), root
        assert all(f["attrs"]["launches"] == {} for f in frames)  # the plain versions launch no kernel
    assert sum(s["name"] == "engine.frame" for s in spans) == 2 * CFG.frames
    chains = [s for s in spans if s["name"] == "engine.fast_chain"]
    assert [c["attrs"]["passes"] for c in chains] == pkg["fast_me_passes"]
    assert all(by_id[c["parent"]]["name"] == "engine.inter_step" for c in chains)


def test_children_lie_inside_their_parents(clip, tmp_path):
    tracer.enable()
    _round_trip(clip, tmp_path / "c.sob")
    spans = _spans()
    by_id = {s["id"]: s for s in spans}
    children = [s for s in spans if s["parent"] is not None]
    assert children
    for s in children:
        p = by_id[s["parent"]]
        assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"], (s["name"], p["name"])
        assert s["request"] == p["request"]


def test_one_request_id_per_codec(clip, tmp_path):
    tracer.enable()
    a = VideoCodec(CFG, clip, device="cpu")
    a.encode(compute_ssim=False, package=False)
    a.transmit_bitstream_binary(tmp_path / "a.sob")
    b = VideoCodec(CFG, clip, device="cpu")
    b.encode(compute_ssim=False, package=False)
    roots = [s for s in _spans() if s["parent"] is None]
    by_codec = {}
    for s in roots:
        by_codec.setdefault(s["request"], set()).add(s["name"])
    assert len(by_codec) == 2
    assert by_codec[a._request] == {"engine.init", "engine.encode", "codec.fetch", "binstream.write"}
    assert by_codec[b._request] == {"engine.init", "engine.encode"}
    tracer.reset()
    dec = VideoCodec(CFG, device="cpu")
    dec.decode_bitstream_binary(tmp_path / "a.sob")
    dec.decode_bitstream_binary(tmp_path / "a.sob")
    calls = [s for s in _spans() if s["name"] in ("binstream.read", "engine.decode", "codec.finish")]
    assert len(calls) == 6 and len({s["request"] for s in calls}) == 2
    assert dec._request not in {s["request"] for s in calls}


def test_sync_counters_equal_the_copies(clip, tmp_path):
    tracer.enable()
    enc = VideoCodec(CFG, clip, device="cpu")
    pkg = enc.encode(compute_ssim=False, package=False)
    snap = tracer.snapshot()
    assert snap["host_syncs"]["chain_flag"] == sum(pkg["fast_me_passes"])
    assert snap["spans"]["sync.chain_flag"]["count"] == sum(pkg["fast_me_passes"])
    assert snap["host_syncs"]["package"] == 3 and "fetch" not in snap["host_syncs"]
    assert snap["h2d_bytes"] == {"clip": clip.nbytes}
    tracer.reset()
    enc.transmit_bitstream_binary(tmp_path / "c.sob")
    snap = tracer.snapshot()
    # the container's coefficients are coded by rle_pack where they lie: one copy of its buffer
    _, s0 = K.rle_pack_layout(CFG.frames, CFG.n_blocks)
    assert snap["host_syncs"] == {"fetch": 1}
    assert snap["d2h_bytes"] == {"fetch": 2 * (s0 + sum(pkg["residual size per frame"]))}
    assert snap["pageable_bytes"] == {"d2h": snap["d2h_bytes"]["fetch"]}
    assert snap["rle_frames"] == {"device": CFG.frames}
    assert snap["spans"]["codec.fetch"]["count"] == 1 and snap["spans"]["binstream.write"]["count"] == 1
    assert "binstream.rle_encode" not in snap["spans"]


def test_confirm_blocks_by_route(clip):
    """A fast-ME encode's confirm: every inter frame's blocks on the CPU
    take the plain route, and no frame launches ``fast_confirm`` (on a card,
    one a frame: ``tests/test_torch_gpu.py``)."""
    tracer.enable()
    n0 = K.fast_confirm.launches
    pkg = VideoCodec(CFG, clip, device="cpu").encode(compute_ssim=False, package=False)
    n_inter = pkg["frame_type_seq"].count(1)
    assert n_inter == 4
    assert tracer.snapshot()["confirm_blocks"] == {"plain": CFG.n_blocks * n_inter}
    frames = [s["attrs"] for s in _spans() if s["name"] == "engine.frame"]
    assert len(frames) == CFG.frames
    assert all(f["launches"].get("fast_confirm", 0) == 0 for f in frames)
    assert K.fast_confirm.launches == n0
    assert sum(s["name"] == "engine.confirm" for s in _spans()) == n_inter


@pytest.mark.parametrize("decoder", ["torch", "compat", "mesh"])
def test_upload_counter_equals_the_packed_stream(clip, tmp_path, decoder):
    """Every decoder (``TorchCodec``, ``CompatCodec``, ``ShardedCodec`` on a
    (2, 2) CPU mesh) uploads the packed stream once, through
    ``engine.upload_stream``: its bytes under ``h2d_bytes["stream"]``, but
    for a binary container's coded lists (``torch`` and ``mesh``), which go
    in one copy under ``h2d_bytes["container"]`` and are decoded there."""
    cfg = dataclasses.replace(CFG, engine="compat") if decoder == "compat" else CFG
    enc = VideoCodec(cfg, clip, device="cpu")
    if decoder == "compat":  # the reference-exact engine has no binary container: its list forms
        pkg = enc.encode(compute_ssim=False)
        fts, mvs, qps, res = (pkg[k] for k in ("frame_type_seq", "MVS per Frame", "Qp_per_row_per_frame",
                                               "approx residual"))
    else:
        enc.encode(compute_ssim=False, package=False)
        enc.transmit_bitstream_binary(tmp_path / "c.sob")
        fts, mvs, qps, res = binstream.read_binary(tmp_path / "c.sob", cfg)
    mv_all, smv_all, split_all, pay_all, _ = pack_stream(cfg, fts, res, mvs, qps)
    dec = VideoCodec(cfg, mesh=make_mesh(cfg, devices=["cpu"] * 4)) if decoder == "mesh" else VideoCodec(cfg,
                                                                                                          device="cpu")
    tracer.enable()
    frames = dec.decode(fts, res, qps, mvs)
    snap = tracer.snapshot()
    if decoder == "compat":
        assert snap["h2d_bytes"] == {"stream": sum(a.nbytes for a in (mv_all, smv_all, split_all, pay_all))}
        assert snap["rle_decoded_frames"] == {}
    else:  # the container's fields as the file holds them, each frame's at a multiple of 16 bytes
        symbols = sum(len(r.data[r.chunk[0]:r.chunk[1]]) for r in res)
        head = K.rle_unpack_head(CFG.frames, CFG.n_blocks)
        assert symbols <= pay_all.nbytes <= head + symbols + 16 * (CFG.frames + 1)
        assert snap["h2d_bytes"] == {"stream": sum(a.nbytes for a in (mv_all, smv_all, split_all)),
                                     "container": pay_all.nbytes}
        assert snap["rle_decoded_frames"] == {"device": CFG.frames}
    assert snap["host_syncs"] == {"finish": 1} and snap["d2h_bytes"] == {"finish": frames.nbytes}
    names = [s["name"] for s in _spans()]
    assert names.count("engine.pack_stream") == names.count("engine.upload_stream") == 1


def test_helpers_count_and_return_what_the_plain_calls_do():
    t = torch.arange(12, dtype=torch.int16).reshape(3, 4)
    flag = torch.tensor(True)
    a = np.arange(5, dtype=np.int32)
    off = (to_host(t, "x"), host_flag(flag, "y"), to_device(a, "cpu", "z"))
    assert tracer.snapshot()["host_syncs"] == {}
    tracer.enable()
    on = (to_host(t, "x"), host_flag(flag, "y"), to_device(a, "cpu", "z"))
    np.testing.assert_array_equal(on[0], off[0])
    assert on[1] is off[1] is True
    assert torch.equal(on[2], off[2])
    snap = tracer.snapshot()
    assert snap["host_syncs"] == {"x": 1, "y": 1}
    assert snap["d2h_bytes"] == {"x": 24, "y": 1} and snap["h2d_bytes"] == {"z": 20}
    assert snap["pageable_bytes"] == {"d2h": 25, "h2d": 20}
    assert set(snap["spans"]) == {"sync.x", "sync.y"}
    tracer.reset()
    assert tracer.snapshot()["host_syncs"] == {} and tracer.records == []


def test_trace_exports_the_spans_beside_the_profiler_events(clip, tmp_path):
    with profiling.trace(tmp_path / "t"):
        _round_trip(clip, tmp_path / "c.sob")
    assert not tracer.on
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert {"streamoptima.engine.encode", "streamoptima.engine.frame", "streamoptima.codec.fetch",
            "streamoptima.binstream.read", "streamoptima.codec.finish"} <= names
    dump = json.loads((tmp_path / "t" / "spans.json").read_text())
    frames = [s for s in dump["spans"] if s["name"] == "engine.frame"]
    assert len(frames) == 2 * CFG.frames and {"index", "type", "launches"} <= set(frames[0]["attrs"])
    assert dump["snapshot"]["spans"]["engine.frame"]["count"] == 2 * CFG.frames


def test_idle_gaps_are_named_by_the_innermost_span_covering_most():
    assert _union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    spans = [("engine.encode", 0, 100), ("engine.fast_chain", 10, 40), ("sync.chain_flag", 20, 38),
             ("codec.fetch", 60, 100), ("sync.fetch", 61, 62)]
    gaps = [(12, 30), (31, 37), (45, 50), (60, 80), (95, 110), (120, 125)]
    got = _idle_by_span(gaps, spans)
    assert got == pytest.approx({"sync.chain_flag": 24e-6, "engine.encode": 20e-6, "codec.fetch": 20e-6,
                                 "outside spans": 5e-6})
