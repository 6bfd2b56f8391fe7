"""Each metric reader on a canned run, and the trace reduction on canned events."""
from __future__ import annotations

import json

import pytest

from conftest import REPO
from portbench.harness.runner import load_module
from portbench.harness.trace import kernel_name, reduce_events

METRICS = REPO / "portbench/metrics"
CFG = json.loads((REPO / "portbench/configs/fast-vbs-fme-720p.json").read_text())["codec"]
FRAMES = [{"type": 0 if i % 8 == 0 else 1, "nsplit": 0} for i in range(16)]


def read(name, run):
    return load_module(METRICS / f"{name}.py").read(run)


def canned_profile() -> dict:
    """Two segments of 100 us each; device work 10-30 and 50-60 us in the first
    (the encode span 8-70), 120-140 us in the second; spans upload 0-8, encode 8-70,
    write 70-100 and 100-200 as encode."""
    ranges = [("portbench.segment.0", 0, 100), ("portbench.segment.1", 100, 200), ("portbench.upload", 0, 8),
              ("portbench.encode", 8, 70), ("portbench.write", 70, 100), ("portbench.encode", 100, 200)]
    ops = [("void (anonymous namespace)::transform_select_kernel(int const*)", 10, 30),
           ("Memcpy DtoH (Device -> Pageable)", 50, 60),
           ("void (anonymous namespace)::transform_select_kernel(int const*)", 120, 140),
           ("void (anonymous namespace)::transform_select_kernel(int const*)", 300, 310)]  # outside: not counted
    segs = [{"slot": 0, "frames": 16, "frame_info": FRAMES}, {"slot": 1, "frames": 16, "frame_info": FRAMES}]
    return reduce_events(ranges, ops, segs)


def canned_run(kind="encode", profile=True) -> dict:
    return {"kind": kind, "cfg": CFG, "setup_s": 12.5,
            "window": {"window_s": 2.0, "latencies_s": [0.1 * (i + 1) for i in range(20)], "frames": 320,
                       "counters": {"fast_me_passes": [1, 2, 3, 2]}},
            "spans": {"upload": 0.32, "encode": 0.64, "write": 0.96, "read": 0.16, "decode": 0.48},
            "profile": canned_profile() if profile else None,
            "peaks": json.loads((REPO / "portbench/peaks.json").read_text()),
            "kernels": {"transform_select_kernel": load_module(REPO / "portbench/kernels/transform_select_kernel.py")}}


def test_trace_reduction():
    p = canned_profile()
    assert p["window_s"] == pytest.approx(200e-6)
    assert p["busy_s"] == pytest.approx(50e-6)
    assert p["frames"] == 32
    assert [(o["base"], o["seg"], o["span"], o["nth"]) for o in p["ops"]] == [
        ("transform_select_kernel", 0, "encode", 0), ("Memcpy DtoH", 0, "encode", 0),
        ("transform_select_kernel", 1, "encode", 0)]
    idle = dict((n, s) for n, s in p["breakdown"]["idle_gaps"] if n.startswith("idle in"))
    # each gap goes to the span that covers most of it: 0-10 upload (8 of 10), 30-50 encode, 60-100 write (30
    # of 40), 100-120 and 140-200 encode
    assert idle["idle in upload"] == pytest.approx(10e-6)
    assert idle["idle in encode"] == pytest.approx((20 + 20 + 60) * 1e-6)
    assert idle["idle in write"] == pytest.approx(40e-6)
    assert sum(idle.values()) == pytest.approx(150e-6)
    assert p["breakdown"]["device_ops"][0] == ["transform_select_kernel", pytest.approx(40e-6)]


def test_kernel_names():
    assert kernel_name("void (anonymous namespace)::rowscan_pass_kernel<2, 4>(CUtensorMap, int)") == (
        "rowscan_pass_kernel<2, 4>", "rowscan_pass_kernel", ["2", "4"])
    assert kernel_name("Memcpy HtoD (Pageable -> Device)")[1] == "Memcpy HtoD"
    assert kernel_name("void at::native::reduce_kernel<512, 1>(at::R)")[1] == "reduce_kernel"


def test_end_to_end_readers():
    run = canned_run()
    assert read("encode_fps", run) == pytest.approx(160.0)
    assert read("encode_segment_p95_ms", run) == pytest.approx(1905.0)  # numpy's linear 95th of 100..2000 ms
    assert read("setup_s", run) == 12.5
    assert read("decode_fps", run) is None
    dec = canned_run("decode")
    assert read("decode_fps", dec) == pytest.approx(160.0)
    assert read("encode_fps", dec) is None and read("encode_segment_p95_ms", dec) is None


def test_span_readers():
    run = canned_run()
    assert read("write_ms_per_frame.encode", run) == pytest.approx(3.0)
    assert read("engine_ms_per_frame.encode", run) == pytest.approx(3.0)
    dec = canned_run("decode")
    assert read("read_ms_per_frame.decode", dec) == pytest.approx(0.5)
    assert read("engine_ms_per_frame.decode", dec) == pytest.approx(1.5)
    assert read("write_ms_per_frame.encode", dec) is None
    run["spans"] = {}
    assert read("write_ms_per_frame.encode", run) is None


def test_counter_and_trace_readers():
    run = canned_run()
    assert read("fastme_passes_per_inter_frame", run) == pytest.approx(2.0)
    assert read("device_ops_per_frame.encode", run) == pytest.approx(3 / 32)
    assert read("device_idle.encode", run) == pytest.approx(75.0)
    # the roofline: two transform_select launches (frame 0, intra) of 20 us each against their least time
    nbytes, ops = run["kernels"]["transform_select_kernel"].count({"nth": 0, "span": "encode", "template": []},
                                                                  CFG, FRAMES)
    p = run["peaks"]
    least = max(nbytes / p["hbm_bytes_per_s"], ops / (p["sms"] * p["int32_lanes_per_sm"] * p["sm_clock_hz"]))
    assert read("kernel_roofline.encode", run) == pytest.approx(100 * least / 20e-6)
    assert read("kernel_roofline.decode", run) is None
    untraced = canned_run(profile=False)
    for name in ("device_ops_per_frame.encode", "device_idle.encode", "kernel_roofline.encode"):
        assert read(name, untraced) is None
    run["window"]["counters"] = {}
    assert read("fastme_passes_per_inter_frame", run) is None
