"""The kernel count files at 720p give the bounds ``chip_smoke.py`` recorded for the
same calls (PERF.md section 6's bound column, in ms to four decimals)."""
from __future__ import annotations

import json

import pytest

from conftest import REPO
from portbench.harness.runner import load_module

PEAKS = json.loads((REPO / "portbench/peaks.json").read_text())
BASE = {"height": 720, "width": 1280, "frames": 16, "block_size": 16, "search_range": 8, "qp": 4, "intra_dur": 8,
        "vbs_enable": False, "fme_enable": False, "fast_me": False, "n_ref_frames": 1}
FAST = {"search_range": 16, "vbs_enable": True, "fme_enable": True, "fast_me": True}
IPPP = [{"type": 0 if i % 8 == 0 else 1, "nsplit": 0} for i in range(16)]
NREF4 = [{"type": 0 if i == 0 else 1, "nsplit": 0} for i in range(16)]  # frame 4 has four references

#: (kernel, config over BASE, launch, frames, recorded bound in ms, what chip_smoke timed)
RECORDED = [
    ("full_search_kernel", {}, {"template": ["false", "16", "true"], "nth": 0}, IPPP, 0.0154, "[main], sr 8"),
    ("full_search_kernel", {"n_ref_frames": 4}, {"template": ["false", "16", "true"], "nth": 3}, NREF4, 0.0615,
     "four refs"),
    ("full_search_kernel", {"vbs_enable": True}, {"template": ["true", "16", "true"], "nth": 0}, IPPP, 0.0159, "VBS"),
    ("full_search_kernel", {"vbs_enable": True, "n_ref_frames": 4}, {"template": ["true", "16", "true"], "nth": 3},
     NREF4, 0.0636, "VBS, four refs"),
    ("full_search_kernel", {"vbs_enable": True, "search_range": 16}, {"template": ["true", "16", "true"], "nth": 0},
     IPPP, 0.0589, "VBS, sr 16"),
    ("pred_fetch_kernel", {}, {}, IPPP, 0.0008, "whole-pel"),
    ("pred_fetch_kernel", {"vbs_enable": True}, {}, IPPP, 0.0014, "whole-pel with the quads"),
    ("pred_fetch_kernel", {"fme_enable": True}, {}, IPPP, 0.0008, "FME"),
    ("pred_fetch_kernel", FAST, {}, IPPP, 0.0014, "FME with the quads"),
    ("window_fetch_kernel", FAST, {}, IPPP, 0.0025, "FME (3600, 4, 18, 18)"),
    ("window_fetch_kernel", {"fast_me": True, "search_range": 16}, {}, IPPP, 0.0006, "whole-pel (3600, 1, 18, 18)"),
    ("rowscan_pass_kernel", FAST, {"template": ["2", "4"]}, IPPP, 0.0014, "FME"),
    ("rowscan_pass_kernel", {"fast_me": True, "search_range": 16}, {"template": ["2", "1"]}, IPPP, 0.0006,
     "whole-pel"),
    ("intra_recon_kernel", FAST, {}, IPPP, 0.0025, "sr 16 with VBS"),
    ("intra_recon_kernel", {}, {}, IPPP, 0.0014, "[main]'s sr 8"),
    ("intra_search_kernel", FAST, {}, IPPP, 0.0025, "sr 16 with VBS"),
    ("intra_search_kernel", {}, {}, IPPP, 0.0014, "[main]'s sr 8"),
    ("transform_select_kernel", FAST, {"nth": 1}, IPPP, 0.0044, "the fast path's inter step"),
    ("transform_select_kernel", FAST, {"nth": 0}, IPPP, 0.0044, "its intra step"),
    ("transform_select_kernel", {}, {"nth": 1}, IPPP, 0.0033, "[main]'s inter step"),
    ("residual_recon_kernel", FAST, {"nth": 0, "span": "encode"}, IPPP, 0.0044, "an intra frame (int32)"),
    ("residual_recon_kernel", FAST, {"nth": 1, "span": "encode"}, IPPP, 0.0019, "the fast path's encode"),
    ("residual_recon_kernel", {}, {"nth": 1, "span": "encode"}, IPPP, 0.0019, "[main]'s inter step"),
]


def bound_ms(kernel, over, launch, frames) -> float:
    mod = load_module(REPO / "portbench/kernels" / f"{kernel}.py")
    nbytes, ops = mod.count({"template": [], "nth": 0, "span": "encode", **launch}, {**BASE, **over}, frames)
    rate = PEAKS["sms"] * PEAKS["int32_lanes_per_sm"] * PEAKS["sm_clock_hz"]
    return 1e3 * max(nbytes / PEAKS["hbm_bytes_per_s"], ops / rate)


@pytest.mark.parametrize("kernel, over, launch, frames, recorded, what", RECORDED,
                         ids=[f"{r[0]}:{r[5]}" for r in RECORDED])
def test_count_gives_the_recorded_bound(kernel, over, launch, frames, recorded, what):
    assert round(bound_ms(kernel, over, launch, frames), 4) == recorded


def test_decode_recon_counts_the_variant_each_block_uses():
    """``residual_recon``'s decode call: int16 coefficients; its multiply-adds fall as blocks split."""
    frames = [dict(f, nsplit=0) for f in IPPP]
    split = [dict(f, nsplit=1800) for f in IPPP]
    a = bound_ms("residual_recon_kernel", FAST, {"nth": 1, "span": "decode"}, frames)
    b = bound_ms("residual_recon_kernel", FAST, {"nth": 1, "span": "decode"}, split)
    assert a > b > 0
    assert round(a, 4) == 0.0018  # unsplit: 3600 blocks' 16-point IDCTs, just above the 0.0014 ms of bytes


def test_every_count_file_is_a_kernel_with_a_count():
    files = sorted(p for p in (REPO / "portbench/kernels").glob("*.py") if not p.stem.startswith("_"))
    assert files
    for p in files:
        assert callable(load_module(p).count)
