"""The plain reference under rate control, against the program on the CPU at a tiny size.

Per-row QPs (``rc_flag`` 1), scene-change promotion (``rc_flag`` 2) at a scene cut that
the generator makes, and two-pass: container bytes, reconstructions and the container
decoded back.  Also: its rate-control rule against the program's, what it still refuses,
the float32 control under rate control, a rate-controlled cell run whole, and the
accepted configurations' reference bytes pinned to the digests they had before the
reference ran rate control.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import pytest

from conftest import REPO, TINY, make_tiny_root
from portbench.harness.generator import segment_pool
from portbench.harness.runner import run_cell
from portbench.reference import ReferenceEncoder
from portbench.reference import rc as RC
from streamoptima_tpu_torch import CodecConfig, VideoCodec, binstream
from streamoptima_tpu_torch import rc as program_rc

#: ``benchmarks/sweep.py``'s rate tables (bits a block row at QP 0..11), for both frame types
TABLES = [[2e5, 1.2e5, 8e4, 5e4, 3e4, 2e4, 1.2e4, 8e3, 5e3, 3e3, 2e3, 1.2e3]] * 2
#: at 48x64 and 30 fps, a row budget of 6997 bits: rows at QP 8, 7, 8 (the carry moves the middle one)
RATE = dict(target_br="615 kbps", frame_rate=30, qp_rate_tables=TABLES)
#: the encode traffic cut to 11 frames (intra frames 0 and 8) with a scene cut at frame 5
TRAFFIC = dict(json.loads((REPO / "portbench/traffic/segments-encode.json").read_text()), frames=11, cuts=[5])
GOP = [0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1]
PROMOTED = [0, 1, 1, 1, 1, 0, 1, 1, 0, 1, 1]


def rc_cfg(name: str, **over) -> dict:
    cfg = json.loads((REPO / f"portbench/configs/{name}.json").read_text())["codec"]
    cfg.update(TINY, frames=11, search_range=4, **RATE)
    cfg.update(over)
    return cfg


# (configuration, rate-control fields, seed, slot, frame types); each promoting case's threshold lies between
# the cut frame's coded length and the longest other inter frame's in that segment (fast: 149 against 101;
# full search: 107 against 72)
CASES = {
    "rc1-fast": ("fast-vbs-fme-720p", dict(rc_flag=1), 1, 6, GOP),
    "rc2-fast-cut": ("fast-vbs-fme-720p", dict(rc_flag=2, intra_thresh=125), 1, 6, PROMOTED),
    "rc2-full-nref4-cut": ("full-vbs-fme-nref4-1088p", dict(rc_flag=2, intra_thresh=90), 2**35 + 5, 3, PROMOTED),
    "two-pass-fast": ("fast-vbs-fme-720p", dict(rc_flag=1, two_pass=True), 2**33 + 7, 2, GOP),
    "two-pass-rc2-fast-cut": ("fast-vbs-fme-720p", dict(rc_flag=2, intra_thresh=125, two_pass=True), 1, 6, PROMOTED),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_program_under_rate_control(case, tmp_path):
    name, over, seed, slot, ftypes = CASES[case]
    cfg = rc_cfg(name, **over)
    frames = segment_pool(cfg["height"], cfg["width"], TRAFFIC, seed)[slot]["frames"]
    codec = VideoCodec(CodecConfig(**cfg), frames, device="cpu")
    pkg = codec.encode(compute_ssim=False, package=False)
    path = tmp_path / "c.sob"
    codec.transmit_bitstream_binary(path)
    ref_bytes, ref_recon = ReferenceEncoder(cfg, "cpu").encode(frames)
    assert pkg["frame_type_seq"] == ftypes
    assert path.read_bytes() == ref_bytes
    assert np.array_equal(pkg["reconstructed frames"], ref_recon)
    path.write_bytes(ref_bytes)
    fts, _, qps, _ = binstream.read_binary(path, CodecConfig(**cfg))
    assert [int(t) for t in fts] == ftypes
    assert len({int(q) for row in qps for q in row}) > 1  # the rows' QPs differ: rate control ran
    decoded = VideoCodec(CodecConfig(**cfg), device="cpu").decode_bitstream_binary(path)
    assert np.array_equal(decoded, ref_recon)


def test_the_row_qp_rule_is_the_programs():
    rng = np.random.default_rng(3)
    for _ in range(200):
        table = sorted(rng.uniform(100, 2e5, 12).tolist(), reverse=True)
        rows = int(rng.integers(1, 50))
        h = 16 * rows
        br = f"{int(rng.integers(1, 9000))} kbps"
        cfg = CodecConfig(height=h, width=64, frames=2, rc_flag=1, target_br=br, frame_rate=30,
                          qp_rate_tables=[table, table[::-1]])
        per_row = RC.bitrate_per_row(br, 30, h, 16)
        assert per_row == cfg.bitrate_per_row
        assert RC.row_qps(table, per_row, rows) == program_rc.row_qp_sequence(cfg, 0)  # the clamp (B6) included
        bits = rng.integers(0, 3000, rows) * (rng.random(rows) < 0.8)
        fallback = np.full(rows, 5)
        assert RC.second_pass_row_qps(bits, table, cfg.target_bitrate // 30, fallback) == \
            program_rc.second_pass_row_qps(cfg, bits, 0, fallback).tolist()
    assert RC.second_pass_row_qps(np.zeros(3), TABLES[0], 1000, [4, 5, 6]) == [4, 5, 6]


@pytest.mark.parametrize("over", [dict(roi_qp_map=[0] * 12), dict(parallel_mode=1), dict(parallel_mode=3),
                                  dict(intra_mode=1), dict(engine="compat"), dict(rc_flag=None, two_pass=True),
                                  dict(rc_flag=2)])
def test_reference_still_refuses_what_it_does_not_run(over):
    with pytest.raises(ValueError):
        ReferenceEncoder(rc_cfg("fast-vbs-fme-720p", **{"rc_flag": 1, **over}), "cpu")


@pytest.mark.parametrize("case", ["rc2-fast-cut", "two-pass-fast"])
def test_the_control_differs_under_rate_control(case):
    name, over, seed, slot, _ = CASES[case]
    cfg = rc_cfg(name, **over)
    frames = segment_pool(cfg["height"], cfg["width"], TRAFFIC, seed)[slot]["frames"]
    exact = ReferenceEncoder(cfg, "cpu").encode(frames)
    control = ReferenceEncoder(cfg, "cpu", control=True).encode(frames)
    assert exact[0] != control[0] and not np.array_equal(exact[1], control[1])


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_a_rate_controlled_cell_with_a_scene_cut_runs_correct(tmp_path, kind, capsys):
    """A cell that this benchmark does not carry, added to a tiny checkout: rc_flag 2 on the
    fast tool set, traffic with a cut at frame 5, through the whole run."""
    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = {"codec": rc_cfg("fast-vbs-fme-720p", rc_flag=2, intra_thresh=125, frames=16)}
    (root / "portbench/configs/rc-test.json").write_text(json.dumps(conf))
    traffic = json.loads((REPO / f"portbench/traffic/segments-{kind}.json").read_text())
    (root / f"portbench/traffic/cut-{kind}.json").write_text(json.dumps(dict(traffic, cuts=[5])))
    bench["configs"].append({"name": "rc-test", "source": "a test", "file": "portbench/configs/rc-test.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": f"rc-test.{kind}", "config": "rc-test", "traffic": f"cut-{kind}",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    args = argparse.Namespace(workload=f"rc-test.{kind}", seed=2**34 + 3, seconds=0.3, trace=0)
    assert run_cell(args, time.perf_counter(), root=root, device="cpu", require_card=False) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0
    assert r["compared"] and all(c["value"] == 0 == c["limit"] for c in r["compared"].values())


#: SHA-256 digests of the reference's container and reconstructions of pool slot 3 of the encode traffic's
#: seed 2**35 + 17 at 48x64, for each configuration file, computed at the commit before the reference ran
#: rate control (the pools themselves are pinned in ``test_portbench_generator.py``)
REFERENCE = {
    "fast-vbs-fme-720p": ("6a78f744c0b5422dd0ba972dc7b41264864aa71373f8bde5e266147e28cec9cd",
                          "25d78ecbaebe4ba75f39a841a4ace506274856d44210ff2f36fe898ef95bfc67"),
    "full-vbs-fme-nref4-1088p": ("fa0602b6d371b7be3e1470ca984140ca3037c407720506b3926625753a81229c",
                                 "7280933420be7451ec3091a8c2106f49c38e184a081456b41ac15d9288f197aa"),
    "main-720p": ("5e00d191426b7ca9a08feb9c20dabb2fac47f5bb86f1799d55f88e927129541d",
                  "374f8ed92038d3858613002c6eee68e4cbc24ddca50b20a9f34232ec57919684"),
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_the_reference_bytes_of_the_accepted_configurations_are_unchanged(name):
    cfg = json.loads((REPO / f"portbench/configs/{name}.json").read_text())["codec"]
    cfg.update(TINY)
    traffic = json.loads((REPO / "portbench/traffic/segments-encode.json").read_text())
    frames = segment_pool(cfg["height"], cfg["width"], traffic, 2**35 + 17)[3]["frames"]
    ref_bytes, ref_recon = ReferenceEncoder(cfg, "cpu").encode(frames)
    assert (hashlib.sha256(ref_bytes).hexdigest(), hashlib.sha256(ref_recon.tobytes()).hexdigest()) == REFERENCE[name]
