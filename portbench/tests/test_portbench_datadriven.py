"""A later change adds a configuration, a traffic mix, a metric and a kernel count as new
files plus entries in BENCHMARK.json, and edits no file of this folder: in a copy of the
folder, such additions are found by name and run."""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys

from conftest import TINY, cpu_run_script, make_tiny_root


def digests(folder) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_taken_without_editing_a_file(tmp_path):
    root = make_tiny_root(tmp_path / "checkout")
    folder = root / "portbench"
    before = digests(folder)

    conf = json.loads((folder / "configs/main-720p.json").read_text())  # a file no entry names yet
    conf["codec"].update(TINY, search_range=4, intra_dur=16)
    (folder / "configs/still-sr4.json").write_text(json.dumps(conf))
    traffic = json.loads((folder / "traffic/segments-encode.json").read_text())
    traffic.update(motions=[[0, 0]] * traffic["pool"], why="static textures")
    (folder / "traffic/segments-still.json").write_text(json.dumps(traffic))
    (folder / "metrics/segments_in_window.py").write_text(
        '"""segments_in_window: segments the window completed."""\n\n\n'
        'def read(run):\n    return len(run["window"]["latencies_s"])\n')
    (folder / "kernels/dct_scipy_kernel.py").write_text(
        '"""dct_scipy_kernel: a count file added later."""\n\n\n'
        'def count(launch, cfg, frames):\n    return 1, 0\n')

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "still-sr4", "source": "a test", "file": "portbench/configs/still-sr4.json",
                             "reduced": ["search_range"], "why": "a test"})
    bench["workloads"].append({"name": "still-sr4.encode", "config": "still-sr4", "traffic": "segments-still",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_fps":
            m["workloads"].append("still-sr4.encode")
    # an end-to-end metric whose reader is already in the folder, taken by its entry alone
    bench["end_to_end"].append({"name": "encode_segment_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": ["still-sr4.encode"]})
    bench["per_layer"].append({"name": "segments_in_window", "unit": "segments", "better": "higher",
                               "source": "host_clock", "layer": "codec", "moves": "encode_fps",
                               "workloads": ["still-sr4.encode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    results = {}
    for trace in (0, 1):
        out = subprocess.run([sys.executable, "-c", cpu_run_script(root, "still-sr4.encode", 5, 0.5, trace)],
                             capture_output=True, text=True, timeout=600, cwd=root)
        assert out.returncode == 0, out.stderr[-3000:]
        results[trace] = json.loads(out.stdout.strip().splitlines()[-1])
    assert results[0]["correct"] and results[1]["correct"]
    assert set(results[0]["metrics"]) == {"encode_fps", "encode_segment_p95_ms", "setup_s"}
    assert results[1]["metrics"]["segments_in_window"]["value"] == results[1]["attempted"]

    from portbench.harness.runner import _kernel_counts

    assert "dct_scipy_kernel" in _kernel_counts(folder)
    after = digests(folder)
    assert {k: v for k, v in after.items() if k in before} == before
