"""Shared fixtures of the benchmark's CPU tests: a checkout whose cells are cut to a tiny size.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: the tiny frame the CPU tests cut every configuration to (widths of a deployment need the card)
TINY = {"height": 48, "width": 64}


def make_tiny_root(dest: Path) -> Path:
    """A checkout at ``dest``: BENCHMARK.json, a copy of this folder with
    every configuration cut to ``TINY``, and the program (a link)."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "portbench", dest / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        conf["codec"].update(TINY)
        (dest / c["file"]).write_text(json.dumps(conf))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    (dest / "streamoptima_tpu_torch").symlink_to(REPO / "streamoptima_tpu_torch")
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))


def cpu_run_script(root: Path, workload: str, seed: int, seconds: float, trace: int) -> str:
    """Python source that runs one cell on the CPU in a fresh interpreter, from ``root``."""
    return (f"import sys, time, argparse\nt = time.perf_counter()\nsys.path.insert(0, {str(root)!r})\n"
            "from portbench.harness.runner import run_cell\n"
            f"a = argparse.Namespace(workload={workload!r}, seed={seed}, seconds={seconds}, trace={trace})\n"
            f"sys.exit(run_cell(a, t, root={str(root)!r}, device='cpu', require_card=False))\n")
