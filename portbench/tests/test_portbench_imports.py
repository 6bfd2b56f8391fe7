"""What a run loads: never JAX or the JAX package (by whole top-level name); the
reference nothing of the program; and the files this benchmark must leave as they are."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from conftest import REPO, cpu_run_script

FORBIDDEN = {"jax", "jaxlib", "flax", "streamoptima_tpu"}


def imported_roots(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not imported_roots(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench/reference").glob("*.py"):
        assert not imported_roots(path) & (FORBIDDEN | {"streamoptima_tpu_torch", "portbench"}), path
    code = ("import sys; sys.path.insert(0, %r)\nimport numpy as np\nfrom portbench.reference import ReferenceEncoder\n"
            "cfg = dict(height=32, width=48, frames=3, block_size=16, search_range=4, intra_dur=2, qp=4)\n"
            "ReferenceEncoder(cfg, 'cpu').encode(np.zeros((3, 32, 48), np.uint8))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('streamoptima_tpu_torch', 'streamoptima_tpu',"
            " 'jax', 'jaxlib', 'flax')))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax_module(tiny_root):
    """A whole run in a fresh interpreter; the runner itself checks ``sys.modules``
    once the window has closed and exits 4 if it finds one of these."""
    code = cpu_run_script(tiny_root, "fast-vbs-fme-720p.decode", 2**33 + 1, 0.5, 1).replace(
        "sys.exit(run_cell(", "rc = (run_cell(") + (
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'streamoptima_tpu')))\n"
        "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from portbench.harness.runner import forbidden_modules

    monkeypatch.setitem(sys.modules, "streamoptima_tpu_torchlike", sys)
    assert "streamoptima_tpu_torchlike" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "streamoptima_tpu.fake", sys)
    assert "streamoptima_tpu.fake" in forbidden_modules()


def test_the_jax_benchmark_and_package_are_untouched():
    """No change in the working tree to the JAX package's benchmark, its results or the package."""
    try:
        out = subprocess.run(["git", "status", "--porcelain", "--", "bench.py", "benchmarks", "chip_smoke.py",
                              "streamoptima_tpu", "BENCH_r01.json", "MULTICHIP_r01.json"], cwd=REPO,
                             capture_output=True, text=True, timeout=60)
    except OSError:
        pytest.skip("git is not installed")
    if out.returncode != 0:
        pytest.skip("not a git checkout")
    assert out.stdout == ""


def test_without_a_card_the_command_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "full-vbs-fme-nref4-1088p.encode",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    if "torch.cuda.is_available() is True" in out.stderr:
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and this folder."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = cpu_run_script(tmp_path, "full-vbs-fme-nref4-1088p.encode", 1, 0.5, 0)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
