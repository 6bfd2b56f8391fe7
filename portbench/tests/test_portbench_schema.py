"""BENCHMARK.json against the rules a benchmark file is refused for before any run."""
from __future__ import annotations

import json
import re

from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per_tok")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) for p in BENCH["paths"])
    assert all(not p.endswith("_torch") and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"]) and (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and "codec" in conf and "source" in conf
        assert c["name"] in used


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in BENCH["configs"]}
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert (REPO / "portbench/traffic" / f"{w['traffic']}.json").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128 and not set(e2e) & set(layer)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
    for m in [*BENCH["end_to_end"], *BENCH["per_layer"]]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer metric
        here = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in here} and len(here) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
        for m in BENCH["per_layer"]:  # the metric it moves is reported in each cell that lists it
            if cell in m.get("workloads", cells):
                assert cell in e2e[m["moves"]].get("workloads", cells)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"codec", "engine", "kernels", "device"}
