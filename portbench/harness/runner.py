"""One run of one cell: set-up, the window, the traced slice, the check, the result line.

Everything that belongs to one configuration, traffic mix, metric or kernel
is found by name: ``BENCHMARK.json`` names the cell, its configuration's
file and its traffic (``portbench/traffic/<traffic>.json``), whose
``driver`` names ``portbench/drivers/<driver>.py``; each metric is
``portbench/metrics/<metric>.py`` and each kernel's count
``portbench/kernels/<kernel>.py``.  This file holds only what every cell
shares.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench.harness.correct import LIMITS, compare, reference_outputs, reference_slots
from portbench.harness.generator import schedule, segment_pool
from portbench.harness.window import NoSpans, Spans, clock, run_window, sample_picker

HERE = Path(__file__).resolve().parent.parent
#: the folder, under the checkout's root, that holds the benchmark's files
FOLDER = HERE.name
#: top-level module names that no run may load: JAX and the JAX package (compared whole, before the first dot)
FORBIDDEN = ("jax", "jaxlib", "flax", "streamoptima_tpu")


def load_module(path: Path):
    """A module from its file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entries and files, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json (there are {sorted(cells)})")
    wl = cells[workload]
    conf_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    conf = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((root / FOLDER / "traffic" / f"{wl['traffic']}.json").read_text())

    def applies(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(workload=wl, conf=conf, traffic=traffic, dir=root / FOLDER,
                           end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                           per_layer=[m for m in bench["per_layer"] if applies(m)])


def forbidden_modules() -> list[str]:
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def _smi() -> str:
    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60, check=True).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"


def _io_written() -> dict:
    """Bytes this process has written: through write() and to storage (/proc/self/io)."""
    try:
        fields = dict(line.split(": ") for line in Path("/proc/self/io").read_text().splitlines())
        return {"wchar": int(fields["wchar"]), "write_bytes": int(fields["write_bytes"])}
    except (OSError, KeyError, ValueError):
        return {}


def run_cell(args, t_start: float, root: Path | None = None, device: str = "cuda", require_card: bool = True) -> int:
    """Run the cell ``args.workload`` once; print the info lines, the checks
    (standard error) and the result line (standard output, last).  Returns
    the exit code.  ``root`` is the checkout (default: this folder's
    parent); ``device``/``require_card`` let the tests drive a run on the
    CPU.  The command line always runs on the card."""
    import torch

    root = HERE.parent if root is None else Path(root)
    cell = load_cell(root, args.workload)
    chips = int(cell.workload["chips"])
    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"portbench: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from streamoptima_tpu_torch import CodecConfig, native

    info = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds, "trace": args.trace}
    if device.startswith("cuda"):
        from streamoptima_tpu_torch import _build

        built = _build.build()
        info.update(card=_smi(), kernel_library_cached=built.cached, kernel_build_s=built.seconds)
    info["native_serializer"] = native.available()
    print(f"[portbench] {json.dumps(info)}", flush=True)

    cfg_dict = dict(cell.conf["codec"])
    traffic = cell.traffic
    pool = segment_pool(cfg_dict["height"], cfg_dict["width"], traffic, args.seed)
    if len(pool[0]["frames"]) != cfg_dict["frames"]:
        raise SystemExit("portbench: the traffic's segment length disagrees with the configuration's frames")
    ctx = SimpleNamespace(cfg=CodecConfig(**cfg_dict), pool=pool, device=device)
    driver = getattr(load_module(cell.dir / "drivers" / f"{traffic['driver']}.py"), "DRIVER")(ctx)
    driver.setup()
    spans = Spans(sync=device.startswith("cuda")) if args.trace else NoSpans()
    # one segment warms every shape and kernel the window drives: the pool's segments share their sizes and
    # tool set and differ only in content and motion; the one whose motion the traffic lists first, for every seed
    first_motion = tuple(int(v) for v in traffic["motions"][0])
    driver.segment(next(s for s, seg in enumerate(pool) if seg["motion"] == first_motion), False, spans)
    spans.totals.clear()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = clock() - t_start

    ref_slots = reference_slots(traffic, args.seed)
    order = schedule(traffic, args.seed)
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's scans for the window
    window = run_window(driver, order, args.seconds, sample_picker(traffic, ref_slots, args.seed), spans)
    profile = None
    if args.trace:
        from portbench.harness.trace import profile_slice

        profile = profile_slice(driver, order, traffic["profile_segments"]) if device.startswith("cuda") else None
    mem_peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    observed = list(window["kept"])
    if hasattr(driver, "setup_outputs"):
        observed += [(slot, o) for slot, o in driver.setup_outputs().items() if slot in ref_slots]
    failures, kind = list(driver.failures), driver.kind
    observed = [(slot, _read_containers(o)) for slot, o in observed]
    driver.close()
    driver = None  # the program's state goes before the reference runs
    gc.unfreeze()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    t_ref = clock()
    reference = reference_outputs(cfg_dict, pool, ref_slots, device)
    numbers = compare(observed, reference)
    ref_s = clock() - t_ref

    run = {"kind": kind, "cfg": cfg_dict, "setup_s": setup_s, "window": window, "spans": dict(spans.totals),
           "profile": profile, "peaks": json.loads((cell.dir / "peaks.json").read_text()),
           "kernels": _kernel_counts(cell.dir)}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module(cell.dir / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if profile is not None:
        _print_unmatched(profile, run["kernels"])

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which no run may load", file=sys.stderr)
        return 4
    compared = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    correct = (window["failed"] == 0 and bool(compared) and all(c["value"] <= c["limit"] for c in compared.values()))
    dev_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
                "count": chips, "memory_peak_bytes": int(mem_peak)}
    if profile is not None:
        dev_info.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
    result = {"correct": correct, "attempted": len(window["latencies_s"]), "failed": window["failed"],
              "metrics": metrics, "device": dev_info}
    if profile is not None:
        result["breakdown"] = profile["breakdown"]
    result["compared"] = compared
    lat_ms = [round(1e3 * float(np.percentile(window["latencies_s"], q)), 3) for q in (5, 50, 95, 100)]
    summary = {"segments": len(window["latencies_s"]), "frames": window["frames"], "window_s": window["window_s"],
               "setup_s": setup_s, "reference_s": ref_s, "reference_slots": sorted(ref_slots),
               "kept": len(window["kept"]), "failures": failures[:5], "written": _io_written(),
               "latency_ms_p5_p50_p95_max": lat_ms}
    print(f"[portbench] {json.dumps(summary)}", flush=True)
    print(f"correct {correct}", file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def _read_containers(outputs: dict) -> dict:
    """A kept segment's outputs with its container's bytes read from its file."""
    out = dict(outputs)
    if "container_path" in out:
        out["container"] = Path(out.pop("container_path")).read_bytes()
    return out


def _kernel_counts(folder: Path) -> dict:
    return {p.stem: load_module(p) for p in sorted((folder / "kernels").glob("*.py")) if not p.stem.startswith("_")}


def _print_unmatched(profile: dict, kernels: dict) -> None:
    """The kernels the slice launched that have no count file (they count in
    neither sum of the roofline), PyTorch's own and the copies left out."""
    skip = ("at::", "c10::", "cub", "Memcpy", "Memset", "memcpy", "memset")
    names = sorted({op["name"] for op in profile["ops"] if op["base"] not in kernels
                    and not any(s in op["name"] for s in skip)})
    print(f"[portbench] launches with no count file (not in kernel_roofline): {names}", flush=True)
