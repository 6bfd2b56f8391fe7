"""The lower-precision control: the plain reference, with float32 transforms, in the program's place.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

The configurations state an exact codec: a fixed-point integer DCT whose
products are exact in float64, and decode equal to the encoder's
reconstruction bit for bit.  The control computes the transforms in the
precision below, float32 (``reference/transform.py``), and otherwise runs
the reference as it is.  For each seed it makes the cell's pool and the
slots a run of that seed compares, encodes them exactly and with the
control, and compares the control's outputs with the exact ones as a run
compares the program's: the container's bytes, and the reconstructions (as
the encode traffic keeps them, or as the decode traffic's decoded frames,
which a decoder of the control's stream reproduces).  It prints each
seed's numbers beside their limits and exits 0 only if the control comes
out as not correct on every seed.  Runs on the card; the benchmark's own
runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control_numbers(root: Path, workload: str, seed: int, device: str) -> dict:
    """The numbers a run of ``workload`` compares, read off the control at ``seed``."""
    from portbench.harness.correct import compare, reference_outputs, reference_slots
    from portbench.harness.generator import segment_pool
    from portbench.harness.runner import load_cell, load_module

    cell = load_cell(root, workload)
    cfg = dict(cell.conf["codec"])
    pool = segment_pool(cfg["height"], cfg["width"], cell.traffic, seed)
    slots = reference_slots(cell.traffic, seed)
    exact = reference_outputs(cfg, pool, slots, device)
    control = reference_outputs(cfg, pool, slots, device, control=True)
    kind = load_module(cell.dir / "drivers" / f"{cell.traffic['driver']}.py").DRIVER.kind
    key = "recon" if kind == "encode" else "decoded"
    return compare([(s, {"container": b, key: r}) for s, (b, r) in control.items()], exact)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read the cell's compared numbers off the lower-precision control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness.correct import LIMITS

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(ROOT, args.workload, seed, "cuda")
        fails = any(v > LIMITS[k] for k, v in numbers.items())
        failed_all &= fails
        print(json.dumps({"workload": args.workload, "seed": seed, "control_not_correct": fails,
                          "numbers": {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
