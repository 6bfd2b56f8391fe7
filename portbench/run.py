"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``streamoptima_tpu_torch``), on a machine with the CUDA
cards the cell asks for.  It makes the cell's segments from the seed, warms
every shape the window uses, measures for ``--seconds`` seconds, checks the
program's outputs against the plain reference, and prints the result as
the last line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones from spans around the
program's entry points and a profiled slice of segments.  Without the cards
it exits 3 and prints no result; if the run loaded JAX or the JAX package
it exits 4.  Build and kernel caches stay inside the checkout.  The
process runs its CPU math on one thread and keeps its heap (``steady_process``).
"""
import time

T_START = time.perf_counter()

import ctypes  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches at fixed paths inside the checkout (git-ignored under build/), so only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path.insert(0, str(ROOT))


def steady_process() -> None:
    """Settings of this process, made before torch loads, that keep one run
    like the next: the CPU math on one thread, and host buffers of up to
    256 MiB (a segment's container copy) served from a heap that is kept,
    not mapped and faulted in afresh for each segment."""
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc: its own allocator's policy stands
        return
    libc.mallopt.argtypes, libc.mallopt.restype = (ctypes.c_int, ctypes.c_int), ctypes.c_int
    m_trim_threshold, m_top_pad, m_mmap_threshold = -1, -2, -3
    libc.mallopt(m_mmap_threshold, 256 << 20)
    libc.mallopt(m_trim_threshold, 1 << 30)
    libc.mallopt(m_top_pad, 64 << 20)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench.harness.runner import run_cell

    return run_cell(args, T_START)


if __name__ == "__main__":
    steady_process()
    sys.exit(main())
