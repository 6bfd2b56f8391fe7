"""The measured window, shared by every cell: a closed loop of one stream.

The window runs one segment after another, each through the traffic
driver's ``segment`` call, until ``seconds`` have passed on the host clock;
the segment running at that moment is finished and counted, so the
window's length is the time from the first segment's start to the last
one's end.  Each segment's latency is its own start to its end.  Nothing
is built or compiled here: the runner has warmed every shape first.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

clock = time.perf_counter


class Spans:
    """The benchmark's own spans around its calls into the program.

    ``spans("encode")`` is a context manager that adds the time inside it to
    ``totals["encode"]``.  With ``sync`` each span ends with
    ``torch.cuda.synchronize()`` (the traced run's spans), and with
    ``annotate`` each is also a ``torch.profiler.record_function`` range
    named ``portbench.<name>`` (the profiled slice)."""

    traced = True

    def __init__(self, sync: bool = False, annotate: bool = False):
        self.sync, self.annotate = sync, annotate
        self.totals: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        rf = torch.profiler.record_function(f"portbench.{name}") if self.annotate else contextlib.nullcontext()
        t0 = clock()
        with rf:
            yield
            if self.sync:
                torch.cuda.synchronize()
        self.totals[name] += clock() - t0


class NoSpans:
    """The untraced run's spans: nothing recorded, nothing synchronised."""

    traced = False
    _null = contextlib.nullcontext()
    totals: dict[str, float] = {}

    def __call__(self, name: str):
        return self._null


def sample_picker(traffic: dict, slots: set, seed: int):
    """Which window segments are kept for the comparison with the reference:
    those of the pool slots in ``slots``, the first occurrence of each and
    later ones with probability ``traffic["sample_share"]``, drawn from the
    seed, at most ``traffic["max_samples"]`` in all."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0x5A3])
    seen: set = set()
    count = [0]

    def keep(slot: int) -> bool:
        if slot not in slots or count[0] >= traffic["max_samples"]:
            return False
        first = slot not in seen
        seen.add(slot)
        if first or rng.random() < traffic["sample_share"]:
            count[0] += 1
            return True
        return False

    return keep


def run_window(driver, order, seconds: float, keep, spans) -> dict:
    """Run segments from the slot iterator ``order`` for ``seconds``.
    Returns the window's record: its length, each segment's latency, the
    frames completed, the failures, the kept outputs [(slot, outputs)] and
    the drivers' counters, concatenated."""
    lat, kept = [], []
    counters: dict[str, list] = defaultdict(list)
    frames = failed = 0
    t_start = clock()
    while True:
        slot = next(order)
        want = keep(slot)
        t0 = clock()
        try:
            rec = driver.segment(slot, want, spans)
        except Exception as exc:  # a failed segment is counted and the stream goes on, as a user's would
            failed += 1
            driver.note_failure(slot, exc)
            rec = None
        t1 = clock()
        lat.append(t1 - t0)
        if rec is not None:
            frames += rec["frames"]
            for k, v in rec.get("counters", {}).items():
                counters[k].extend(v)
            if want:
                kept.append((slot, rec["outputs"]))
        if t1 - t_start >= seconds:
            break
    return {"window_s": t1 - t_start, "latencies_s": lat, "frames": frames, "failed": failed,
            "kept": kept, "counters": dict(counters)}
