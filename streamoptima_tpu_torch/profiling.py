"""Timing and tracing instrumentation.

The port's twin of ``streamoptima_tpu.profiling``, itself the twin of the
reference's manual timing harness (per-ParallelMode intra/inter second
lists, Encoder.py:62-69, :494-498, :1265-1267, :1777-1782, printed at
:1897):

- ``time_steps``: per-frame-kind step latencies, synchronised.  Kernels are
  queued asynchronously, so timestamps inside the encode loop would time
  the host; this re-runs ``TorchCodec``'s steps and waits for the card after
  each (``torch.cuda.synchronize``).
- ``trace``: a ``torch.profiler`` context over the host and, where there is
  one, the card, exported as a Chrome trace for per-kernel breakdowns.

``python3 -m streamoptima_tpu_torch.profile_main_path`` is the fuller
breakdown (device busy time, idle share, top device ops) of the 720p paths.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from streamoptima_tpu_torch.engine import TorchCodec


def time_steps(cfg, y_frames, warmup: int = 1, iters: int = 8, *, device="cuda") -> dict:
    """Measure per-frame step latencies for each frame kind on ``device``.

    Returns {"intra_s": [...], "inter_s": [...], "decode_inter_s": [...],
    "decode_intra_s": [...]}, each a list of ``iters`` seconds (the
    reference's self.intraN/interN, Encoder.py:62-69).  The steps are the
    encode loop's: ``_intra_step``; the references' planes and
    ``_inter_step``; the decode's planes, prediction fetch (``_fetch``) and
    ``_recon_inter``; ``_recon_intra``.  Frame 1 (or 0) is coded against
    frame 0, at the table rows' QPs."""
    codec = TorchCodec(cfg, y_frames, device=device)
    n = min(len(codec.y), 2)
    cur = codec._y_dev[n - 1]
    refs = [codec._y_dev[0]]
    sync = torch.cuda.synchronize if codec.device.type == "cuda" else (lambda: None)
    out = {}

    def run(name, fn):
        for _ in range(warmup):
            fn()
            sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        out[name] = times

    run("intra_s", lambda: codec._intra_step(cur))
    run("inter_s", lambda: codec._inter_step(cur, codec._planes(refs, False)))
    enc = codec._inter_step(cur, codec._planes(refs, False))
    sub_mv = enc["sub_mv"] if codec.vbs else None

    def decode_inter():
        pred_full, pred_q = codec._fetch(enc["mv"], sub_mv, codec._planes(refs, False))
        return codec._recon_inter(pred_full, pred_q, enc["split"], enc["qtc_full"], enc["qtc_quads"])

    run("decode_inter_s", decode_inter)
    enc_i = codec._intra_step(cur)
    run("decode_intra_s", lambda: codec._recon_intra(enc_i["mv"], enc_i["split"], enc_i["sub_mv"],
                                                     enc_i["qtc_full"], enc_i["qtc_quads"]))
    return out


def report(times: dict) -> str:
    """Human-readable table (the reference's end-of-encode print, Encoder.py:1897)."""
    lines = []
    for k, v in times.items():
        v = np.asarray(v)
        lines.append(f"{k:>16}: mean {v.mean()*1e3:8.2f} ms   min {v.min()*1e3:8.2f} ms   max {v.max()*1e3:8.2f} ms")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block: host activity, and the card's where
    a CUDA device is visible.  On exit the trace is written to
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto).  Yields the profiler (``key_averages()`` for sums by op)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
