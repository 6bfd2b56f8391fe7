"""The kernels' share of their roofline over a profiled slice.

Over every launch of a kernel with a count file (``portbench/kernels``):
the sum of each launch's least time on the card (the larger of its bytes
over the memory rate and its integer operations over the INT32 rate of
``peaks.json``) divided by the sum of the launches' measured times.  A
launch without a count file counts in neither sum.
"""
from __future__ import annotations


def kernel_roofline(run: dict, span: str) -> float | None:
    """The share, in %, for the launches in ``span``; None without any."""
    prof = run["profile"]
    if prof is None:
        return None
    p = run["peaks"]
    int_ops_per_s = p["sms"] * p["int32_lanes_per_sm"] * p["sm_clock_hz"]
    least = measured = 0.0
    for op in prof["ops"]:
        counter = run["kernels"].get(op["base"])
        if counter is None or op["span"] != span:
            continue
        got = counter.count(op, run["cfg"], prof["segments"][op["seg"]]["frame_info"])
        if got is None:
            continue
        nbytes, ops = got
        least += max(nbytes / p["hbm_bytes_per_s"], ops / int_ops_per_s)
        measured += op["dur_s"]
    return 100.0 * least / measured if measured > 0 else None
