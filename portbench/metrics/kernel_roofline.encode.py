"""kernel_roofline.encode: the hand-written kernels' share of their roofline over the profiled slice's
launches in the encode span (``harness/roofline.py``), against ``peaks.json``."""
from portbench.harness.roofline import kernel_roofline


def read(run):
    return kernel_roofline(run, "encode") if run["kind"] == "encode" else None
