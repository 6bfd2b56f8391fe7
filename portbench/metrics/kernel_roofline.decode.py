"""kernel_roofline.decode: the hand-written kernels' share of their roofline over the profiled slice's
launches in the decode span (``harness/roofline.py``), against ``peaks.json``."""
from portbench.harness.roofline import kernel_roofline


def read(run):
    return kernel_roofline(run, "decode") if run["kind"] == "decode" else None
