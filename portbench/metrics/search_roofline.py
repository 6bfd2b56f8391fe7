"""search_roofline: the half-pel full search's (``full_search_fme_kernel``) share of its roofline
over the profiled slice's launches in the encode span: ``harness/roofline.py``'s share over that
kernel's launches alone, against ``peaks.json``."""
from portbench.harness.roofline import kernel_roofline

KERNEL = "full_search_fme_kernel"


def read(run):
    prof = run["profile"]
    if run["kind"] != "encode" or prof is None:
        return None
    return kernel_roofline(dict(run, profile=dict(prof, ops=[op for op in prof["ops"] if op["base"] == KERNEL])),
                           "encode")
