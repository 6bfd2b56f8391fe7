"""search_ms_per_inter_frame: the device time of the half-pel full search's launches
(``full_search_fme_kernel``) in the profiled slice's encode span, in ms, over the slice's inter frames."""

KERNEL = "full_search_fme_kernel"


def read(run):
    prof = run["profile"]
    if run["kind"] != "encode" or prof is None:
        return None
    launches = [op["dur_s"] for op in prof["ops"] if op["base"] == KERNEL and op["span"] == "encode"]
    inter = sum(f["type"] == 1 for seg in prof["segments"] for f in seg["frame_info"])
    return 1e3 * sum(launches) / inter if launches and inter else None
