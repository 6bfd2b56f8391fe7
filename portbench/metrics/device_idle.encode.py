"""device_idle.encode: the share of the profiled slice's wall time (its segments, on the profiler's
clock) in which no device operation ran: 100 * (1 - busy / wall)."""


def read(run):
    prof = run["profile"]
    if run["kind"] != "encode" or prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
