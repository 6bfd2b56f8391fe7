"""encode_segment_p95_ms: the 95th percentile (numpy's linear interpolation) of every
window segment's time from its start to its container written."""
import numpy as np


def read(run):
    lat = run["window"]["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if run["kind"] == "encode" and lat else None
