"""device_ops_per_frame.encode: device operations (kernels, copies, memsets) a frame in the profiled slice's encodes."""


def read(run):
    prof = run["profile"]
    if run["kind"] != "encode" or prof is None or not prof["frames"]:
        return None
    return len(prof["ops"]) / prof["frames"]
