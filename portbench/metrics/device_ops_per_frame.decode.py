"""device_ops_per_frame.decode: device operations (kernels, copies, memsets) a frame in the profiled slice's decodes."""


def read(run):
    prof = run["profile"]
    if run["kind"] != "decode" or prof is None or not prof["frames"]:
        return None
    return len(prof["ops"]) / prof["frames"]
