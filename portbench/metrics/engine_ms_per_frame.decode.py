"""engine_ms_per_frame.decode: milliseconds a frame in the benchmark span around
``VideoCodec.decode``, up to the frames on the host, over the traced window."""


def read(run):
    if run["kind"] != "decode" or not run["spans"]:
        return None
    return 1e3 * sum(run["spans"].get(s, 0.0) for s in ("decode",)) / run["window"]["frames"]
