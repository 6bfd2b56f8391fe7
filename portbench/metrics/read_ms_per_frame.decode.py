"""read_ms_per_frame.decode: milliseconds a frame in the benchmark span around
``binstream.read_binary`` (the container parse and RLE decode), over the traced window."""


def read(run):
    if run["kind"] != "decode" or not run["spans"]:
        return None
    return 1e3 * sum(run["spans"].get(s, 0.0) for s in ("read",)) / run["window"]["frames"]
