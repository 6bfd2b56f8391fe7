"""engine_ms_per_frame.encode: milliseconds a frame in the benchmark spans around ``VideoCodec(cfg,
frames)`` (the clip's upload) and ``encode``, each ended by a synchronisation, over the traced
window."""


def read(run):
    if run["kind"] != "encode" or not run["spans"]:
        return None
    return 1e3 * sum(run["spans"].get(s, 0.0) for s in ("upload", "encode")) / run["window"]["frames"]
