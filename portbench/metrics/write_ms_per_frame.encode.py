"""write_ms_per_frame.encode: milliseconds a frame in the benchmark span around
``transmit_bitstream_binary`` (the container write: the device-to-host copies of every frame's
outputs and the serializer), over the traced window."""


def read(run):
    if run["kind"] != "encode" or not run["spans"]:
        return None
    return 1e3 * sum(run["spans"].get(s, 0.0) for s in ("write",)) / run["window"]["frames"]
