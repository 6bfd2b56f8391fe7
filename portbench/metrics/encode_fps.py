"""encode_fps: frames of all segments encoded in the window, over the window's seconds."""


def read(run):
    w = run["window"]
    return w["frames"] / w["window_s"] if run["kind"] == "encode" and w["window_s"] > 0 else None
