"""decode_fps: frames decoded to the host in the window, over the window's seconds."""


def read(run):
    w = run["window"]
    return w["frames"] / w["window_s"] if run["kind"] == "decode" and w["window_s"] > 0 else None
