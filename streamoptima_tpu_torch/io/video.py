"""Video I/O for the luma-only codec: raw Y planes in and out.

The port's copy of the Y-plane readers and writer of
``streamoptima_tpu.io.video.VideoManager`` (numpy only).  The chroma
upsampling and RGB conversion of that class serve no path of the port and
are not copied.
"""
from __future__ import annotations

import numpy as np


class VideoManager:
    """Raw Y-plane file readers and writer."""

    @staticmethod
    def save_y_only(filename, y_frames) -> None:
        with open(filename, "wb") as f:
            for fr in y_frames:
                f.write(np.asarray(fr, dtype=np.uint8).tobytes())

    @staticmethod
    def read_y_only(filename, h: int, w: int, frames: int) -> np.ndarray:
        return np.fromfile(filename, dtype=np.uint8)[: frames * h * w].reshape(frames, h, w)

    @staticmethod
    def read_yuv420_y(filename, h: int, w: int, frames: int) -> np.ndarray:
        """Y planes straight from a 4:2:0 file (Encoder.read_yuv twin,
        Encoder.py:110-126)."""
        ny = h * w
        fsz = ny * 3 // 2
        raw = np.fromfile(filename, dtype=np.uint8)[: frames * fsz].reshape(frames, fsz)
        return raw[:, :ny].reshape(frames, h, w)
