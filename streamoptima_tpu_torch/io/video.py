"""Video I/O: YUV 4:2:0 / 4:4:4 reading, chroma upsampling, RGB conversion.

The port's copy of ``streamoptima_tpu.io.video.VideoManager`` (numpy only,
on the host, as in the JAX package): nearest-neighbour 420->444 upsample
(video_manager.py:144-177), BT.601-style RGB conversion with the
reference's exact matrix and clipping (video_manager.py:179-216), Y
extraction and the raw Y-plane readers and writer, vectorized over all
frames.  The command line reads its input through it (``main.py``).
"""
from __future__ import annotations

import numpy as np

_CONV_MAT = np.array(
    [[1.164, 0.000, 2.018], [1.164, -0.813, -0.391], [1.164, 1.596, 0.000]]
)  # video_manager.py:186-188


def _raw_bytes(raw) -> np.ndarray:
    """A path's bytes, or an array as uint8."""
    if isinstance(raw, (str, bytes)) or hasattr(raw, "__fspath__"):
        return np.fromfile(raw, dtype=np.uint8)
    return np.asarray(raw, dtype=np.uint8)


class VideoManager:
    """Reads a raw YUV file (or array) and converts between formats."""

    def __init__(self, raw, h_pixels: int, w_pixels: int, frames: int, v_type: str = "yuv_420"):
        self.h_pixels = h_pixels
        self.w_pixels = w_pixels
        self.frames = frames
        self.vid_frames_yuv420 = None
        self.vid_frames_yuv444 = None
        self.vid_frames_rgb = None
        ny = h_pixels * w_pixels
        if v_type == "yuv_420":
            frame_size = ny * 3 // 2
            self.vid_frames_yuv420 = _raw_bytes(raw)[: frames * frame_size].reshape(frames, frame_size)
        elif v_type == "yuv_444":
            self.vid_frames_yuv444 = _raw_bytes(raw)[: frames * ny * 3].reshape(frames, 3, h_pixels, w_pixels)
        else:
            raise ValueError(f"cannot parse video type {v_type!r}")

    def upscale_yuv420_to_yuv444(self) -> np.ndarray:
        """Nearest-neighbour chroma upsample (video_manager.py:144-177)."""
        if self.vid_frames_yuv420 is None:
            raise ValueError("no YUV 4:2:0 data available")
        h, w, n = self.h_pixels, self.w_pixels, self.frames
        ny = h * w
        nuv = ny // 4
        raw = self.vid_frames_yuv420
        y = raw[:, :ny].reshape(n, h, w)
        u = raw[:, ny: ny + nuv].reshape(n, h // 2, w // 2)
        v = raw[:, ny + nuv:].reshape(n, h // 2, w // 2)
        u = u.repeat(2, axis=1).repeat(2, axis=2)
        v = v.repeat(2, axis=1).repeat(2, axis=2)
        self.vid_frames_yuv444 = np.stack([y, u, v], axis=1)
        return self.vid_frames_yuv444

    def convert_yuv444_to_rgb(self) -> np.ndarray:
        """BT.601-style conversion with the reference's exact constants
        (video_manager.py:179-216)."""
        if self.vid_frames_yuv444 is None:
            raise ValueError("no YUV 4:4:4 data available")
        yuv = self.vid_frames_yuv444.astype(np.float32).transpose(0, 2, 3, 1)  # (n, h, w, 3)
        yuv[..., 0] = yuv[..., 0].clip(16, 235) - 16
        yuv[..., 1:] = yuv[..., 1:].clip(16, 240) - 128
        # float32 pixels against the float64 matrix, as the reference
        # (video_manager.py:189-201): the product accumulates in float64; an
        # all-float32 product rounds differently at the 0/255 clip edges
        rgb = np.matmul(yuv, _CONV_MAT.T).clip(0, 255).astype(np.uint8)
        self.vid_frames_rgb = rgb
        return rgb

    def extract_y_only(self) -> np.ndarray:
        """Y plane per frame (video_manager.py:229-236)."""
        if self.vid_frames_yuv444 is None:
            raise ValueError("no YUV 4:4:4 data available (convert first)")
        return self.vid_frames_yuv444[:, 0, :, :]

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
