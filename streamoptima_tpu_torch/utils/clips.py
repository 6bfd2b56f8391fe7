"""Deterministic synthetic test/benchmark clips.

The port's copy of ``streamoptima_tpu.utils.clips``: the same seed gives the
same clip in both packages.

A translating low-pass-filtered random texture: has genuine motion structure
(so full-search ME finds real matches and RLE sees realistic zero runs) while
being reproducible without shipping video files, which the reference repo
also does not contain (its hardcoded "video/cif.yuv", main.py:46, is absent).
"""
from __future__ import annotations

import numpy as np


def synthetic_clip(h: int, w: int, frames: int, seed: int = 42, motion: int = 2, smooth: bool = True) -> np.ndarray:
    """(frames, h, w) uint8 clip: texture translating by ``motion`` px/frame."""
    rng = np.random.default_rng(seed)
    pad = motion * frames + 16
    base = rng.integers(0, 256, size=(h + pad, w + pad)).astype(np.float64)
    if smooth:
        # separable 5-tap box blur (vectorized; large frames stay fast)
        k = 5
        kernel = np.ones(k) / k
        base = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 0, base)
        base = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 1, base)
    base = np.clip(base, 0, 255).astype(np.uint8)
    return np.stack([base[i * motion : i * motion + h, i * motion : i * motion + w].copy() for i in range(frames)])
