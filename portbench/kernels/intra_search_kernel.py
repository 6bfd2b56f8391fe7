"""``intra_search_kernel`` (csrc/intra_search.cu): an intra frame's search
and residuals, one launch per intra frame.

Bytes: the frame read once; the MVs and SADs (five sets with VBS) and the
int32 residuals (the block's, and the quads' with VBS) written.
Operations: an abs-diff a pixel for each of the sr + 1 distinct shifts.
"""
from __future__ import annotations

from portbench.kernels._shapes import dims


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    vbs = bool(cfg.get("vbs_enable"))
    sr = cfg.get("search_range", 16)
    return px + nb * (8 + (32 if vbs else 0)) + nb * bs * bs * 4 * (2 if vbs else 1), nb * (sr + 1) * bs * bs
