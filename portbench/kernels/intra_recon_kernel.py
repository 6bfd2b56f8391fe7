"""``intra_recon_kernel`` (csrc/intra_recon.cu): an intra frame's
sequential reconstruction, one launch per intra frame (encode and decode).

Bytes: the int32 residuals (the quads' too with VBS), the MVs, split flags
and sub-MVs read once, the uint8 frame written once.
"""
from __future__ import annotations

from portbench.kernels._shapes import dims


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    vbs = bool(cfg.get("vbs_enable"))
    return nb * bs * bs * 4 * (2 if vbs else 1) + nb * 4 + (nb * (1 + 16) if vbs else 0) + px, 0
