"""``window_fetch_kernel`` (csrc/window_fetch.cu): fast ME's confirm read,
one launch per inter frame: each block's (bs + 2)^2 region of every plane
(four parity planes a reference under FME, else the reference).

Bytes: the planes read once (the regions tile them), each block's two
origins read, the regions written.
"""
from __future__ import annotations

from portbench.kernels._shapes import dims


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    planes = cfg.get("n_ref_frames", 1) * (4 if cfg.get("fme_enable") else 1)
    return planes * px + nb * 8 + nb * planes * (bs + 2) ** 2, 0
