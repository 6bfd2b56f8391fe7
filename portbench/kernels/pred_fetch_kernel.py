"""``pred_fetch_kernel<BSC>`` (csrc/pred_fetch.cu): an inter frame's
prediction planes at its MVs, one launch per inter frame (encode and
decode), whole-pel or half-pel, with the quads' plane under VBS.

Bytes: the MVs read (and the quads' with VBS), the reference pixels under
the frame's blocks read once (one byte a pixel: the block and quad planes
read the same area where their MVs agree, as coherent motion makes them),
and each int16 plane written.  No arithmetic to speak of.
"""
from __future__ import annotations

from portbench.kernels._shapes import dims


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    if cfg.get("vbs_enable"):
        return nb * 5 * 12 + px + 4 * px, 0
    return nb * 12 + px + 2 * px, 0
