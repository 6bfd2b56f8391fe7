"""``rowscan_pass_kernel<NC, A>`` (csrc/rowscan_pass.cu): one sweep pass of
fast ME's MVP chain over every block row, one launch per pass.

Bytes: the current frame and the planes (four parity planes a reference
under FME) read once, the rows' seeds read and written, every block's MV
written.  Operations: the 3x3 search's abs-diff-accumulates of the blocks
whose nine candidates all lie inside the frame at the zero MVP (a bound
below what any pass needs; the bytes bound every pass at 720p).
"""
from __future__ import annotations

from portbench.kernels._shapes import dims


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    nref = cfg.get("n_ref_frames", 1)
    planes = nref * (4 if cfg.get("fme_enable") else 1)
    rows = h // bs
    interior = max(h // bs - 2, 0) * max(w // bs - 2, 0)
    return px + planes * px + 2 * rows * 12 + nb * 12, interior * 9 * bs * bs * nref
