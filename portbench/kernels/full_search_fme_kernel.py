"""``full_search_fme_kernel<VBS, BSC>`` (csrc/full_search_fme.cu): the
half-pel full search, one launch per inter frame.

Bytes: the current frame and the four parity planes of each reference read
once, and the MVs, SADs and ok flags written (five sets with VBS: the
block and its quads).  Operations: the abs-diffs the search needs, per
reference: a block's pixels for each half-pel candidate valid for the
block and, with VBS, for a candidate valid only for some of its quads,
those quads' pixels.  They are counted on the packed basis of PERF.md's
kernel table, ``PACKED`` abs-diffs to an operation at the INT32 rate: the
kernel sums four bytes per accumulating VABSDIFF4, so one abs-diff per lane
and clock is no ceiling for it (at 1088p, sr 16, it already ran at 0.91 of
that on an H100).
"""
from __future__ import annotations

import functools

import torch

from portbench.kernels._shapes import dims, nth_frame, refs_at
from portbench.reference.me import block_origins, candidate_valid_mask, quad_origins

#: abs-diffs to an operation at the INT32 rate of ``peaks.json``
PACKED = 2


@functools.lru_cache(maxsize=None)
def abs_diffs(h: int, w: int, bs: int, sr: int, vbs: bool) -> int:
    """Abs-diffs of one reference's search over every block: half-pel
    candidates (grid range 2sr on the (2h - 1, 2w - 1) grid) that the
    search's strict bounds and FME margin make valid, bs^2 each for the
    block, and with VBS (bs / 2)^2 for each quad valid where its block is
    not."""
    cpu = torch.device("cpu")
    H2, W2 = 2 * h - 1, 2 * w - 1
    bx, by = block_origins(h, w, bs, cpu)
    ok = candidate_valid_mask(2 * bx, 2 * by, 2 * sr, bs, H2, W2, fme=True)
    n = int(ok.sum()) * bs * bs
    if vbs:
        qx, qy = quad_origins(h, w, bs, cpu)
        for q in range(4):  # one quad at a time: the masks are (4sr + 1)^2 x blocks
            vq = candidate_valid_mask(2 * qx[:, q], 2 * qy[:, q], 2 * sr, bs // 2, H2, W2, fme=True)
            n += int((vq & ~ok).sum()) * (bs // 2) ** 2
    return n


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    vbs = launch["template"][0] == "true" if launch["template"] else bool(cfg.get("vbs_enable"))
    i = nth_frame(frames, launch["nth"], 1)
    if i is None:
        return None
    nref = refs_at(frames, i, cfg.get("n_ref_frames", 1))
    out = nb * (5 if vbs else 1) * (12 + 4 + 1)
    ops = abs_diffs(h, w, bs, cfg.get("search_range", 16), vbs) * nref // PACKED
    return (1 + 4 * nref) * px + out, ops
