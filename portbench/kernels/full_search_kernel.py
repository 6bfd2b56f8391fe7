"""``full_search_kernel<VBS, BSC, CUR_SMEM>`` (csrc/full_search.cu): the
whole-pel full search, one launch per inter frame.

Bytes: the current frame and each reference read once; the MVs, SADs and
ok flags written (five sets with VBS: the block and its quads) and, without
VBS, the winners' int16 prediction plane.  Operations: an abs-diff-
accumulate for each pixel of each candidate that is valid for the block
(with VBS, for the block or one of its quads), per reference.
"""
from __future__ import annotations

import functools

import torch

from portbench.kernels._shapes import dims, nth_frame, refs_at
from portbench.reference.me import block_origins, candidate_valid_mask, quad_origins


@functools.lru_cache(maxsize=None)
def valid_candidates(h: int, w: int, bs: int, sr: int, vbs: bool) -> int:
    """Candidates the search's strict bounds make valid, over every block
    (with VBS, those valid for the block or one of its quads)."""
    bx, by = block_origins(h, w, bs, torch.device("cpu"))
    ok = candidate_valid_mask(bx, by, sr, bs, h, w, fme=False)
    if vbs:
        qx, qy = quad_origins(h, w, bs, torch.device("cpu"))
        vq = candidate_valid_mask(qx.reshape(-1), qy.reshape(-1), sr, bs // 2, h, w, fme=False)
        ok |= vq.reshape(vq.shape[0], vq.shape[1], -1, 4).any(dim=-1)
    return int(ok.sum())


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    vbs = launch["template"][0] == "true" if launch["template"] else bool(cfg.get("vbs_enable"))
    i = nth_frame(frames, launch["nth"], 1)
    if i is None:
        return None
    nref = refs_at(frames, i, cfg.get("n_ref_frames", 1))
    out = nb * 5 * (12 + 4 + 1) if vbs else nb * (12 + 4 + 1) + 2 * px
    ops = valid_candidates(h, w, bs, cfg.get("search_range", 16), vbs) * bs * bs * nref
    return (1 + nref) * px + out, ops
