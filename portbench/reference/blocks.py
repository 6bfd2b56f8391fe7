"""Frame <-> block tiling and VBS quads (pure reshapes).

Twin of ``streamoptima_tpu.core.blocks`` (blockify / unblockify,
split_quads / merge_quads) and of the JAX engine's ``_blockify``,
``_quads_of``, ``_merge_quads`` and ``_quads_px``: frames become
``(n_blocks, bs, bs)`` in raster order, and each block's four quads are
``(n_blocks, 4, bs/2, bs/2)`` in the reference's Z order TL, TR, BL, BR
(Encoder.py:517-519 loops y then x).
"""
from __future__ import annotations

import torch


def blockify(frame: torch.Tensor, bs: int) -> torch.Tensor:
    """(h, w) -> (n_blocks, bs, bs) raster order."""
    h, w = frame.shape
    return frame.reshape(h // bs, bs, w // bs, bs).transpose(1, 2).reshape(-1, bs, bs)


def unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(n_blocks, bs, bs) -> (h, w), the inverse of ``blockify``."""
    bs = blocks.shape[-1]
    return blocks.reshape(h // bs, w // bs, bs, bs).transpose(1, 2).reshape(h, w)


def split_quads(blocks: torch.Tensor) -> torch.Tensor:
    """(nb, bs, bs) -> (nb, 4, bs/2, bs/2) quads in Z order."""
    nb, bs = blocks.shape[0], blocks.shape[-1]
    s = bs // 2
    return blocks.reshape(nb, 2, s, 2, s).transpose(2, 3).reshape(nb, 4, s, s)


def merge_quads(quads: torch.Tensor) -> torch.Tensor:
    """(nb, 4, s, s) -> (nb, 2s, 2s), the inverse of ``split_quads``."""
    nb, s = quads.shape[0], quads.shape[-1]
    return quads.reshape(nb, 2, 2, s, s).transpose(2, 3).reshape(nb, 2 * s, 2 * s)


def quads_px(frame: torch.Tensor, bs: int) -> torch.Tensor:
    """(h, w) pixel plane -> (nb, 4, bs/2, bs/2): each block's quads."""
    return split_quads(blockify(frame, bs))


def unquads_px(quads: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(nb, 4, s, s) -> (h, w) pixel plane, the inverse of ``quads_px``."""
    return unblockify(merge_quads(quads), h, w)
