"""Frame <-> block tiling (pure reshapes).

Twin of ``streamoptima_tpu.core.blocks`` (blockify / unblockify) and of the
JAX engine's ``_blockify``: frames become ``(n_blocks, bs, bs)`` in raster
order.
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
