"""Whole-pel inter prediction gather and the uint8 wrap.

Twin of ``streamoptima_tpu.core.pred.gather_predictions`` with ``fme=False``
(the plain version of the ``pred_fetch`` kernel): each block's window of
``refs[ref]`` at ``(by + dy, bx + dx)``, zero outside the frame — the
reference's handle_boundary_conditions fill.
"""
from __future__ import annotations

import torch


def gather_predictions(mvs: torch.Tensor, refs: torch.Tensor, bx: torch.Tensor, by: torch.Tensor,
                       bs: int) -> torch.Tensor:
    """Predicted blocks for chosen whole-pel MVs.

    mvs: (nb, 3) int [dx, dy, ref]; refs: (nref, H, W) int/uint8; bx, by:
    (nb,) block top-left pixel coordinates.  Returns (nb, bs, bs) int32.
    """
    H, W = refs.shape[-2:]
    mvs = mvs.to(torch.int64)
    px = bx.to(torch.int64) + mvs[:, 0]
    py = by.to(torch.int64) + mvs[:, 1]
    ref = mvs[:, 2]
    i = torch.arange(bs, device=refs.device)
    rows = py[:, None] + i[None, :]
    cols = px[:, None] + i[None, :]
    rin = (rows >= 0) & (rows < H)
    cin = (cols >= 0) & (cols < W)
    g = refs[ref[:, None, None], rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :]]
    return torch.where(rin[:, :, None] & cin[:, None, :], g.to(torch.int32), 0)


def wrap_uint8(x: torch.Tensor) -> torch.Tensor:
    """``(pred + residual).astype(np.uint8)`` semantics: wrap modulo 256."""
    return (x & 255).to(torch.uint8)
