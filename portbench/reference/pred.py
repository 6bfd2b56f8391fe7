"""Inter prediction gather and the uint8 wrap.

Twin of ``streamoptima_tpu.core.pred.gather_predictions``: the plain version
of the ``pred_fetch`` kernel's two modes.  The three boundary cases of
calculate_inter_frame_residual (Encoder.py:432-460), reconstruct_frame
(Encoder.py:831-932) and decode_frame_inter (decoder.py:97-211), with
(px, py) = (scale*x + dx, scale*y + dy) on the reference grid:

A. the window is valid (and under FME the margin check passes too): the
   n x n window at (py, px), stepping 2 on the half-pel grid under FME;
B. FME only: the primary bounds hold but the margin check fails: 128;
C. the primary bounds fail: the contiguous stride-1 window of the grid,
   zero outside it (handle_boundary_conditions, Encoder.py:750-768) — also
   under FME, where the reference ignores the half-pel stride here.

Validity (strict, the reference's off-by-one): 0 <= px < W - n and
0 <= py < H - n; FME margin: 0 <= px + 2n < W - m (same for y).  The
margin's subtrahend m is ``fme_margin``, by default the (sub)block's own
size n: the native engine uses n on the residual path and the decode path
alike (its K18 fix), so decode predicts exactly what the encoder's residual
was computed against.  The compat engine keeps the reference's quirk K18:
its reconstruction and decode pass the parent block's size for the VBS
quads (Encoder.py:910, decoder.py:185), its residual path n.
"""
from __future__ import annotations

import torch


def gather_predictions(mvs: torch.Tensor, grid: torch.Tensor, bx: torch.Tensor, by: torch.Tensor, n: int,
                       fme: bool = False, grid_dims: tuple | None = None, origin_row: int = 0,
                       fme_margin: int | None = None) -> torch.Tensor:
    """Predicted (sub)blocks for chosen MVs.

    mvs: (nb, 3) int [dx, dy, ref]; grid: (nref, H, W) reference grids (the
    frames, or the (2h-1, 2w-1) half-pel grids under ``fme``); bx, by: (nb,)
    (sub)block top-left pixel coordinates (not doubled); n: the (sub)block
    size; ``fme_margin``: the FME margin's subtrahend (default n).  Returns
    (nb, n, n) int32.

    Band form (the JAX twin's, for mesh tiles): ``grid`` may be a band of
    whole rows of the reference grid.  ``grid_dims`` is the whole grid's
    (H, W), which every case and bound uses, and ``origin_row`` the band's
    first row in grid units.  A read in the grid but outside the band takes
    the band's nearest row.
    """
    H, W = grid.shape[-2:] if grid_dims is None else grid_dims
    band_h = grid.shape[-2]
    scale = 2 if fme else 1
    mvs = mvs.to(torch.int64)
    px = scale * bx.to(torch.int64) + mvs[:, 0]
    py = scale * by.to(torch.int64) + mvs[:, 1]
    ref = mvs[:, 2][:, None, None]
    i = torch.arange(n, device=grid.device)

    def window(step: int):
        rows = py[:, None] + step * i[None, :]
        cols = px[:, None] + step * i[None, :]
        inside = ((rows >= 0) & (rows < H))[:, :, None] & ((cols >= 0) & (cols < W))[:, None, :]
        band_rows = (rows.clamp(0, H - 1) - origin_row).clamp(0, band_h - 1)
        g = grid[ref, band_rows[:, :, None], cols.clamp(0, W - 1)[:, None, :]]
        return torch.where(inside, g.to(torch.int32), 0)

    g1 = window(1)  # cases A (whole-pel) and C
    if not fme:
        return g1
    valid1 = (px >= 0) & (px < W - n) & (py >= 0) & (py < H - n)
    m = n if fme_margin is None else fme_margin
    valid2 = (px + 2 * n >= 0) & (px + 2 * n < W - m) & (py + 2 * n >= 0) & (py + 2 * n < H - m)
    case_ab = torch.where(valid2[:, None, None], window(2), 128)
    return torch.where(valid1[:, None, None], case_ab, g1)


def wrap_uint8(x: torch.Tensor) -> torch.Tensor:
    """``(pred + residual).astype(np.uint8)`` semantics: wrap modulo 256."""
    return (x & 255).to(torch.uint8)
