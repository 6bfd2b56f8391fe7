"""Mode-0 (horizontal) intra prediction: parallel search, residuals, recon.

Twin of ``streamoptima_tpu.core.intra`` for ``intra_mode=0`` without VBS.
During search the reference reconstructs from UNQUANTIZED residuals, so the
search frame is the original under a causal mask (``col < x``) and 128
elsewhere: every block's SAD at shift ``dx`` is a sum of per-column band SADs
left of the frontier plus ``|cur - 128|`` sums right of it, all static
segment sums.  Tie-break (Encoder.py:1034-1043): minimal |dx|, then the later
positive dx; border blocks (x == 0) take mv = -1 against an all-128 block.

Reconstruction from the quantized residuals is sequential along each block
row; for sr < bs its true dependency depth is bounded, so it runs as a few
whole-frame passes (the wavefront variant, the main path), and as a column
scan with a select over the sr+1 shifts otherwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from streamoptima_tpu_torch.core.blocks import blockify

_INF32 = 2**31 - 1


def intra_search_mode0(cur: torch.Tensor, bs: int, sr: int, canvas_w: int):
    """Mode-0 intra search for all full blocks of ``cur`` (h, w); the VBS
    quad search is not ported yet.

    Returns {"mv": (nbr, nbc) int32 chosen dx (border col: -1),
    "sad": (nbr, nbc) int32}.
    """
    h, w = cur.shape
    s = bs // 2
    nbr, nbc = h // bs, w // bs
    nbr2 = h // s
    ndx = 2 * sr + 1
    dev = cur.device
    c32 = cur.to(torch.int32)
    pad_ref = F.pad(c32, (sr, canvas_w - w + sr), value=128)
    # int16 band sums: |diff| <= 255 and an s-row band sum <= 8*255 = 2040;
    # the two-band combine <= 4080 is still int16.  Block sums over up to bs
    # columns widen to int32 (they reach 65280).
    c16 = c32.to(torch.int16)
    pad16 = pad_ref.to(torch.int16)
    full_rows = []
    for dxi in range(ndx):
        d16 = (pad16[:, dxi : dxi + w] - c16).abs()  # shifted[c] = orig[c + dx]
        band = d16.reshape(nbr2, s, w).sum(dim=1, dtype=torch.int16)
        full_rows.append(band.reshape(nbr, 2, w).sum(dim=1, dtype=torch.int16))
    col128 = (c16 - 128).abs().reshape(nbr2, s, w).sum(dim=1, dtype=torch.int16)
    full128 = col128.reshape(nbr, 2, w).sum(dim=1, dtype=torch.int16)

    # SAD(dx) = sum_{j < t} band_dx[x + j] + sum_{t <= j < bs} rows128[x + j],
    # t = clip(-dx, 0, bs): segment sums at bs-aligned starts, static per dx
    g128 = full128.reshape(nbr, nbc, bs)
    sads = []
    for dxi in range(ndx):
        t = min(max(-(dxi - sr), 0), bs)
        a = full_rows[dxi].reshape(nbr, nbc, bs)[:, :, :t].sum(dim=2, dtype=torch.int32)
        b = g128[:, :, t:bs].sum(dim=2, dtype=torch.int32)
        sads.append(a + b)
    sad = torch.stack(sads)  # (ndx, nbr, nbc)
    dx = torch.arange(-sr, sr + 1, device=dev, dtype=torch.int32)
    x_full = torch.arange(nbc, device=dev, dtype=torch.int32) * bs
    valid = (x_full[None, :] + dx[:, None] >= 0) & (x_full[None, :] + dx[:, None] + bs <= canvas_w)
    sad_m = torch.where(valid[:, None, :], sad, _INF32)
    best = sad_m.min(dim=0).values
    sec = ((dx.abs() << 8) | (sr - dx))[:, None, None]
    sec_m = torch.where(sad_m == best[None], sec, _INF32)
    mv = sr - (sec_m.min(dim=0).values & 0xFF)

    # border col x == 0: forced mv = -1, SAD against 128 (Encoder.py:1020-1024)
    b128 = (c32 - 128).abs().reshape(nbr, bs, nbc, bs)[:, :, 0, :].sum(dim=(1, 2), dtype=torch.int32)
    mv[:, 0] = -1
    best[:, 0] = b128
    return {"mv": mv.to(torch.int32), "sad": best.to(torch.int32)}


def intra_residuals_mode0(cur: torch.Tensor, mv: torch.Tensor, bs: int, sr: int) -> torch.Tensor:
    """Unquantized residuals ``cur - masked window`` for chosen intra MVs.

    mv: (nbr, nbc) in [-sr, 0] (border col -1).  The window of the block at
    x with mv = m reads pixel column x' from ``frame[:, x' + m]`` wherever
    ``x' + m < x`` (already coded) and 128 elsewhere, assembled as a masked
    select over the sr+1 global column shifts.  Returns (nb, bs, bs) int32.
    """
    h, w = cur.shape
    nbr, nbc = h // bs, w // bs
    dev = cur.device
    c32 = cur.to(torch.int32)
    fp = F.pad(c32, (sr, 0), value=128)
    xcols = torch.arange(w, device=dev)
    parent = (xcols // bs) * bs
    mv_px = mv.reshape(nbr, 1, nbc, 1).expand(nbr, bs, nbc, bs).reshape(h, w)
    pred = torch.full((h, w), 128, dtype=torch.int32, device=dev)
    for m in range(-sr, 1):
        cond = (mv_px == m) & (xcols[None, :] + m < parent[None, :])
        pred = torch.where(cond, fp[:, sr + m : sr + m + w], pred)
    return blockify(c32, bs) - blockify(pred, bs)


def intra_reconstruct_mode0(residual_full: torch.Tensor, mv: torch.Tensor, h: int, w: int, bs: int,
                            sr: int) -> torch.Tensor:
    """Sequential intra reconstruction (quantized residuals), mode 0.

    residual_full: (nb, bs, bs) int32 dequantized residuals; mv: (nb,).
    Returns the (h, w) int32 frame, unwrapped (the caller applies the uint8
    wrap; wrapping at the end equals wrapping before every read, mod 256).
    """
    nbr, nbc = h // bs, w // bs
    rf = residual_full.reshape(nbr, nbc, bs, bs)
    mvr = mv.reshape(nbr, nbc)
    if sr < bs:
        return _reconstruct_wavefront(rf, mvr, h, w, bs, sr)
    return _reconstruct_select(rf, mvr, h, w, bs, sr)


def _select_shift(regions, mv_sel, n: int, sr: int):
    """regions (..., bs, sr + bs): the n x n window at column offset sr + m
    for per-entry shifts ``mv_sel`` in [-sr, 0]; anything else keeps 128."""
    win = torch.full(regions.shape[:-2] + (n, n), 128, dtype=torch.int32, device=regions.device)
    for m in range(-sr, 1):
        cand = regions[..., 0:n, sr + m : sr + m + n]
        win = torch.where((mv_sel == m)[..., None, None], cand, win)
    return win


def _reconstruct_select(rf, mvr, h, w, bs, sr):
    """Column scan over a left-padded band: block c reads the sr + bs columns
    left of its write position and selects among the sr+1 static shifts."""
    nbr, nbc = rf.shape[:2]
    band = torch.full((nbr, bs, w + sr), 128, dtype=torch.int32, device=rf.device)
    for c in range(nbc):
        x = c * bs
        if c == 0:
            win = torch.full((nbr, bs, bs), 128, dtype=torch.int32, device=rf.device)
        else:
            win = _select_shift(band[:, :, x : x + sr + bs], mvr[:, c], bs, sr)
        band[:, :, x + sr : x + sr + bs] = win + rf[:, c]
    return band[:, :, sr:].reshape(h, w)


def _reconstruct_wavefront(rf, mvr, h, w, bs, sr):
    """Bounded-depth parallel reconstruction for sr < bs.

    Block c reads at most the last sr columns of block c-1, and those hold
    real (non-fill) data only through a chain whose reach shrinks by bs - sr
    per hop, so ceil(bs / (bs - sr)) whole-frame passes from the all-128
    start reach the sequential result exactly.  Each pass recomputes every
    block from the previous iterate, with the columns at and right of the
    block pinned to the 128 fill (the sequential order reads them unwritten).
    """
    nbr, nbc = rf.shape[:2]
    q, r = divmod(bs, bs - sr)
    iters = q + (1 if r else 0)
    tail128 = torch.full((nbr, nbc, bs, bs), 128, dtype=torch.int32, device=rf.device)
    band = torch.full((nbr, bs, w), 128, dtype=torch.int32, device=rf.device)
    for _ in range(iters):
        padded = F.pad(band, (sr, 0), value=128)
        # block c's left region: columns [x - sr, x) of the previous iterate
        left = padded[:, :, :w].reshape(nbr, bs, nbc, bs)[:, :, :, :sr].permute(0, 2, 1, 3)
        regions = torch.cat([left, tail128], dim=3)  # (nbr, nbc, bs, sr + bs)
        blk = _select_shift(regions, mvr, bs, sr) + rf
        band = blk.permute(0, 2, 1, 3).reshape(nbr, bs, w)
    return band.reshape(h, w)
