"""Mode-0 (horizontal) intra prediction: parallel search, residuals, recon.

Twin of ``streamoptima_tpu.core.intra`` for ``intra_mode=0``, with or
without the VBS quads.  During search the reference reconstructs from
UNQUANTIZED residuals, so the search frame is the original under a causal
mask (``col < x``) and 128 elsewhere: every block's SAD at shift ``dx`` is a
sum of per-column band SADs left of the frontier plus ``|cur - 128|`` sums
right of it, all static segment sums.  Tie-break (Encoder.py:1034-1043): minimal |dx|, then the later
positive dx; border blocks (x == 0) take mv = -1 against an all-128 block.

Reconstruction from the quantized residuals is sequential along each block
row; for sr < bs its true dependency depth is bounded, so it runs as a few
whole-frame passes (the wavefront variant, the main path), and as a column
scan with a select over the sr+1 shifts otherwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import blockify, split_quads

_INF32 = 2**31 - 1

_QUAD_OFFS = ((0, 0), (0, 1), (1, 0), (1, 1))  # Z order: TL, TR, BL, BR


def intra_search_mode0(cur: torch.Tensor, bs: int, sr: int, canvas_w: int, vbs: bool = False):
    """Mode-0 intra search for all full blocks of ``cur`` (h, w), and the
    VBS quads when ``vbs``.

    Returns {"mv": (nbr, nbc) int32 chosen dx (border col: -1),
    "sad": (nbr, nbc) int32}, plus "sub_mv" / "sub_sad" (nbr, nbc, 4) int32
    in Z order when ``vbs``.
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
    colsums = []
    for dxi in range(ndx):
        d16 = (pad16[:, dxi : dxi + w] - c16).abs()  # shifted[c] = orig[c + dx]
        colsums.append(d16.reshape(nbr2, s, w).sum(dim=1, dtype=torch.int16))
    col128 = (c16 - 128).abs().reshape(nbr2, s, w).sum(dim=1, dtype=torch.int16)
    dx = torch.arange(-sr, sr + 1, device=dev, dtype=torch.int32)

    def search(band_rows, rows128, x_sub, delta: int, n: int, dc: int):
        """SAD(dx) = sum_{j < t} band_dx[x_sub + j] + sum_{t <= j < n}
        rows128[x_sub + j], t = clip(-delta - dx, 0, n): segment sums at
        n-aligned starts, static per dx.  band_rows: per-dxi (R, w);
        x_sub: (C,) block (or quad) columns.  Returns mv, sad (R, C)."""
        R, C = rows128.shape[0], x_sub.shape[0]

        def grouped(rows_w):  # (R, w) -> (R, C, n) at the x_sub alignment
            g = rows_w.reshape(R, w // n, n)
            return g if w // n == C else g.reshape(R, C, 2, n)[:, :, dc, :]

        g128 = grouped(rows128)
        sads = []
        for dxi in range(ndx):
            t = min(max(-delta - (dxi - sr), 0), n)
            a = grouped(band_rows[dxi])[:, :, :t].sum(dim=2, dtype=torch.int32)
            b = g128[:, :, t:n].sum(dim=2, dtype=torch.int32)
            sads.append(a + b)
        sad = torch.stack(sads)  # (ndx, R, C)
        valid = (x_sub[None, :] + dx[:, None] >= 0) & (x_sub[None, :] + dx[:, None] + n <= canvas_w)
        sad_m = torch.where(valid[:, None, :], sad, _INF32)
        best = sad_m.min(dim=0).values
        sec = ((dx.abs() << 8) | (sr - dx))[:, None, None]
        sec_m = torch.where(sad_m == best[None], sec, _INF32)
        return (sr - (sec_m.min(dim=0).values & 0xFF)).to(torch.int32), best.to(torch.int32)

    x_full = torch.arange(nbc, device=dev, dtype=torch.int32) * bs
    full_rows = [b.reshape(nbr, 2, w).sum(dim=1, dtype=torch.int16) for b in colsums]
    full128 = col128.reshape(nbr, 2, w).sum(dim=1, dtype=torch.int16)
    mv, sad = search(full_rows, full128, x_full, 0, bs, 0)

    # border col x == 0: forced mv = -1, SAD against 128 (Encoder.py:1020-1024)
    b128 = (c32 - 128).abs().reshape(nbr, bs, nbc, bs)[:, :, 0, :].sum(dim=(1, 2), dtype=torch.int32)
    mv[:, 0] = -1
    sad[:, 0] = b128
    out = {"mv": mv, "sad": sad}
    if vbs:
        qmv, qsad = [], []
        for dr, dc in _QUAD_OFFS:
            band_q = [b[dr::2, :] for b in colsums]  # (nbr, w): this quad's rows
            m, q = search(band_q, col128[dr::2, :], x_full + dc * s, dc * s, s, dc)
            qmv.append(m)
            qsad.append(q)
        out["sub_mv"] = torch.stack(qmv, dim=-1)
        out["sub_sad"] = torch.stack(qsad, dim=-1)
    return out


def _masked_band(fp: torch.Tensor, mv_px: torch.Tensor, bs: int, sr: int) -> torch.Tensor:
    """(h, w) prediction band for per-pixel-column MVs ``mv_px`` (constant
    per block or quad): column x' reads ``frame[:, x' + m]`` wherever
    ``x' + m`` lies left of its parent block, 128 elsewhere.  ``fp`` is the
    frame left-padded by ``sr`` columns of 128."""
    h, w = mv_px.shape
    xcols = torch.arange(w, device=mv_px.device)
    parent = (xcols // bs) * bs
    pred = torch.full((h, w), 128, dtype=torch.int32, device=mv_px.device)
    for m in range(-sr, 1):
        cond = (mv_px == m) & (xcols[None, :] + m < parent[None, :])
        pred = torch.where(cond, fp[:, sr + m : sr + m + w], pred)
    return pred


def intra_residuals_mode0(cur: torch.Tensor, mv: torch.Tensor, bs: int, sr: int, sub_mv=None):
    """Unquantized residuals ``cur - masked window`` for chosen intra MVs.

    mv: (nbr, nbc) in [-sr, 0] (border col -1); sub_mv: (nbr, nbc, 4) Z
    order, or None without VBS.  The window of the block at x with mv = m
    reads pixel column x' from ``frame[:, x' + m]`` wherever ``x' + m < x``
    (already coded) and 128 elsewhere, assembled as a masked select over the
    sr+1 global column shifts; quads share the rule (their frontier is the
    parent block's x).  Returns (full (nb, bs, bs) int32, quads (nb, 4, s,
    s) int32 or None).
    """
    h, w = cur.shape
    s = bs // 2
    nbr, nbc = h // bs, w // bs
    c32 = cur.to(torch.int32)
    fp = F.pad(c32, (sr, 0), value=128)
    cur_blocks = blockify(c32, bs)
    mv_px = mv.reshape(nbr, 1, nbc, 1).expand(nbr, bs, nbc, bs).reshape(h, w)
    full = cur_blocks - blockify(_masked_band(fp, mv_px, bs, sr), bs)
    if sub_mv is None:
        return full, None
    smv_px = sub_mv.reshape(nbr, nbc, 2, 2).permute(0, 2, 1, 3)[:, :, None, :, :, None]
    smv_px = smv_px.expand(nbr, 2, s, nbc, 2, s).reshape(h, w)
    quads = split_quads(cur_blocks - blockify(_masked_band(fp, smv_px, bs, sr), bs))
    return full, quads


def intra_reconstruct_mode0(residual_full: torch.Tensor, mv: torch.Tensor, h: int, w: int, bs: int,
                            sr: int, residual_quads=None, split=None, sub_mv=None) -> torch.Tensor:
    """Sequential intra reconstruction (quantized residuals), mode 0.

    residual_full: (nb, bs, bs) int32 dequantized residuals; mv: (nb,);
    under VBS also residual_quads (nb, 4, s, s), split (nb,) bool and
    sub_mv (nb, 4).  Returns the (h, w) int32 frame, unwrapped (the caller
    applies the uint8 wrap; wrapping at the end equals wrapping before every
    read, mod 256).
    """
    nbr, nbc = h // bs, w // bs
    s = bs // 2
    rf = residual_full.reshape(nbr, nbc, bs, bs)
    mvr = mv.reshape(nbr, nbc)
    vbs = None
    if residual_quads is not None:
        vbs = (residual_quads.reshape(nbr, nbc, 4, s, s), split.reshape(nbr, nbc), sub_mv.reshape(nbr, nbc, 4))
    if sr < bs:
        return _reconstruct_wavefront(rf, mvr, vbs, h, w, bs, sr)
    return _reconstruct_select(rf, mvr, vbs, h, w, bs, sr)


def _select_shift(regions, mv_sel, n: int, sr: int, r0: int = 0, c0: int = 0):
    """regions (..., bs, sr + bs): the n x n window at rows r0.. and column
    offset c0 + sr + m for per-entry shifts ``mv_sel`` in [-sr, 0]; anything
    else keeps 128 (a corrupt stream cannot read outside the region)."""
    win = torch.full(regions.shape[:-2] + (n, n), 128, dtype=torch.int32, device=regions.device)
    for m in range(-sr, 1):
        cand = regions[..., r0 : r0 + n, c0 + sr + m : c0 + sr + m + n]
        win = torch.where((mv_sel == m)[..., None, None], cand, win)
    return win


def _block_values(regions, mv_sel, rf, vbs, bs: int, sr: int):
    """Reconstructed blocks from their read regions: the full-block window
    plus its residual, or under VBS, where split, the four quad windows plus
    theirs.  ``vbs`` is None or (rq, split, smv) shaped like ``mv_sel``."""
    blk = _select_shift(regions, mv_sel, bs, sr) + rf
    if vbs is None:
        return blk
    rq, sp, smv = vbs
    s = bs // 2
    parts = [_select_shift(regions, smv[..., qi], s, sr, dr * s, dc * s) + rq[..., qi, :, :]
             for qi, (dr, dc) in enumerate(_QUAD_OFFS)]
    blk_sp = torch.cat([torch.cat(parts[:2], dim=-1), torch.cat(parts[2:], dim=-1)], dim=-2)
    return torch.where(sp[..., None, None], blk_sp, blk)


def _reconstruct_select(rf, mvr, vbs, h, w, bs, sr):
    """Column scan over a left-padded band: block c reads the sr + bs columns
    left of its write position and selects among the sr+1 static shifts
    (the columns at and right of the block are still the 128 fill)."""
    nbr, nbc = rf.shape[:2]
    band = torch.full((nbr, bs, w + sr), 128, dtype=torch.int32, device=rf.device)
    for c in range(nbc):
        x = c * bs
        vbs_c = None if vbs is None else tuple(a[:, c] for a in vbs)
        band[:, :, x + sr : x + sr + bs] = _block_values(band[:, :, x : x + sr + bs], mvr[:, c], rf[:, c], vbs_c,
                                                         bs, sr)
    return band[:, :, sr:].reshape(h, w)


def _reconstruct_wavefront(rf, mvr, vbs, h, w, bs, sr):
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
        blk = _block_values(regions, mvr, rf, vbs, bs, sr)
        band = blk.permute(0, 2, 1, 3).reshape(nbr, bs, w)
    return band.reshape(h, w)
