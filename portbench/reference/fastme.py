"""Fast motion estimation: the 3x3 search around a chained MVP.

Twin of ``streamoptima_tpu.core.fastme`` (``_region_base``, ``_cand_valid``,
``pick9``, ``eval9``, ``confirm``) and of the one-block definition
``streamoptima_tpu.core.me.fast_candidates``, as plain tensor operations;
and the plain PyTorch versions of the two fast-ME kernels of
``core/kernels.py`` (``window_fetch_plain``, ``rowscan_pass_plain``).

What fast ME computes (Encoder.py:719-742): each block searches the nine
positions MVP + {-1, 0, 1}^2 of every reference, where the MVP is the
previous block's MV in raster order (block 0: zero).  The winner is the
first minimum in (ref, dx, dy) scan order, dx outer and dy inner, with no L1
term.  A candidate at grid position p of an n-sized (sub)block is valid when
``0 <= p < D - n`` and ``0 <= p + 2n < D - n`` on both axes (quirk K7: the
margin also applies whole-pel), D the grid's extent.  With no valid
candidate the MV is the MVP itself, reference index included, the SAD is
INT32_MAX and the chain carries that MV on (quirk K8).

Under FME the grid is the (2h-1, 2w-1) half-pel upsample, read through the
four parity planes of ``me.fme_parity_planes``: grid pixel (Y, X) is plane
(Y & 1, X & 1) at (Y >> 1, X >> 1), so a candidate's stride-2 window on the
grid is a contiguous window of one plane.  All nine candidates of a block
lie inside the (n+2)^2 region of each plane based at ``region_base``; the
planes' zero pad row and column stand for grid coordinates past the grid and
read as 0.  MVs drift one step per block across the whole frame and are not
bounded by the search range; every origin here is plain integer arithmetic
with zero fill outside the planes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import blockify

INT32_MAX = 2**31 - 1


def _floor_half(v: torch.Tensor) -> torch.Tensor:
    """floor(v / 2) for integers of either sign."""
    return torch.div(v, 2, rounding_mode="floor")


def region_base(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor, fme: bool):
    """Origin (row, column) of the (n+2)^2 region that holds the 3x3 search
    around MVP ``g`` (nb, 3) for (sub)blocks at pixel origins ``y``, ``x``.

    Whole-pel: frame coordinates (y + gy - 1, x + gx - 1).  FME: parity-plane
    coordinates (y + floor((gy - 1) / 2), x + floor((gx - 1) / 2)), so the
    nine candidates' plane windows start at offsets {0, 1} from it."""
    gx, gy = g[:, 0], g[:, 1]
    if fme:
        return y + _floor_half(gy - 1), x + _floor_half(gx - 1)
    return y + gy - 1, x + gx - 1


def cand_valid(g: torch.Tensor, X: torch.Tensor, Y: torch.Tensor, n: int, dims: tuple[int, int]) -> torch.Tensor:
    """(nb, 3, 3) bool [dyi, dxi]: the K7 bounds of each candidate of MVP
    ``g`` for n-sized (sub)blocks at grid origins ``X``, ``Y`` (doubled under
    FME) on a grid of ``dims`` = (H, W).  The same for every reference."""
    H, W = dims
    d = torch.arange(-1, 2, device=g.device)
    px = X[:, None] + g[:, None, 0] + d[None, :]
    py = Y[:, None] + g[:, None, 1] + d[None, :]
    okx = (px >= 0) & (px < W - n) & (px + 2 * n >= 0) & (px + 2 * n < W - n)
    oky = (py >= 0) & (py < H - n) & (py + 2 * n >= 0) & (py + 2 * n < H - n)
    return oky[:, :, None] & okx[:, None, :]


def pick9(sads: torch.Tensor, valid: torch.Tensor, g: torch.Tensor):
    """Winner of the 3x3 search.

    sads: (nb, nref, 3, 3) int32 [ref, dyi, dxi]; valid: (nb, 3, 3) bool;
    g: (nb, 3) the MVPs [gx, gy, gref].  Returns (mv (nb, 3) int32,
    sad (nb,) int32, ok (nb,) bool): the first minimum in (ref, dx, dy) scan
    order, or the MVP itself with SAD INT32_MAX where no candidate is valid.
    The minimum is taken over the packed (SAD, scan index) key, so ties do
    not depend on the device's reduction order."""
    nb, nref = sads.shape[:2]
    ncand = 9 * nref
    sm = torch.where(valid[:, None], sads, INT32_MAX).to(torch.int64)
    order = sm.transpose(2, 3).reshape(nb, ncand)  # ref-major, then dx, then dy
    key = (order * ncand + torch.arange(ncand, device=sads.device)).min(dim=1).values
    best, k = key // ncand, key % ncand
    ok = best != INT32_MAX
    won = torch.stack([g[:, 0] + (k % 9) // 3 - 1, g[:, 1] + k % 3 - 1, k // 9], dim=-1)
    mv = torch.where(ok[:, None], won, g.to(torch.int64)).to(torch.int32)
    return mv, best.to(torch.int32), ok


def sad9(win: torch.Tensor, cur_blk: torch.Tensor, g: torch.Tensor, n: int, fme: bool, row0: int = 0,
         col0: int = 0) -> torch.Tensor:
    """The nine candidates' SADs per reference from fetched regions.

    win: (nb, P, nwin, nwin) regions based at ``region_base(g)``, P = nref
    whole-pel or 4 * nref parity planes under FME; cur_blk: (nb, n, n) int32;
    (row0, col0): the (sub)block's pixel offset inside its block's region (a
    quad's).  Returns (nb, nref, 3, 3) int32 [ref, dyi, dxi].

    Whole-pel, candidate (dyi, dxi) is the window at region offset
    (dyi, dxi).  Under FME it sits at grid offset (gy + dyi - 1, gx + dxi - 1)
    from the block: with a = gy & 1 and t = dyi + 1 - a, in the plane of row
    parity t & 1 at region row offset t >> 1 (the same for columns), so the
    nine SADs are picked from the 16 (parity, offset) combinations."""
    nb = win.shape[0]
    w = win.to(torch.int32)

    def sad_grid(planes, no):  # (..., nwin, nwin) -> (..., no, no): SADs at region offsets [oy, ox]
        reg = planes[..., row0:row0 + n + no - 1, col0:col0 + n + no - 1]
        shifted = reg.unfold(-2, n, 1).unfold(-2, n, 1)  # (..., no, no, n, n)
        cur = cur_blk.reshape(nb, *(1,) * (planes.dim() - 1), n, n)
        return (shifted - cur).abs().sum(dim=(-2, -1), dtype=torch.int32)

    if not fme:
        return sad_grid(w, 3)
    nref = win.shape[1] // 4
    # sad16[b, r, qy, qx, oy, ox]
    sad16 = sad_grid(w.reshape(nb, nref, 4, *win.shape[-2:]), 2).reshape(nb, nref, 2, 2, 2, 2)
    d = torch.arange(3, device=win.device)
    ty = d[None, :] + 1 - (g[:, 1] & 1)[:, None]  # (nb, 3) by dyi
    tx = d[None, :] + 1 - (g[:, 0] & 1)[:, None]
    b = torch.arange(nb, device=win.device)[:, None, None, None]
    r = torch.arange(nref, device=win.device)[None, :, None, None]
    ty, tx = ty[:, None, :, None], tx[:, None, None, :]
    return sad16[b, r, ty & 1, tx & 1, ty >> 1, tx >> 1]


def confirm(win: torch.Tensor, cur_blk: torch.Tensor, g: torch.Tensor, X: torch.Tensor, Y: torch.Tensor, bs: int,
            dims: tuple[int, int], fme: bool, vbs: bool) -> dict:
    """One batched pass at the converged MVPs ``g``: each block's winner, and
    under VBS the four quad searches (Encoder.py:549-560: the quads search
    around the block-level MVP, with their own origin and size in the K7
    bounds, and never feed the chain).

    win: (nb, P, bs + 2, bs + 2) regions fetched at ``region_base(g)``;
    cur_blk: (nb, bs, bs) int32; X, Y: block origins on the grid (doubled
    under FME).  Returns {"mv", "sad", "ok"} and, with ``vbs``, {"sub_mv",
    "sub_sad", "sub_ok"} ((nb, 4, 3), (nb, 4), (nb, 4), quads in Z order).
    The winners' pixels are not produced here: the prediction-fetch kernels
    serve any MV, the K8 fallback's included."""
    mv, sad, ok = pick9(sad9(win, cur_blk, g, bs, fme), cand_valid(g, X, Y, bs, dims), g)
    out = {"mv": mv, "sad": sad, "ok": ok}
    if not vbs:
        return out
    s = bs // 2
    scale = 2 if fme else 1
    quads = []
    for oy, ox in ((0, 0), (0, s), (s, 0), (s, s)):
        cq = cur_blk[:, oy:oy + s, ox:ox + s]
        valid = cand_valid(g, X + scale * ox, Y + scale * oy, s, dims)
        quads.append(pick9(sad9(win, cq, g, s, fme, oy, ox), valid, g))
    out["sub_mv"], out["sub_sad"], out["sub_ok"] = (torch.stack(t, dim=1) for t in zip(*quads))
    return out


# ------------------------------------------- plain versions of the kernels
def window_fetch_plain(planes: torch.Tensor, by0: torch.Tensor, bx0: torch.Tensor, nwin: int,
                       nwin_c: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the ``window_fetch`` kernel (any device):
    ``out[b, p, i, j] = planes[p, by0[b] + i, bx0[b] + j]``, zero outside the
    plane, as one indexing read of the zero-padded planes.

    planes: (P, H, W) uint8; by0, bx0: (nb,) integer origins of any value.
    Returns (nb, P, nwin, nwin_c) uint8.  An origin clamped to [-nwin, H]
    (columns alike) reads the same zeros as the true one: past either bound
    the window misses the plane entirely."""
    nc = nwin if nwin_c is None else nwin_c
    P, H, W = planes.shape
    padded = F.pad(planes, (nc, nc, nwin, nwin))
    rows = by0.to(torch.int64).clamp(-nwin, H)[:, None] + nwin + torch.arange(nwin, device=planes.device)
    cols = bx0.to(torch.int64).clamp(-nc, W)[:, None] + nc + torch.arange(nc, device=planes.device)
    return padded[:, rows[:, :, None], cols[:, None, :]].transpose(0, 1).contiguous()


def rowscan_pass_plain(cur: torch.Tensor, planes: torch.Tensor, seeds: torch.Tensor, bs: int, fme: bool, *,
                       g_row0: int = 0, grid=None) -> torch.Tensor:
    """Plain PyTorch version of the ``rowscan_pass`` kernel (any device): one
    sweep pass of the MVP chain, a Python loop over the L block columns,
    batched over the S block rows.

    cur: (h, w) uint8, frame rows [g_row0, g_row0 + h); planes: (nref, 4, H,
    w) uint8 parity planes of the whole frame under ``fme``, else the (nref,
    H, w) uint8 references (``grid``, if given, their (H, w)); seeds: (S, 3)
    int32, the guessed MVP of each row's first block.  Returns (S, L, 3) int32 with ``mv[s, j] =
    f(mv[s, j - 1])`` from ``mv[s, -1] = seeds[s]``, each step the 3x3 search
    of ``pick9`` at frame rows."""
    h, w = cur.shape
    H = planes.shape[-2] if grid is None else grid[0]
    S, L = h // bs, w // bs
    scale = 2 if fme else 1
    dims = (2 * H - 1, 2 * w - 1) if fme else (H, w)
    flat = planes.reshape(-1, H, w)
    cur_b = blockify(cur, bs).to(torch.int32).reshape(S, L, bs, bs)
    ys = g_row0 + torch.arange(S, device=cur.device, dtype=torch.int32) * bs  # each segment's frame row
    g = seeds
    out = []
    for j in range(L):
        x = torch.full_like(ys, j * bs)
        by0, bx0 = region_base(g, ys, x, fme)
        win = window_fetch_plain(flat, by0, bx0, bs + 2)
        g, _, _ = pick9(sad9(win, cur_b[:, j], g, bs, fme), cand_valid(g, scale * x, scale * ys, bs, dims), g)
        out.append(g)
    return torch.stack(out, dim=1)
