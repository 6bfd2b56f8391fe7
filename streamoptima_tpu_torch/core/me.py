"""Full-search motion estimation: SAD maps, exact tie-break argmin, FME grid.

Twin of ``streamoptima_tpu.core.me`` (``sad_maps``, ``candidate_valid_mask``,
``argmin_displacement``, ``full_search_materialized``, ``fme_upsample``,
``fme_parity_planes``).  ``full_search_materialized`` is the plain PyTorch
version of both search kernels (core/kernels.py): whole-pel without VBS, and
half-pel (FME) with VBS quads.

Reference semantics (Encoder.py:678-717): candidates (dx, dy) in [-sr, sr]^2
of the reference grid over every reference frame (under FME the grid is the
(2H-1, 2W-1) half-pel upsample and sr the doubled range, Encoder.py:1649);
the winner is the lexicographic minimum of (SAD, |dx|+|dy|, ref, dx_index,
dy_index), packed as the int32 secondary key
``((l1 << 3 | ref) << 8 | dxi) << 8 | dyi``.  A candidate is valid when
``0 <= x+dx < W - bs`` and ``0 <= y+dy < H - bs`` (the reference's strict
off-by-one), under FME also ``0 <= x+dx+2bs < W - bs`` (same for y,
Encoder.py:698), with x, y, W, H in grid units.  No valid candidate gives
mv = (0, 0, 0) and SAD = INT32_MAX.  ``valid_candidates`` counts those
candidates from the shapes alone (the tracer's ``search_positions``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

INT32_MAX = 2**31 - 1


def fme_parity_planes(refs: torch.Tensor, wrap_row_pass: bool) -> torch.Tensor:
    """The four parity planes of the half-pel grid of each reference.

    refs: (nref, h, w) uint8.  Returns (nref, 4, h, w) uint8 ordered
    [p00, p01, p10, p11] (row parity major): plane (py, px) equals
    ``fme_upsample(ref)[py::2, px::2]`` zero-padded to (h, w).  Half-pel
    values are ceil averages (``np.ceil`` in the reference), so every value
    is an integer in [0, 255].

    Quirk K17 (``wrap_row_pass``): the reference's row pass sums uint8 rows
    before dividing (Encoder.py:397), so horizontal sums wrap modulo 256 for
    real reconstructions; the column pass never wraps, nor does anything for
    the synthetic all-128 initial reference (pass False there).
    """
    f = refs.to(torch.int32)

    def row_sum(a, b):
        return (a + b) & 255 if wrap_row_pass else a + b

    p01 = F.pad((row_sum(f[..., :, :-1], f[..., :, 1:]) + 1) >> 1, (0, 1))
    p10 = F.pad((f[..., :-1, :] + f[..., 1:, :] + 1) >> 1, (0, 0, 0, 1))
    top = row_sum(f[..., :-1, :-1], f[..., :-1, 1:])
    bot = row_sum(f[..., 1:, :-1], f[..., 1:, 1:])
    p11 = F.pad((top + bot + 3) >> 2, (0, 1, 0, 1))
    return torch.stack([f, p01, p10, p11], dim=-3).to(torch.uint8)


def grid_of_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., 4, h, w) parity planes -> the (..., 2h-1, 2w-1) half-pel grid."""
    *lead, _, h, w = planes.shape
    n = len(lead)
    g = planes.reshape(*lead, 2, 2, h, w).permute(*range(n), n + 2, n, n + 3, n + 1)
    return g.reshape(*lead, 2 * h, 2 * w)[..., : 2 * h - 1, : 2 * w - 1]


def fme_upsample(frame: torch.Tensor, wrap_row_pass: bool) -> torch.Tensor:
    """Twin of ``me.fme_upsample`` (frac_me_reference_frame, Encoder.py:388-406):
    (h, w) uint8 -> (2h-1, 2w-1) int32; even/even is the original, the
    halves ceil of 2- and 4-neighbour averages."""
    return grid_of_planes(fme_parity_planes(frame[None], wrap_row_pass)[0]).to(torch.int32)


def sad_maps(cur: torch.Tensor, ref: torch.Tensor, sr: int, bs: int, stride: int = 1,
             row_offset: int = 0) -> torch.Tensor:
    """Block SADs for every displacement: (ndy, ndx, nbr, nbc) int32.

    cur: (h, w); ref: (H, W) reference grid (the half-pel grid when
    ``stride`` is 2).  Block (bi, bj) of size ``bs`` reads its window from
    grid position (stride*bi*bs + dy + row_offset, stride*bj*bs + dx) with
    row and column step ``stride``; ``row_offset`` places cur inside a taller
    band of the frame (a mesh tile's halo band).  Windows reaching outside
    the grid read zeros; those candidates are invalid and must be masked
    with ``candidate_valid_mask``.
    """
    h, w = cur.shape
    nbr, nbc = h // bs, w // bs
    nd = 2 * sr + 1
    dev = cur.device
    c32 = cur.to(torch.int32)
    below = max(sr, stride * (h - 1) + row_offset + sr + 1 - ref.shape[0])  # zero rows the last block reads
    rp = F.pad(ref.to(torch.int32), (sr, sr, sr, below))
    col_idx = stride * torch.arange(w, device=dev)[None, :] + torch.arange(nd, device=dev)[:, None]  # (nd, w)
    row_idx = stride * torch.arange(h, device=dev) + row_offset
    out = []
    for dyi in range(nd):
        rows = rp[row_idx + dyi]  # (h, Wp): grid rows stride*y + dy
        win = rows[:, col_idx]  # (h, nd, w): [y, dxi, x] = grid[stride*y + dy, stride*x + dx]
        diff = (win - c32[:, None, :]).abs()
        out.append(diff.reshape(nbr, bs, nd, nbc, bs).sum(dim=(1, 4)).transpose(0, 1))
    return torch.stack(out).to(torch.int32)


def axis_valid(origins: torch.Tensor, sr: int, bs: int, D: int, fme: bool = False) -> torch.Tensor:
    """Validity of each displacement along one axis of D grid units: (nd, n)
    bool for (n,) origins in grid units (doubled under FME)."""
    d = torch.arange(-sr, sr + 1, device=origins.device)
    p = origins[None, :] + d[:, None]
    ok = (p >= 0) & (p < D - bs)
    if fme:
        ok &= (p + 2 * bs >= 0) & (p + 2 * bs < D - bs)
    return ok


def candidate_valid_mask(bx: torch.Tensor, by: torch.Tensor, sr: int, bs: int, H: int, W: int,
                         fme: bool = False) -> torch.Tensor:
    """Validity of each displacement for each block: (ndy, ndx, nb) bool.

    bx, by: (nb,) block origins in grid units (doubled under FME)."""
    return axis_valid(by, sr, bs, H, fme)[:, None, :] & axis_valid(bx, sr, bs, W, fme)[None, :, :]


@functools.lru_cache(maxsize=None)
def valid_candidates(h: int, w: int, bs: int, sr: int, *, fme: bool, vbs: bool, row0: int = 0,
                     H: int | None = None) -> int:
    """The candidates a full search can pick, summed over the blocks of frame
    rows [row0, row0 + h) of an H-row frame (H = h by default): those valid
    for the block or, with VBS, for one of its quads.  The test is one of
    rows times one of columns and the quads are the block's halves on each
    axis, so this is a product of two per-axis sums: no (candidates x
    blocks) mask is built."""
    H = h if H is None else H
    f = 2 if fme else 1  # the half-pel grid doubles origins and range

    def axis(origins: torch.Tensor, D: int) -> int:
        subs = [(origins, bs)] + ([(origins, bs // 2), (origins + bs // 2, bs // 2)] if vbs else [])
        ok = torch.stack([axis_valid(f * o, f * sr, n, f * (D - 1) + 1, fme) for o, n in subs])
        return int(ok.any(dim=0).sum())

    return axis(torch.arange(row0, row0 + h, bs), H) * axis(torch.arange(0, w, bs), w)


def secondary_keys(nref: int, sr: int, device) -> torch.Tensor:
    """(nref, ndy, ndx) int32 packed (l1, ref, dx_index, dy_index) keys."""
    nd = 2 * sr + 1
    d = torch.arange(-sr, sr + 1, device=device, dtype=torch.int32)
    l1 = d.abs()[None, :, None] + d.abs()[None, None, :]
    refi = torch.arange(nref, device=device, dtype=torch.int32)[:, None, None]
    dxi = torch.arange(nd, device=device, dtype=torch.int32)[None, None, :]
    dyi = torch.arange(nd, device=device, dtype=torch.int32)[None, :, None]
    return ((l1 << 3 | refi) << 8 | dxi) << 8 | dyi


def argmin_displacement(sads: torch.Tensor, valid: torch.Tensor, sr: int):
    """Reference-exact winner over (nref, ndy, ndx) per block.

    sads, valid: (nref, ndy, ndx, nb).  Returns (mv (nb, 3) int32
    [dx, dy, ref], sad (nb,) int32, ok (nb,) bool).
    """
    nref, ndy, ndx, nb = sads.shape
    sec = secondary_keys(nref, sr, sads.device)
    flat = torch.where(valid, sads, INT32_MAX).reshape(-1, nb)
    best = flat.min(dim=0).values
    sec_b = sec.reshape(-1, 1).expand(-1, nb)
    sec_m = torch.where((flat == best[None]) & (flat != INT32_MAX), sec_b, INT32_MAX)
    win = sec_m.min(dim=0).values
    ok = win != INT32_MAX
    wdy = (win & 0xFF) - sr
    wdx = ((win >> 8) & 0xFF) - sr
    wref = (win >> 16) & 0x7
    mv = torch.stack([wdx, wdy, wref], dim=-1)
    mv = torch.where(ok[:, None], mv, 0).to(torch.int32)
    return mv, best.to(torch.int32), ok


def block_origins(h: int, w: int, bs: int, device):
    """(nb,) top-left x and y of every block in raster order (int64)."""
    nbr, nbc = h // bs, w // bs
    bx = (torch.arange(nbc, device=device) * bs).repeat(nbr)
    by = (torch.arange(nbr, device=device) * bs).repeat_interleave(nbc)
    return bx, by


def quad_origins(h: int, w: int, bs: int, device):
    """(nb, 4) top-left x and y of every block's quads in Z order (int64)."""
    bx, by = block_origins(h, w, bs, device)
    s = bs // 2
    offs = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]], device=device) * s
    return bx[:, None] + offs[None, :, 1], by[:, None] + offs[None, :, 0]


def _regroup_quads(a: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """(nbr2 * nbc2, ...) sub-block raster -> (nb, 4, ...) per-block quads."""
    tail = a.shape[1:]
    a = a.reshape((nbr, 2, nbc, 2) + tail).transpose(1, 2)
    return a.reshape((nbr * nbc, 4) + tail)


def full_search_materialized(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int, *, fme: bool = False,
                             vbs: bool = False, row_offset: int = 0, grid_dims: tuple | None = None,
                             valid_row_offset: int | None = None) -> dict:
    """Full search over the reference grids ``refs`` (nref, H, W).

    Whole-pel: ``refs`` are the frames and ``sr`` the search range.  FME:
    ``refs`` are the (2h-1, 2w-1) half-pel grids and ``sr`` the grid range
    (twice the search range); windows step 2 on the grid.  SADs are computed
    once per quad (bs/2) under VBS; a block's SAD is the sum of its quads'.

    Band form (``me.full_search_materialized``'s, for mesh tiles): ``refs``
    may be a band of the frame taller than ``cur``.  ``row_offset`` is cur
    row 0's row in ``refs`` and ``valid_row_offset`` its row in the whole
    grid (default ``row_offset``), both in grid units; ``grid_dims`` is the
    whole grid's (H, W) for validity (default the refs' own).

    Returns {"mv": (nb, 3) int32, "sad": (nb,) int32, "ok": (nb,) bool},
    plus {"sub_mv": (nb, 4, 3), "sub_sad": (nb, 4), "sub_ok": (nb, 4)} in
    Z order when ``vbs``.
    """
    h, w = cur.shape
    nref, H, W = refs.shape
    if grid_dims is not None:
        H, W = grid_dims
    y0 = row_offset if valid_row_offset is None else valid_row_offset
    nd = 2 * sr + 1
    stride = 2 if fme else 1
    nbr, nbc = h // bs, w // bs
    dev = cur.device
    if vbs:
        s = bs // 2
        sub = torch.stack([sad_maps(cur, refs[r], sr, s, stride, row_offset)
                           for r in range(nref)])  # (nref, nd, nd, 2nbr, 2nbc)
        full = sub.reshape(nref, nd, nd, nbr, 2, nbc, 2).sum(dim=(4, 6), dtype=torch.int32)
    else:
        full = torch.stack([sad_maps(cur, refs[r], sr, bs, stride, row_offset) for r in range(nref)])
    full = full.reshape(nref, nd, nd, -1)
    bx, by = block_origins(h, w, bs, dev)
    vm = candidate_valid_mask(stride * bx, stride * by + y0, sr, bs, H, W, fme)
    mv, sad, ok = argmin_displacement(full, vm[None].expand_as(full), sr)
    out = {"mv": mv, "sad": sad, "ok": ok}
    if vbs:
        sub = sub.reshape(nref, nd, nd, -1)
        qx, qy = block_origins(h, w, s, dev)
        vs = candidate_valid_mask(stride * qx, stride * qy + y0, sr, s, H, W, fme)
        smv, ssad, sok = argmin_displacement(sub, vs[None].expand_as(sub), sr)
        out["sub_mv"] = _regroup_quads(smv, nbr, nbc)
        out["sub_sad"] = _regroup_quads(ssad, nbr, nbc)
        out["sub_ok"] = _regroup_quads(sok, nbr, nbc)
    return out
