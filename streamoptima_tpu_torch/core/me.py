"""Whole-pel full-search motion estimation: SAD maps + exact tie-break argmin.

Twin of ``streamoptima_tpu.core.me`` (``sad_maps``, ``candidate_valid_mask``,
``argmin_displacement``, ``full_search_materialized``) for whole-pel search
without VBS.  Together these are the plain PyTorch version of the
``full_search`` CUDA kernel (core/kernels.py).

Reference semantics (Encoder.py:678-717): candidates (dx, dy) in [-sr, sr]^2
over every reference frame; the winner is the lexicographic minimum of
(SAD, |dx|+|dy|, ref, dx_index, dy_index), packed as the int32 secondary key
``((l1 << 3 | ref) << 8 | dxi) << 8 | dyi``.  A candidate is valid when
``0 <= x+dx < W - bs`` and ``0 <= y+dy < H - bs`` (the reference's strict
off-by-one).  No valid candidate gives mv = (0, 0, 0) and SAD = INT32_MAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

INT32_MAX = 2**31 - 1


def sad_maps(cur: torch.Tensor, ref: torch.Tensor, sr: int, bs: int) -> torch.Tensor:
    """Block SADs for every displacement: (ndy, ndx, nbr, nbc) int32.

    Windows reaching outside the frame read zeros; those candidates are
    invalid and must be masked with ``candidate_valid_mask``.
    """
    h, w = cur.shape
    nbr, nbc = h // bs, w // bs
    nd = 2 * sr + 1
    dev = cur.device
    c32 = cur.to(torch.int32)
    pad = sr
    rp = F.pad(ref.to(torch.int32), (pad, pad, pad, pad))
    col_idx = torch.arange(w, device=dev)[None, :] + torch.arange(nd, device=dev)[:, None]  # (nd, w)
    out = []
    for dyi in range(nd):
        rows = rp[dyi : dyi + h]  # (h, Wp): rows y + dy
        win = rows[:, col_idx]  # (h, nd, w): [y, dxi, x] = ref[y + dy, x + dx]
        diff = (win - c32[:, None, :]).abs()
        out.append(diff.reshape(nbr, bs, nd, nbc, bs).sum(dim=(1, 4)).transpose(0, 1))
    return torch.stack(out).to(torch.int32)


def candidate_valid_mask(bx: torch.Tensor, by: torch.Tensor, sr: int, bs: int, H: int, W: int) -> torch.Tensor:
    """Validity of each displacement for each block: (ndy, ndx, nb) bool."""
    d = torch.arange(-sr, sr + 1, device=bx.device)
    px = bx[None, :] + d[:, None]
    py = by[None, :] + d[:, None]
    okx = (px >= 0) & (px < W - bs)
    oky = (py >= 0) & (py < H - bs)
    return oky[:, None, :] & okx[None, :, :]


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


def full_search_materialized(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int):
    """Whole-pel full search over ``refs`` (nref, H, W).

    Returns {"mv": (nb, 3) int32, "sad": (nb,) int32, "ok": (nb,) bool}.
    """
    h, w = cur.shape
    nref, H, W = refs.shape
    nd = 2 * sr + 1
    full = torch.stack([sad_maps(cur, refs[r], sr, bs) for r in range(nref)]).reshape(nref, nd, nd, -1)
    bx, by = block_origins(h, w, bs, cur.device)
    vm = candidate_valid_mask(bx, by, sr, bs, H, W)
    mv, sad, ok = argmin_displacement(full, vm[None].expand_as(full), sr)
    return {"mv": mv, "sad": sad, "ok": ok}
