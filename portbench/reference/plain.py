"""The plain versions of the codec's kernels, as one device runs them on whole frames.

A frozen copy of the port's ``<kernel>_plain`` functions (``core/kernels.py``),
which the port's CPU tests hold bit-exact to the JAX package and the card's
smoke holds bit-exact to the CUDA kernels, without the band arguments of a
mesh tile (every call here reads whole frames).  ``control=True`` puts the
float32 transforms of ``transform.py`` in place of the exact fixed-point
ones: the benchmark's lower-precision control.
"""
from __future__ import annotations

import torch

from . import intra as I
from . import me as M
from . import rd
from .blocks import blockify, merge_quads, quads_px, unblockify, unquads_px
from .pred import gather_predictions, wrap_uint8
from .quant import qp_minus_1, rescale
from .transform import dct2_float32, dct2_int, idct2_float32, idct2_int


def full_search(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int) -> dict:
    """Whole-pel full search without VBS, with the winners' pixels ("pred",
    (h, w) int16; zeros where no candidate is valid)."""
    h, w = cur.shape
    dims = tuple(refs.shape[-2:])
    out = M.full_search_materialized(cur, refs, sr, bs, grid_dims=dims, valid_row_offset=0)
    bx, by = M.block_origins(h, w, bs, cur.device)
    g = gather_predictions(out["mv"], refs, bx, by, bs, grid_dims=dims)
    g = torch.where(out["ok"][:, None, None], g, 0)
    out["pred"] = unblockify(g, h, w).to(torch.int16)
    return out


def full_search_vbs(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int) -> dict:
    return M.full_search_materialized(cur, refs, sr, bs, vbs=True, grid_dims=tuple(refs.shape[-2:]),
                                      valid_row_offset=0)


def _fme_search(cur, planes, sr, bs, vbs) -> dict:
    H, W = planes.shape[-2:]
    return M.full_search_materialized(cur, M.grid_of_planes(planes), 2 * sr, bs, fme=True, vbs=vbs,
                                      grid_dims=(2 * H - 1, 2 * W - 1), valid_row_offset=0)


def full_search_fme(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int) -> dict:
    return _fme_search(cur, planes, sr, bs, False)


def full_search_fme_vbs(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int) -> dict:
    return _fme_search(cur, planes, sr, bs, True)


def pred_fetch(mv: torch.Tensor, refs: torch.Tensor, bs: int) -> torch.Tensor:
    h, w = refs.shape[-2:]
    bx, by = M.block_origins(h, w, bs, refs.device)
    return unblockify(gather_predictions(mv, refs, bx, by, bs, grid_dims=(h, w)), h, w).to(torch.int16)


def _quad_plane(sub_mv: torch.Tensor, grid: torch.Tensor, h: int, w: int, bs: int, fme: bool,
                grid_dims: tuple) -> torch.Tensor:
    s = bs // 2
    qx, qy = M.quad_origins(h, w, bs, grid.device)
    quads = gather_predictions(sub_mv.reshape(-1, 3), grid, qx.reshape(-1), qy.reshape(-1), s, fme=fme,
                               grid_dims=grid_dims)
    return unquads_px(quads.reshape(-1, 4, s, s), h, w).to(torch.int16)


def pred_fetch_vbs(mv: torch.Tensor, sub_mv: torch.Tensor, refs: torch.Tensor, bs: int):
    h, w = refs.shape[-2:]
    return pred_fetch(mv, refs, bs), _quad_plane(sub_mv, refs, h, w, bs, False, (h, w))


def pred_fetch_fme(mv: torch.Tensor, planes: torch.Tensor, bs: int) -> torch.Tensor:
    h, w = planes.shape[-2:]
    bx, by = M.block_origins(h, w, bs, planes.device)
    return unblockify(gather_predictions(mv, M.grid_of_planes(planes), bx, by, bs, fme=True,
                                         grid_dims=(2 * h - 1, 2 * w - 1)), h, w).to(torch.int16)


def pred_fetch_fme_vbs(mv: torch.Tensor, sub_mv: torch.Tensor, planes: torch.Tensor, bs: int):
    h, w = planes.shape[-2:]
    return (pred_fetch_fme(mv, planes, bs),
            _quad_plane(sub_mv, M.grid_of_planes(planes), h, w, bs, True, (2 * h - 1, 2 * w - 1)))


def intra_search(cur: torch.Tensor, bs: int, sr: int, canvas_w: int, vbs: bool):
    """Intra mode 0's search and residuals of a frame."""
    work = cur.to(torch.int32)
    s = I.intra_search_mode0(work, bs, sr, canvas_w, vbs)
    rf, rq = I.intra_residuals_mode0(work, s["mv"], bs, sr, s["sub_mv"] if vbs else None)
    return s, rf.contiguous(), None if rq is None else rq.contiguous()


def intra_recon(residual_full, mv, h: int, w: int, bs: int, sr: int, residual_quads=None, split=None,
                sub_mv=None) -> torch.Tensor:
    return wrap_uint8(I.intra_reconstruct_mode0(residual_full, mv, h, w, bs, sr, residual_quads=residual_quads,
                                                split=split, sub_mv=sub_mv))


def transform_select(res_full, res_quads, sad_full, sad_quads, frame_type: int, qps_blocks, *, qp_nominal: int,
                     lam, vbs_enable: bool, vbs_eligible, bs: int, sbs: int, ok_full=None, ok_quads=None,
                     control: bool = False):
    return rd.transform_and_select(res_full, res_quads, sad_full, sad_quads, frame_type, qps_blocks,
                                   qp_nominal=qp_nominal, lam=lam, vbs_enable=vbs_enable, vbs_eligible=vbs_eligible,
                                   bs=bs, sbs=sbs, ok_full=ok_full, ok_quads=ok_quads,
                                   dct2=dct2_float32 if control else dct2_int)


def residual_recon(qtc_full, qtc_quads, qps, pred=None, pred_quads=None, split=None, ok=None, sub_ok=None,
                   control: bool = False):
    idct2 = idct2_float32 if control else idct2_int
    rf = idct2(rescale(qtc_full.to(torch.int32), qps))
    rq = None if qtc_quads is None else idct2(rescale(qtc_quads.to(torch.int32), qp_minus_1(qps)[:, None]))
    if pred is None:
        return rf, rq
    h, w = pred.shape
    bs = qtc_full.shape[-1]
    pf = blockify(pred, bs).to(torch.int32)
    if ok is not None:
        pf = torch.where(ok[:, None, None], pf, 128)
    blocks = wrap_uint8(pf + rf)
    if rq is not None:
        pq = quads_px(pred_quads, bs).to(torch.int32)
        if sub_ok is not None:
            pq = torch.where(sub_ok[:, :, None, None], pq, 128)
        blocks = torch.where(split[:, None, None], merge_quads(wrap_uint8(pq + rq)), blocks)
    return unblockify(blocks, h, w)
