"""Wrappers of the two hand-written CUDA kernels of the main path.

``full_search``  -- whole-pel full search with the winner's pixels
                    (csrc/full_search.cu; replaces me_pallas._plane_search
                    via full_search_pallas).
``pred_fetch``   -- decode prediction fetch (csrc/pred_fetch.cu; replaces
                    me_pallas.pred_fetch_compact).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take.  A tensor on the CPU goes to the kernel's plain
PyTorch version (``full_search_plain`` / ``pred_fetch_plain``); a CUDA tensor
launches the kernel or raises — there is no fallback.  Each wrapper counts
its kernel launches in a plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from streamoptima_tpu_torch.core import me as M
from streamoptima_tpu_torch.core.blocks import unblockify
from streamoptima_tpu_torch.core.pred import gather_predictions

#: shared memory one block may use on Hopper (bytes)
_SMEM_LIMIT = 232448


def _check_plane(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8 pixels, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# ------------------------------------------------------------ full search
def full_search_plain(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int) -> dict:
    """Plain PyTorch version of the ``full_search`` kernel (any device)."""
    h, w = cur.shape
    out = M.full_search_materialized(cur, refs, sr, bs)
    bx, by = M.block_origins(h, w, bs, cur.device)
    g = gather_predictions(out["mv"], refs, bx, by, bs)
    g = torch.where(out["ok"][:, None, None], g, 0)  # no valid candidate: zeros
    out["pred"] = unblockify(g, h, w).to(torch.int16)
    return out


def full_search(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int) -> dict:
    """Whole-pel full search of ``cur`` (h, w) over ``refs`` (nref, h, w).

    Both uint8.  Returns {"mv": (nb, 3) int32 [dx, dy, ref], "sad": (nb,)
    int32, "ok": (nb,) bool, "pred": (h, w) int16} — the non-VBS contract of
    ``full_search_pallas``: ``pred`` holds each block's winning window, and
    zeros where ``ok`` is False (no valid candidate: mv = (0, 0, 0),
    sad = INT32_MAX).
    """
    _check_plane(cur, "cur", 2)
    _check_plane(refs, "refs", 3)
    h, w = cur.shape
    nref = refs.shape[0]
    if refs.shape[1:] != cur.shape:
        raise ValueError(f"refs {tuple(refs.shape)} do not match cur {tuple(cur.shape)}")
    if refs.device != cur.device:
        raise ValueError("cur and refs must be on one device")
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} is not a multiple of block size {bs}")
    if not 1 <= nref <= 8:
        raise ValueError("nref must be in [1, 8] (3-bit ref field of the tie-break key)")
    if not 1 <= sr <= 127:
        raise ValueError("sr must be in [1, 127] (8-bit displacement fields of the tie-break key)")
    if cur.device.type == "cpu":
        return full_search_plain(cur, refs, sr, bs)
    if cur.device.type != "cuda":
        raise ValueError(f"full_search runs on cpu or cuda tensors, not {cur.device}")
    if bs * bs * 4 + (bs + 2 * sr) ** 2 > _SMEM_LIMIT:
        raise ValueError(f"bs={bs}, sr={sr}: the search window exceeds a block's shared memory")
    from streamoptima_tpu_torch._build import library

    lib = library()
    nb = (h // bs) * (w // bs)
    dev = cur.device
    mv = torch.empty((nb, 3), dtype=torch.int32, device=dev)
    sad = torch.empty((nb,), dtype=torch.int32, device=dev)
    ok = torch.empty((nb,), dtype=torch.bool, device=dev)
    pred = torch.empty((h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.so_full_search(cur.data_ptr(), refs.data_ptr(), nref, h, w, sr, bs, mv.data_ptr(),
                                sad.data_ptr(), ok.data_ptr(), pred.data_ptr(), stream)
    _launch_check(rc, "full_search")
    full_search.launches += 1
    return {"mv": mv, "sad": sad, "ok": ok, "pred": pred}


full_search.launches = 0


# ------------------------------------------------------------- pred fetch
def pred_fetch_plain(mv: torch.Tensor, refs: torch.Tensor, bs: int) -> torch.Tensor:
    """Plain PyTorch version of the ``pred_fetch`` kernel (any device)."""
    h, w = refs.shape[-2:]
    bx, by = M.block_origins(h, w, bs, refs.device)
    return unblockify(gather_predictions(mv, refs, bx, by, bs), h, w).to(torch.int16)


def pred_fetch(mv: torch.Tensor, refs: torch.Tensor, bs: int) -> torch.Tensor:
    """Whole-pel prediction plane for transmitted MVs.

    mv: (nb, 3) int32 [dx, dy, ref] in block raster order; refs: (nref, h, w)
    uint8.  Returns (h, w) int16: each block's window at (by + dy, bx + dx)
    of ``refs[ref]``, zero outside the frame.  Reference indices must lie in
    [0, nref): the decoder checks the stream on the host before calling.
    """
    _check_plane(refs, "refs", 3)
    nref, h, w = refs.shape
    if mv.dtype != torch.int32 or mv.dim() != 2 or mv.shape[1] != 3 or not mv.is_contiguous():
        raise ValueError(f"mv must be a contiguous (nb, 3) int32 tensor, got {mv.dtype} {tuple(mv.shape)}")
    if h % bs or w % bs or mv.shape[0] != (h // bs) * (w // bs):
        raise ValueError(f"mv has {mv.shape[0]} blocks; a {h}x{w} frame at bs={bs} has "
                         f"{(h // bs) * (w // bs)}")
    if mv.device != refs.device:
        raise ValueError("mv and refs must be on one device")
    if refs.device.type == "cpu":
        return pred_fetch_plain(mv, refs, bs)
    if refs.device.type != "cuda":
        raise ValueError(f"pred_fetch runs on cpu or cuda tensors, not {refs.device}")
    from streamoptima_tpu_torch._build import library

    lib = library()
    pred = torch.empty((h, w), dtype=torch.int16, device=refs.device)
    with torch.cuda.device(refs.device):
        stream = torch.cuda.current_stream(refs.device).cuda_stream
        rc = lib.so_pred_fetch(mv.data_ptr(), refs.data_ptr(), nref, h, w, bs, pred.data_ptr(), stream)
    _launch_check(rc, "pred_fetch")
    pred_fetch.launches += 1
    return pred


pred_fetch.launches = 0
