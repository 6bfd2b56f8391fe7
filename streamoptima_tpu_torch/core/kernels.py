"""Wrappers of the hand-written CUDA kernels.

``full_search``          -- whole-pel full search with the winner's pixels
                            (csrc/full_search.cu; replaces me_pallas
                            _plane_search via full_search_pallas).
``full_search_vbs``      -- the same search with the VBS quads, MVs only
                            (the VBS kernel of csrc/full_search.cu;
                            full_search_pallas with vbs=True).
``full_search_fme``      -- half-pel full search, MVs only
                            (csrc/full_search_fme.cu; replaces _plane_search
                            via full_search_pallas_fme, vbs=False).
``full_search_fme_vbs``  -- the same with the VBS quads (vbs=True).
``pred_fetch``           -- whole-pel prediction fetch (csrc/pred_fetch.cu;
                            replaces me_pallas.pred_fetch_compact).
``pred_fetch_vbs``       -- the same with the quad plane.
``pred_fetch_fme``       -- the same kernel in its FME mode, cases A, B and C.
``pred_fetch_fme_vbs``   -- the FME mode with the quad plane.
``window_fetch``         -- the fast-ME region gather at any origin
                            (csrc/window_fetch.cu; replaces
                            me_pallas.window_fetch with window_prep).
``rowscan_pass``         -- one sweep pass of the fast-ME MVP chain, whole-pel
                            or FME (csrc/rowscan_pass.cu; replaces
                            me_pallas.rowscan_pass with pass_prep).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take.  A tensor on the CPU goes to the kernel's plain
PyTorch version (``<wrapper>_plain``); a CUDA tensor launches the kernel or
raises — there is no fallback.  Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from streamoptima_tpu_torch.core import me as M
from streamoptima_tpu_torch.core.fastme import rowscan_pass_plain, window_fetch_plain
from streamoptima_tpu_torch.core.blocks import unblockify, unquads_px
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


def _check_mv(mv: torch.Tensor, name: str, shape: tuple, device) -> None:
    if mv.dtype != torch.int32 or tuple(mv.shape) != shape or not mv.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} int32 tensor, got {mv.dtype} {tuple(mv.shape)}")
    if mv.device != device:
        raise ValueError(f"{name} and the reference planes must be on one device")


def _check_search(cur: torch.Tensor, refs: torch.Tensor, nref: int, grid_sr: int, bs: int) -> None:
    h, w = cur.shape
    if refs.device != cur.device:
        raise ValueError("cur and refs must be on one device")
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} is not a multiple of block size {bs}")
    if not 1 <= nref <= 8:
        raise ValueError("nref must be in [1, 8] (3-bit ref field of the tie-break key)")
    if not 1 <= grid_sr <= 127:
        raise ValueError("sr must put the grid range in [1, 127] (8-bit displacement fields of the tie-break key)")
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the search runs on cpu or cuda tensors, not {cur.device}")


def _launch_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    _check_search(cur, refs, nref, sr, bs)
    if cur.device.type == "cpu":
        return full_search_plain(cur, refs, sr, bs)
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
        rc = lib.so_full_search(cur.data_ptr(), refs.data_ptr(), nref, h, w, sr, bs, mv.data_ptr(),
                                sad.data_ptr(), ok.data_ptr(), pred.data_ptr(), _stream(dev))
    _launch_check(rc, "full_search")
    full_search.launches += 1
    return {"mv": mv, "sad": sad, "ok": ok, "pred": pred}


full_search.launches = 0


# ------------------------------------------ the MVs-only full searches
_BLOCK_KEYS = ("mv", "sad", "ok")
_QUAD_KEYS = ("sub_mv", "sub_sad", "sub_ok")


def _launch_search(entry: str, cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int, vbs: bool,
                   smem: int) -> dict:
    """Allocate the outputs and launch one MVs-only search kernel, which
    stages ``smem`` bytes of shared memory per macroblock."""
    if smem > _SMEM_LIMIT:
        raise ValueError(f"bs={bs}, sr={sr}: the search windows exceed a block's shared memory")
    from streamoptima_tpu_torch._build import library

    h, w = cur.shape
    nb, dev = (h // bs) * (w // bs), cur.device
    shapes = {"mv": (nb, 3), "sad": (nb,), "ok": (nb,), "sub_mv": (nb, 4, 3), "sub_sad": (nb, 4), "sub_ok": (nb, 4)}
    keys = _BLOCK_KEYS + (_QUAD_KEYS if vbs else ())
    out = {k: torch.empty(shapes[k], dtype=torch.bool if k.endswith("ok") else torch.int32, device=dev) for k in keys}
    with torch.cuda.device(dev):
        rc = getattr(library(), f"so_{entry}")(cur.data_ptr(), refs.data_ptr(), refs.shape[0], h, w, sr, bs,
                                               *(out[k].data_ptr() for k in keys), _stream(dev))
    _launch_check(rc, entry)
    return out


def full_search_vbs_plain(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int) -> dict:
    """Plain PyTorch version of the ``full_search_vbs`` kernel (any device)."""
    return M.full_search_materialized(cur, refs, sr, bs, vbs=True)


def full_search_vbs(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int) -> dict:
    """Whole-pel full search of ``cur`` (h, w) over ``refs`` (nref, h, w),
    both uint8, with the VBS quads.

    Returns {"mv", "sad", "ok"} per block ((nb, 3) int32, (nb,) int32,
    (nb,) bool) and {"sub_mv", "sub_sad", "sub_ok"} per quad ((nb, 4, 3),
    (nb, 4), (nb, 4)) in Z order — the ``full_search_pallas(vbs=True,
    want_pred=False)`` contract.  Each quad has its own validity (its own
    origin and size in the strict bounds).  No valid candidate: mv =
    (0, 0, 0), sad = INT32_MAX, ok False.
    """
    _check_plane(cur, "cur", 2)
    _check_plane(refs, "refs", 3)
    if refs.shape[1:] != cur.shape:
        raise ValueError(f"refs {tuple(refs.shape)} do not match cur {tuple(cur.shape)}")
    if bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    _check_search(cur, refs, refs.shape[0], sr, bs)
    if cur.device.type == "cpu":
        return full_search_vbs_plain(cur, refs, sr, bs)
    out = _launch_search("full_search_vbs", cur, refs, sr, bs, True, bs * bs + (bs + 2 * sr) ** 2)
    full_search_vbs.launches += 1
    return out


full_search_vbs.launches = 0


def full_search_fme_plain(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int) -> dict:
    """Plain PyTorch version of the ``full_search_fme`` kernel (any device):
    the stride-2 materialized search on the half-pel grid that the parity
    planes interleave into."""
    return M.full_search_materialized(cur, M.grid_of_planes(planes), 2 * sr, bs, fme=True)


def full_search_fme_vbs_plain(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int) -> dict:
    """Plain PyTorch version of the ``full_search_fme_vbs`` kernel (any device)."""
    return M.full_search_materialized(cur, M.grid_of_planes(planes), 2 * sr, bs, fme=True, vbs=True)


def _check_fme_search(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int, vbs: bool) -> None:
    _check_plane(cur, "cur", 2)
    _check_plane(planes, "planes", 4)
    h, w = cur.shape
    if planes.shape[1:] != (4, h, w):
        raise ValueError(f"planes {tuple(planes.shape)} are not (nref, 4, {h}, {w})")
    if vbs and bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    _check_search(cur, planes, planes.shape[0], 2 * sr, bs)


def _fme_smem(sr: int, bs: int) -> int:
    return bs * bs + 4 * ((bs + 2 * sr) ** 2 + 4)  # the block and the four plane windows


def full_search_fme(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int) -> dict:
    """Half-pel full search of ``cur`` (h, w) uint8, block winners only.

    planes: (nref, 4, h, w) uint8, the parity planes of each reference
    (``me.fme_parity_planes``).  Candidates span +-2sr on the half-pel grid.
    Returns {"mv", "sad", "ok"} ((nb, 3) int32, (nb,) int32, (nb,) bool) —
    the ``full_search_pallas_fme(vbs=False, want_pred=False)`` contract.  No
    valid candidate: mv = (0, 0, 0), sad = INT32_MAX, ok False.
    """
    _check_fme_search(cur, planes, sr, bs, False)
    if cur.device.type == "cpu":
        return full_search_fme_plain(cur, planes, sr, bs)
    out = _launch_search("full_search_fme", cur, planes, sr, bs, False, _fme_smem(sr, bs))
    full_search_fme.launches += 1
    return out


full_search_fme.launches = 0


def full_search_fme_vbs(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int) -> dict:
    """``full_search_fme`` with the VBS quads: also {"sub_mv", "sub_sad",
    "sub_ok"} per quad ((nb, 4, 3), (nb, 4), (nb, 4)) in Z order, each quad
    with its own validity — the ``full_search_pallas_fme(vbs=True,
    want_pred=False)`` contract.
    """
    _check_fme_search(cur, planes, sr, bs, True)
    if cur.device.type == "cpu":
        return full_search_fme_vbs_plain(cur, planes, sr, bs)
    out = _launch_search("full_search_fme_vbs", cur, planes, sr, bs, True, _fme_smem(sr, bs))
    full_search_fme_vbs.launches += 1
    return out


full_search_fme_vbs.launches = 0


# ------------------------------------------------------------- pred fetch
def pred_fetch_plain(mv: torch.Tensor, refs: torch.Tensor, bs: int) -> torch.Tensor:
    """Plain PyTorch version of the ``pred_fetch`` kernel (any device)."""
    h, w = refs.shape[-2:]
    bx, by = M.block_origins(h, w, bs, refs.device)
    return unblockify(gather_predictions(mv, refs, bx, by, bs), h, w).to(torch.int16)


def _check_fetch(mv: torch.Tensor, refs: torch.Tensor, h: int, w: int, bs: int) -> int:
    if h % bs or w % bs or mv.shape[0] != (h // bs) * (w // bs):
        raise ValueError(f"mv has {mv.shape[0]} blocks; a {h}x{w} frame at bs={bs} has "
                         f"{(h // bs) * (w // bs)}")
    _check_mv(mv, "mv", (mv.shape[0], 3), refs.device)
    if refs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pred_fetch runs on cpu or cuda tensors, not {refs.device}")
    return mv.shape[0]


def _launch_fetch(what: str, mv: torch.Tensor, sub_mv, planes: torch.Tensor, nref: int, bs: int, fme: bool):
    """Allocate the prediction plane(s) and launch the ``pred_fetch`` kernel;
    the quad plane is fetched when ``sub_mv`` is given."""
    from streamoptima_tpu_torch._build import library

    h, w = planes.shape[-2:]
    dev = planes.device
    pred = torch.empty((h, w), dtype=torch.int16, device=dev)
    pred_q = None if sub_mv is None else torch.empty((h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        rc = library().so_pred_fetch(mv.data_ptr(), None if sub_mv is None else sub_mv.data_ptr(),
                                     planes.data_ptr(), nref, h, w, bs, int(fme), pred.data_ptr(),
                                     None if pred_q is None else pred_q.data_ptr(), _stream(dev))
    _launch_check(rc, what)
    return pred if pred_q is None else (pred, pred_q)


def pred_fetch(mv: torch.Tensor, refs: torch.Tensor, bs: int) -> torch.Tensor:
    """Whole-pel prediction plane for given MVs.

    mv: (nb, 3) int32 [dx, dy, ref] in block raster order; refs: (nref, h, w)
    uint8.  Returns (h, w) int16: each block's window at (by + dy, bx + dx)
    of ``refs[ref]``, zero outside the frame.  Reference indices must lie in
    [0, nref): the decoder checks the stream on the host before calling.
    """
    _check_plane(refs, "refs", 3)
    nref, h, w = refs.shape
    _check_fetch(mv, refs, h, w, bs)
    if refs.device.type == "cpu":
        return pred_fetch_plain(mv, refs, bs)
    pred = _launch_fetch("pred_fetch", mv, None, refs, nref, bs, False)
    pred_fetch.launches += 1
    return pred


pred_fetch.launches = 0


def _quad_plane(sub_mv: torch.Tensor, grid: torch.Tensor, h: int, w: int, bs: int, fme: bool) -> torch.Tensor:
    """Each quad's prediction at its own position: (h, w) int16."""
    s = bs // 2
    qx, qy = M.quad_origins(h, w, bs, grid.device)
    quads = gather_predictions(sub_mv.reshape(-1, 3), grid, qx.reshape(-1), qy.reshape(-1), s, fme=fme)
    return unquads_px(quads.reshape(-1, 4, s, s), h, w).to(torch.int16)


def pred_fetch_vbs_plain(mv: torch.Tensor, sub_mv: torch.Tensor, refs: torch.Tensor,
                         bs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``pred_fetch`` kernel's whole-pel mode
    with the quad plane (any device)."""
    h, w = refs.shape[-2:]
    return pred_fetch_plain(mv, refs, bs), _quad_plane(sub_mv, refs, h, w, bs, False)


def pred_fetch_vbs(mv: torch.Tensor, sub_mv: torch.Tensor, refs: torch.Tensor,
                   bs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-pel prediction planes for given block and quad MVs.

    mv: (nb, 3), sub_mv: (nb, 4, 3) int32 [dx, dy, ref] (quads in Z order);
    refs: (nref, h, w) uint8.  Returns (pred_full, pred_quads), both (h, w)
    int16 with each (sub)block's window at its own position, zero outside the
    frame.  Reference indices must lie in [0, nref).
    """
    _check_plane(refs, "refs", 3)
    nref, h, w = refs.shape
    if bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    nb = _check_fetch(mv, refs, h, w, bs)
    _check_mv(sub_mv, "sub_mv", (nb, 4, 3), refs.device)
    if refs.device.type == "cpu":
        return pred_fetch_vbs_plain(mv, sub_mv, refs, bs)
    out = _launch_fetch("pred_fetch_vbs", mv, sub_mv, refs, nref, bs, False)
    pred_fetch_vbs.launches += 1
    return out


pred_fetch_vbs.launches = 0


def pred_fetch_fme_plain(mv: torch.Tensor, planes: torch.Tensor, bs: int) -> torch.Tensor:
    """Plain PyTorch version of the ``pred_fetch`` kernel's FME mode (any
    device): ``pred.gather_predictions`` on the half-pel grid."""
    h, w = planes.shape[-2:]
    bx, by = M.block_origins(h, w, bs, planes.device)
    return unblockify(gather_predictions(mv, M.grid_of_planes(planes), bx, by, bs, fme=True), h, w).to(torch.int16)


def pred_fetch_fme_vbs_plain(mv: torch.Tensor, sub_mv: torch.Tensor, planes: torch.Tensor,
                             bs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``pred_fetch`` kernel's FME mode with
    the quad plane (any device)."""
    h, w = planes.shape[-2:]
    return pred_fetch_fme_plain(mv, planes, bs), _quad_plane(sub_mv, M.grid_of_planes(planes), h, w, bs, True)


def _check_planes4(planes: torch.Tensor) -> tuple[int, int, int]:
    _check_plane(planes, "planes", 4)
    nref, four, h, w = planes.shape
    if four != 4:
        raise ValueError(f"planes {tuple(planes.shape)} are not (nref, 4, h, w)")
    return nref, h, w


def pred_fetch_fme(mv: torch.Tensor, planes: torch.Tensor, bs: int) -> torch.Tensor:
    """Half-pel prediction plane for given block MVs.

    mv: (nb, 3) int32 [dx, dy, ref] on the half-pel grid; planes: (nref, 4,
    h, w) uint8 parity planes.  Returns (h, w) int16 with each block's
    prediction at its own position: case A (the stride-2 grid window), B
    (128) or C (the stride-1 grid window, zero off the grid).  Reference
    indices must lie in [0, nref).
    """
    nref, h, w = _check_planes4(planes)
    _check_fetch(mv, planes, h, w, bs)
    if planes.device.type == "cpu":
        return pred_fetch_fme_plain(mv, planes, bs)
    pred = _launch_fetch("pred_fetch_fme", mv, None, planes, nref, bs, True)
    pred_fetch_fme.launches += 1
    return pred


pred_fetch_fme.launches = 0


def pred_fetch_fme_vbs(mv: torch.Tensor, sub_mv: torch.Tensor, planes: torch.Tensor,
                       bs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-pel prediction planes for given block and quad MVs.

    mv: (nb, 3), sub_mv: (nb, 4, 3) int32 [dx, dy, ref] on the half-pel grid
    (quads in Z order); planes: (nref, 4, h, w) uint8 parity planes.
    Returns (pred_full, pred_quads), both (h, w) int16 with each (sub)block's
    prediction at its own position: case A, B or C as in ``pred_fetch_fme``,
    per block and per quad.  Reference indices must lie in [0, nref).
    """
    nref, h, w = _check_planes4(planes)
    if bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    nb = _check_fetch(mv, planes, h, w, bs)
    _check_mv(sub_mv, "sub_mv", (nb, 4, 3), planes.device)
    if planes.device.type == "cpu":
        return pred_fetch_fme_vbs_plain(mv, sub_mv, planes, bs)
    out = _launch_fetch("pred_fetch_fme_vbs", mv, sub_mv, planes, nref, bs, True)
    pred_fetch_fme_vbs.launches += 1
    return out


pred_fetch_fme_vbs.launches = 0


# ------------------------------------------------------------ window fetch
def window_fetch(planes: torch.Tensor, by0: torch.Tensor, bx0: torch.Tensor, nwin: int,
                 nwin_c: int | None = None) -> torch.Tensor:
    """``out[b, p, i, j] = planes[p, by0[b] + i, bx0[b] + j]``, zero outside
    the plane (a window partly outside is partly zero).

    planes: (P, H, W) uint8; by0, bx0: (nb,) int32 origins of any value.
    Returns (nb, P, nwin, nwin_c) uint8 (``nwin_c`` defaults to ``nwin``):
    plane values are pixels or ceil-averages of pixels, so uint8 holds them;
    the TPU kernel it replaces returns int32.  The plain version is
    ``window_fetch_plain``.
    """
    _check_plane(planes, "planes", 3)
    nc = nwin if nwin_c is None else nwin_c
    if nwin < 1 or nc < 1:
        raise ValueError(f"window extents must be positive, got {nwin} x {nc}")
    nb = by0.shape[0]
    _check_mv(by0, "by0", (nb,), planes.device)
    _check_mv(bx0, "bx0", (nb,), planes.device)
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_fetch runs on cpu or cuda tensors, not {planes.device}")
    if planes.device.type == "cpu":
        return window_fetch_plain(planes, by0, bx0, nwin, nc)
    from streamoptima_tpu_torch._build import library

    lib = library()
    P, H, W = planes.shape
    out = torch.empty((nb, P, nwin, nc), dtype=torch.uint8, device=planes.device)
    with torch.cuda.device(planes.device):
        rc = lib.so_window_fetch(planes.data_ptr(), by0.data_ptr(), bx0.data_ptr(), nb, P, H, W, nwin, nc,
                                 out.data_ptr(), _stream(planes.device))
    _launch_check(rc, "window_fetch")
    window_fetch.launches += 1
    return out


window_fetch.launches = 0


# ------------------------------------------------------------ rowscan pass
def rowscan_pass(cur: torch.Tensor, planes: torch.Tensor, seeds: torch.Tensor, bs: int, fme: bool) -> torch.Tensor:
    """One sweep pass of the fast-ME MVP chain over every block row.

    cur: (h, w) uint8; planes: (nref, 4, h, w) uint8 parity planes
    (``me.fme_parity_planes``) under ``fme``, else the (nref, h, w) uint8
    references; seeds: (S, 3) int32 [gx, gy, gref], the guessed MVP of each
    block row's first block (S = h / bs).  Returns (S, L, 3) int32, L = w / bs:
    ``mv[s, j]`` is the 3x3 fast-ME winner of block (s, j) around
    ``mv[s, j - 1]`` (``seeds[s]`` for j = 0), on the half-pel grid under
    ``fme``.  Rows are independent within a pass; the caller iterates the
    seeds.  The TPU kernel it replaces also returns its fetched windows for
    the confirm pass; here that pass reads through ``window_fetch``.  The
    plain version is ``rowscan_pass_plain``.
    """
    _check_plane(cur, "cur", 2)
    _check_plane(planes, "planes", 4 if fme else 3)
    h, w = cur.shape
    nref = planes.shape[0]
    want = (nref, 4, h, w) if fme else (nref, h, w)
    if tuple(planes.shape) != want:
        raise ValueError(f"planes {tuple(planes.shape)} are not {want}")
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} is not a multiple of block size {bs}")
    if nref < 1:
        raise ValueError("rowscan_pass needs at least one reference")
    _check_mv(seeds, "seeds", (h // bs, 3), cur.device)
    if planes.device != cur.device:
        raise ValueError("cur and planes must be on one device")
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rowscan_pass runs on cpu or cuda tensors, not {cur.device}")
    if cur.device.type == "cpu":
        return rowscan_pass_plain(cur, planes, seeds, bs, fme)
    # shared memory without opt-in: the sums, the block, the plane regions
    if (9 * nref + 4) * 4 + bs * bs + nref * (4 if fme else 1) * (bs + 2) ** 2 > 48 * 1024:
        raise ValueError(f"bs={bs}, nref={nref}: the candidate regions exceed 48 KB of shared memory")
    from streamoptima_tpu_torch._build import library

    lib = library()
    mvs = torch.empty((h // bs, w // bs, 3), dtype=torch.int32, device=cur.device)
    with torch.cuda.device(cur.device):
        rc = lib.so_rowscan_pass(cur.data_ptr(), planes.data_ptr(), seeds.data_ptr(), nref, h, w, bs, int(fme),
                                 mvs.data_ptr(), _stream(cur.device))
    _launch_check(rc, "rowscan_pass")
    rowscan_pass.launches += 1
    return mvs


rowscan_pass.launches = 0
