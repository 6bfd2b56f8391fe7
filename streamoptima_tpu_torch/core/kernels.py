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
``pred_fetch_fme_vbs``   -- the FME mode with the quad plane (the quads'
                            FME margin: their own size, or the parent
                            block's for the compat engine's quirk K18).
``window_fetch``         -- the fast-ME region gather at any origin
                            (csrc/window_fetch.cu; replaces
                            me_pallas.window_fetch with window_prep).
``rowscan_pass``         -- one sweep pass of the fast-ME MVP chain, whole-pel
                            or FME, of the frame or a mesh tile's rows
                            (csrc/rowscan_pass.cu; replaces
                            me_pallas.rowscan_pass with pass_prep).
``fast_confirm``         -- the fast-ME confirm: every block's 3x3 search
                            around its MVP, and its quads', from
                            ``window_fetch``'s regions (csrc/fast_confirm.cu;
                            no TPU kernel: the JAX engine's jitted
                            core/fastme.py confirm).
``dct_scipy``            -- the compat engine's scipy-exact 2D DCT-II or its
                            inverse (csrc/dct_scipy.cu; no TPU kernel: the
                            JAX compat engine calls scipy on the host).
``intra_recon``          -- mode-0 intra reconstruction of a frame, or of its
                            transpose for intra mode 1 (csrc/intra_recon.cu;
                            no TPU kernel: the JAX engine runs one lax.scan
                            over block columns, core/intra.py:343).
``transform_select``     -- a frame step's DCT, RD split, quantization and
                            coded lengths (csrc/transform_select.cu; no TPU
                            kernel: XLA fuses rd.transform_and_select into
                            the jitted step).
``residual_recon``       -- rescale and IDCT of a frame's coefficients, and
                            for an inter frame the prediction added and
                            wrapped to uint8 (csrc/residual_recon.cu; no TPU
                            kernel: the JAX engine's _dequant / _recon_inter
                            in the jit).
``intra_search``         -- mode-0 intra search and residuals of a frame, or
                            of its transpose (csrc/intra_search.cu; no TPU
                            kernel: intra_search_mode0 and
                            intra_residuals_mode0 in the jit).
``rle_pack``             -- the binary container's run-length coding of a
                            segment's chosen coefficients, with its split
                            flags and MVs, into one buffer (csrc/rle_pack.cu;
                            no TPU kernel: the JAX package codes them on the
                            host, native/entropy.cpp rle_encode_blocks).
``rle_unpack``           -- the binary container's run-length decoding of a
                            stream's coefficient lists, as they lie in the
                            file, into the decoders' merged payload
                            (csrc/rle_unpack.cu; no TPU kernel: the JAX
                            package decodes them on the host,
                            native/entropy.cpp rle_decode_blocks).

The searches and fetches also take a band of the frame in place of the
whole frame (a mesh tile's, ``parallel/mesh.py``; me_pallas's ``read_row0``,
``g_px0`` and ``grid_dims``): ``cur`` (or the MVs' blocks) are frame rows
[g_row0, g_row0 + h), held at rows [band_row0, band_row0 + h) of the
(bandh, w) reference band, and ``grid`` is the whole frame's (H, w).  Every
bound and case is evaluated at frame rows; the defaults (0, 0, the band's
own size) are the whole-frame call.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take.  A tensor on the CPU goes to the kernel's plain
PyTorch version (``<wrapper>_plain``); a CUDA tensor launches the kernel or
raises — there is no fallback.  Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from streamoptima_tpu_torch.core import intra as I
from streamoptima_tpu_torch.core import me as M
from streamoptima_tpu_torch.core import rd
from streamoptima_tpu_torch.core.fastme import confirm as fast_confirm_plain
from streamoptima_tpu_torch.core.fastme import rowscan_pass_plain, window_fetch_plain
from streamoptima_tpu_torch.core.blocks import blockify, merge_quads, quads_px, unblockify, unquads_px
from streamoptima_tpu_torch.core.pred import gather_predictions, wrap_uint8
from streamoptima_tpu_torch.core.quant import qp_minus_1, rescale
from streamoptima_tpu_torch.core.transform import dct2_scipy, dct_matrix_fixed, idct2_int, idct2_scipy
from streamoptima_tpu_torch.core.zigzag import diag_scan_indices, scan_indices
from streamoptima_tpu_torch.profiling import to_device, tracer

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


def _check_band(cur_hw: tuple, band_hw: tuple, band_row0: int, g_row0: int, grid, reach=None) -> int:
    """Check a band's geometry (module docstring); returns the frame height H.

    ``reach``: the frame rows above and below cur that a search reads; the
    band must hold those that lie in the frame."""
    h, w = cur_hw
    bandh, bw = band_hw
    H, W = (bandh, w) if grid is None else grid
    if bw != w or W != w:
        raise ValueError(f"refs {bandh}x{bw} in a {H}x{W} frame do not match cur's width {w}")
    if min(band_row0, g_row0) < 0 or band_row0 + h > bandh or g_row0 + h > H:
        raise ValueError(f"cur's {h} rows at refs row {band_row0} (frame row {g_row0}) do not fit refs of {bandh} "
                         f"rows in a {H}-row frame")
    if reach is not None and (band_row0 < min(reach[0], g_row0)
                              or bandh - band_row0 - h < min(reach[1], H - g_row0 - h)):
        raise ValueError(f"refs hold {band_row0} rows above cur and {bandh - band_row0 - h} below; the search "
                         f"reads {reach[0]} above and {reach[1]} below")
    return H


def _launch_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------------ full search
def _search_smem(sr: int, bs: int, vbs: bool) -> int:
    """The whole-pel search's shared-memory budget for a macroblock (bytes):
    the block (as int32 without VBS, as bytes with it) and its (bs + 2sr)^2
    window.  The wrappers refuse what exceeds ``_SMEM_LIMIT``; the kernel
    runs every shape inside this budget (``csrc/full_search.cu``)."""
    return bs * bs * (1 if vbs else 4) + (bs + 2 * sr) ** 2


def _check_smem(bs: int, sr: int, smem: int) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(f"bs={bs}, sr={sr}: the search window exceeds a block's shared memory")


def _grid(refs: torch.Tensor, grid) -> tuple[int, int]:
    return (refs.shape[-2], refs.shape[-1]) if grid is None else tuple(grid)


def full_search_plain(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0,
                      g_row0: int = 0, grid=None) -> dict:
    """Plain PyTorch version of the ``full_search`` kernel (any device)."""
    h, w = cur.shape
    dims = _grid(refs, grid)
    out = M.full_search_materialized(cur, refs, sr, bs, row_offset=band_row0, grid_dims=dims,
                                     valid_row_offset=g_row0)
    bx, by = M.block_origins(h, w, bs, cur.device)
    g = gather_predictions(out["mv"], refs, bx, by + g_row0, bs, grid_dims=dims, origin_row=g_row0 - band_row0)
    g = torch.where(out["ok"][:, None, None], g, 0)  # no valid candidate: zeros
    out["pred"] = unblockify(g, h, w).to(torch.int16)
    return out


def full_search(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0, g_row0: int = 0,
                grid=None) -> dict:
    """Whole-pel full search of ``cur`` (h, w) over ``refs`` (nref, bandh, w),
    the frames or a band of them (module docstring).

    Both uint8.  Returns {"mv": (nb, 3) int32 [dx, dy, ref], "sad": (nb,)
    int32, "ok": (nb,) bool, "pred": (h, w) int16} — the non-VBS contract of
    ``full_search_pallas``: ``pred`` holds each block's winning window, and
    zeros where ``ok`` is False (no valid candidate: mv = (0, 0, 0),
    sad = INT32_MAX).
    """
    _check_plane(cur, "cur", 2)
    _check_plane(refs, "refs", 3)
    h, w = cur.shape
    nref, bandh = refs.shape[:2]
    H = _check_band(cur.shape, refs.shape[1:], band_row0, g_row0, grid, (sr, sr))
    _check_search(cur, refs, nref, sr, bs)
    if cur.device.type == "cpu":
        return full_search_plain(cur, refs, sr, bs, band_row0=band_row0, g_row0=g_row0, grid=(H, w))
    _check_smem(bs, sr, _search_smem(sr, bs, False))
    from streamoptima_tpu_torch._build import library

    lib = library()
    nb = (h // bs) * (w // bs)
    dev = cur.device
    mv = torch.empty((nb, 3), dtype=torch.int32, device=dev)
    sad = torch.empty((nb,), dtype=torch.int32, device=dev)
    ok = torch.empty((nb,), dtype=torch.bool, device=dev)
    pred = torch.empty((h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        rc = lib.so_full_search(cur.data_ptr(), refs.data_ptr(), nref, h, w, sr, bs, bandh, band_row0, g_row0, H,
                                mv.data_ptr(), sad.data_ptr(), ok.data_ptr(), pred.data_ptr(), _stream(dev))
    _launch_check(rc, "full_search")
    full_search.launches += 1
    return {"mv": mv, "sad": sad, "ok": ok, "pred": pred}


full_search.launches = 0


# ------------------------------------------ the MVs-only full searches
_BLOCK_KEYS = ("mv", "sad", "ok")
_QUAD_KEYS = ("sub_mv", "sub_sad", "sub_ok")


def _launch_search(entry: str, cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int, vbs: bool,
                   smem: int, band: tuple) -> dict:
    """Allocate the outputs and launch one MVs-only search kernel, whose
    shared-memory budget for a macroblock is ``smem`` bytes; ``band`` is
    (band_row0, g_row0, H)."""
    _check_smem(bs, sr, smem)
    from streamoptima_tpu_torch._build import library

    h, w = cur.shape
    nb, dev = (h // bs) * (w // bs), cur.device
    shapes = {"mv": (nb, 3), "sad": (nb,), "ok": (nb,), "sub_mv": (nb, 4, 3), "sub_sad": (nb, 4), "sub_ok": (nb, 4)}
    keys = _BLOCK_KEYS + (_QUAD_KEYS if vbs else ())
    out = {k: torch.empty(shapes[k], dtype=torch.bool if k.endswith("ok") else torch.int32, device=dev) for k in keys}
    with torch.cuda.device(dev):
        rc = getattr(library(), f"so_{entry}")(cur.data_ptr(), refs.data_ptr(), refs.shape[0], h, w, sr, bs,
                                               refs.shape[-2], *band, *(out[k].data_ptr() for k in keys),
                                               _stream(dev))
    _launch_check(rc, entry)
    return out


def full_search_vbs_plain(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0,
                          g_row0: int = 0, grid=None) -> dict:
    """Plain PyTorch version of the ``full_search_vbs`` kernel (any device)."""
    return M.full_search_materialized(cur, refs, sr, bs, vbs=True, row_offset=band_row0,
                                      grid_dims=_grid(refs, grid), valid_row_offset=g_row0)


def full_search_vbs(cur: torch.Tensor, refs: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0,
                    g_row0: int = 0, grid=None) -> dict:
    """Whole-pel full search of ``cur`` (h, w) over ``refs`` (nref, bandh,
    w), the frames or a band of them, both uint8, with the VBS quads.

    Returns {"mv", "sad", "ok"} per block ((nb, 3) int32, (nb,) int32,
    (nb,) bool) and {"sub_mv", "sub_sad", "sub_ok"} per quad ((nb, 4, 3),
    (nb, 4), (nb, 4)) in Z order — the ``full_search_pallas(vbs=True,
    want_pred=False)`` contract.  Each quad has its own validity (its own
    origin and size in the strict bounds).  No valid candidate: mv =
    (0, 0, 0), sad = INT32_MAX, ok False.
    """
    _check_plane(cur, "cur", 2)
    _check_plane(refs, "refs", 3)
    H = _check_band(cur.shape, refs.shape[1:], band_row0, g_row0, grid, (sr, sr))
    if bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    _check_search(cur, refs, refs.shape[0], sr, bs)
    if cur.device.type == "cpu":
        return full_search_vbs_plain(cur, refs, sr, bs, band_row0=band_row0, g_row0=g_row0, grid=(H, cur.shape[1]))
    out = _launch_search("full_search_vbs", cur, refs, sr, bs, True, _search_smem(sr, bs, True),
                         (band_row0, g_row0, H))
    full_search_vbs.launches += 1
    return out


full_search_vbs.launches = 0


def _fme_search_plain(cur, planes, sr, bs, vbs, band_row0, g_row0, grid) -> dict:
    """The stride-2 materialized search on the half-pel grid that the parity
    planes interleave into (rows and bounds on the grid: doubled)."""
    H, W = _grid(planes, grid)
    return M.full_search_materialized(cur, M.grid_of_planes(planes), 2 * sr, bs, fme=True, vbs=vbs,
                                      row_offset=2 * band_row0, grid_dims=(2 * H - 1, 2 * W - 1),
                                      valid_row_offset=2 * g_row0)


def full_search_fme_plain(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0,
                          g_row0: int = 0, grid=None) -> dict:
    """Plain PyTorch version of the ``full_search_fme`` kernel (any device)."""
    return _fme_search_plain(cur, planes, sr, bs, False, band_row0, g_row0, grid)


def full_search_fme_vbs_plain(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0,
                              g_row0: int = 0, grid=None) -> dict:
    """Plain PyTorch version of the ``full_search_fme_vbs`` kernel (any device)."""
    return _fme_search_plain(cur, planes, sr, bs, True, band_row0, g_row0, grid)


def _check_fme_search(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int, vbs: bool, band_row0: int,
                      g_row0: int, grid) -> int:
    """Check an FME search's inputs; returns the frame height H.  The
    candidates' half-pel rows reach sr frame rows above cur and, through the
    interpolation, sr + 1 below."""
    _check_plane(cur, "cur", 2)
    _check_plane(planes, "planes", 4)
    if planes.shape[1] != 4:
        raise ValueError(f"planes {tuple(planes.shape)} are not (nref, 4, bandh, w)")
    H = _check_band(cur.shape, planes.shape[2:], band_row0, g_row0, grid, (sr, sr + 1))
    if vbs and bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    _check_search(cur, planes, planes.shape[0], 2 * sr, bs)
    return H


def _fme_smem(sr: int, bs: int) -> int:
    return bs * bs + 4 * ((bs + 2 * sr) ** 2 + 4)  # the block and the four plane windows


def full_search_fme(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0,
                    g_row0: int = 0, grid=None) -> dict:
    """Half-pel full search of ``cur`` (h, w) uint8, block winners only.

    planes: (nref, 4, bandh, w) uint8, the parity planes of each reference
    (``me.fme_parity_planes``) or of a band of it (module docstring; the
    grid is then (2H - 1, 2w - 1)).  Candidates span +-2sr on the half-pel
    grid.
    Returns {"mv", "sad", "ok"} ((nb, 3) int32, (nb,) int32, (nb,) bool) —
    the ``full_search_pallas_fme(vbs=False, want_pred=False)`` contract.  No
    valid candidate: mv = (0, 0, 0), sad = INT32_MAX, ok False.
    """
    H = _check_fme_search(cur, planes, sr, bs, False, band_row0, g_row0, grid)
    if cur.device.type == "cpu":
        return full_search_fme_plain(cur, planes, sr, bs, band_row0=band_row0, g_row0=g_row0, grid=(H, cur.shape[1]))
    out = _launch_search("full_search_fme", cur, planes, sr, bs, False, _fme_smem(sr, bs), (band_row0, g_row0, H))
    full_search_fme.launches += 1
    return out


full_search_fme.launches = 0


def full_search_fme_vbs(cur: torch.Tensor, planes: torch.Tensor, sr: int, bs: int, *, band_row0: int = 0,
                        g_row0: int = 0, grid=None) -> dict:
    """``full_search_fme`` with the VBS quads: also {"sub_mv", "sub_sad",
    "sub_ok"} per quad ((nb, 4, 3), (nb, 4), (nb, 4)) in Z order, each quad
    with its own validity — the ``full_search_pallas_fme(vbs=True,
    want_pred=False)`` contract.
    """
    H = _check_fme_search(cur, planes, sr, bs, True, band_row0, g_row0, grid)
    if cur.device.type == "cpu":
        return full_search_fme_vbs_plain(cur, planes, sr, bs, band_row0=band_row0, g_row0=g_row0,
                                         grid=(H, cur.shape[1]))
    out = _launch_search("full_search_fme_vbs", cur, planes, sr, bs, True, _fme_smem(sr, bs),
                         (band_row0, g_row0, H))
    full_search_fme_vbs.launches += 1
    return out


full_search_fme_vbs.launches = 0


# ------------------------------------------------------------- pred fetch
# Each fetch returns the (h, w) planes of the rows its MVs' blocks cover: the
# whole frame, or with a band (module docstring) the h = nb / (w / bs) * bs
# rows at g_row0.  A read in the frame but outside the band takes the band's
# nearest row, as the JAX band gather does.
def _fetch_origins(h: int, w: int, bs: int, g_row0: int, device):
    bx, by = M.block_origins(h, w, bs, device)
    return bx, by + g_row0


def pred_fetch_plain(mv: torch.Tensor, refs: torch.Tensor, bs: int, *, band_row0: int = 0, g_row0: int = 0,
                     grid=None) -> torch.Tensor:
    """Plain PyTorch version of the ``pred_fetch`` kernel (any device)."""
    w = refs.shape[-1]
    h = mv.shape[0] // (w // bs) * bs
    bx, by = _fetch_origins(h, w, bs, g_row0, refs.device)
    return unblockify(gather_predictions(mv, refs, bx, by, bs, grid_dims=_grid(refs, grid),
                                         origin_row=g_row0 - band_row0), h, w).to(torch.int16)


def _check_fetch(mv: torch.Tensor, refs: torch.Tensor, bs: int, band_row0: int, g_row0: int, grid):
    """Check a fetch's MVs and band; returns (h, w, H) of the output rows
    and the frame."""
    bandh, w = refs.shape[-2:]
    nbc = w // bs
    if w % bs or mv.shape[0] % max(nbc, 1) or mv.shape[0] == 0:
        raise ValueError(f"mv has {mv.shape[0]} blocks, not whole rows of a {w}-pixel-wide frame at bs={bs}")
    h = mv.shape[0] // nbc * bs
    H = _check_band((h, w), (bandh, w), band_row0, g_row0, grid)
    _check_mv(mv, "mv", (mv.shape[0], 3), refs.device)
    if refs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pred_fetch runs on cpu or cuda tensors, not {refs.device}")
    return h, w, H


def _launch_fetch(what: str, mv: torch.Tensor, sub_mv, planes: torch.Tensor, bs: int, fme: bool, h: int,
                  band: tuple, quad_margin: int | None = None):
    """Allocate the (h, w) prediction plane(s) and launch the ``pred_fetch``
    kernel; the quad plane is fetched when ``sub_mv`` is given.  ``band`` is
    (band_row0, g_row0, H); ``quad_margin``: the quads' FME margin (default
    their size)."""
    from streamoptima_tpu_torch._build import library

    bandh, w = planes.shape[-2:]
    dev = planes.device
    pred = torch.empty((h, w), dtype=torch.int16, device=dev)
    pred_q = None if sub_mv is None else torch.empty((h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        rc = library().so_pred_fetch(mv.data_ptr(), None if sub_mv is None else sub_mv.data_ptr(),
                                     planes.data_ptr(), planes.shape[0], h, w, bs, int(fme), bandh, *band,
                                     bs // 2 if quad_margin is None else quad_margin, pred.data_ptr(),
                                     None if pred_q is None else pred_q.data_ptr(), _stream(dev))
    _launch_check(rc, what)
    return pred if pred_q is None else (pred, pred_q)


def pred_fetch(mv: torch.Tensor, refs: torch.Tensor, bs: int, *, band_row0: int = 0, g_row0: int = 0,
               grid=None) -> torch.Tensor:
    """Whole-pel prediction plane for given MVs.

    mv: (nb, 3) int32 [dx, dy, ref] in block raster order; refs: (nref,
    bandh, w) uint8, the frames or a band of them.  Returns (h, w) int16:
    each block's window at (by + dy, bx + dx) of ``refs[ref]``, zero outside
    the frame.  Reference indices must lie in [0, nref): the decoder checks
    the stream on the host before calling.
    """
    _check_plane(refs, "refs", 3)
    h, w, H = _check_fetch(mv, refs, bs, band_row0, g_row0, grid)
    if refs.device.type == "cpu":
        return pred_fetch_plain(mv, refs, bs, band_row0=band_row0, g_row0=g_row0, grid=(H, w))
    pred = _launch_fetch("pred_fetch", mv, None, refs, bs, False, h, (band_row0, g_row0, H))
    pred_fetch.launches += 1
    return pred


pred_fetch.launches = 0


def _quad_plane(sub_mv: torch.Tensor, grid: torch.Tensor, h: int, w: int, bs: int, fme: bool, g_row0: int,
                grid_dims: tuple, origin_row: int, fme_margin: int | None = None) -> torch.Tensor:
    """Each quad's prediction at its own position: (h, w) int16."""
    s = bs // 2
    qx, qy = M.quad_origins(h, w, bs, grid.device)
    quads = gather_predictions(sub_mv.reshape(-1, 3), grid, qx.reshape(-1), qy.reshape(-1) + g_row0, s, fme=fme,
                               grid_dims=grid_dims, origin_row=origin_row, fme_margin=fme_margin)
    return unquads_px(quads.reshape(-1, 4, s, s), h, w).to(torch.int16)


def pred_fetch_vbs_plain(mv: torch.Tensor, sub_mv: torch.Tensor, refs: torch.Tensor, bs: int, *,
                         band_row0: int = 0, g_row0: int = 0, grid=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``pred_fetch`` kernel's whole-pel mode
    with the quad plane (any device)."""
    w = refs.shape[-1]
    h = mv.shape[0] // (w // bs) * bs
    dims = _grid(refs, grid)
    return (pred_fetch_plain(mv, refs, bs, band_row0=band_row0, g_row0=g_row0, grid=dims),
            _quad_plane(sub_mv, refs, h, w, bs, False, g_row0, dims, g_row0 - band_row0))


def pred_fetch_vbs(mv: torch.Tensor, sub_mv: torch.Tensor, refs: torch.Tensor, bs: int, *, band_row0: int = 0,
                   g_row0: int = 0, grid=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-pel prediction planes for given block and quad MVs.

    mv: (nb, 3), sub_mv: (nb, 4, 3) int32 [dx, dy, ref] (quads in Z order);
    refs: (nref, bandh, w) uint8, the frames or a band of them.  Returns
    (pred_full, pred_quads), both (h, w) int16 with each (sub)block's window
    at its own position, zero outside the frame.  Reference indices must lie
    in [0, nref).
    """
    _check_plane(refs, "refs", 3)
    if bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    h, w, H = _check_fetch(mv, refs, bs, band_row0, g_row0, grid)
    _check_mv(sub_mv, "sub_mv", (mv.shape[0], 4, 3), refs.device)
    if refs.device.type == "cpu":
        return pred_fetch_vbs_plain(mv, sub_mv, refs, bs, band_row0=band_row0, g_row0=g_row0, grid=(H, w))
    out = _launch_fetch("pred_fetch_vbs", mv, sub_mv, refs, bs, False, h, (band_row0, g_row0, H))
    pred_fetch_vbs.launches += 1
    return out


pred_fetch_vbs.launches = 0


def _fme_fetch_args(planes: torch.Tensor, band_row0: int, g_row0: int, grid):
    """The half-pel grid of the planes, its whole-frame dims and its origin row."""
    H, W = _grid(planes, grid)
    return M.grid_of_planes(planes), (2 * H - 1, 2 * W - 1), 2 * (g_row0 - band_row0)


def pred_fetch_fme_plain(mv: torch.Tensor, planes: torch.Tensor, bs: int, *, band_row0: int = 0, g_row0: int = 0,
                         grid=None) -> torch.Tensor:
    """Plain PyTorch version of the ``pred_fetch`` kernel's FME mode (any
    device): ``pred.gather_predictions`` on the half-pel grid."""
    w = planes.shape[-1]
    h = mv.shape[0] // (w // bs) * bs
    bx, by = _fetch_origins(h, w, bs, g_row0, planes.device)
    g, dims, origin = _fme_fetch_args(planes, band_row0, g_row0, grid)
    return unblockify(gather_predictions(mv, g, bx, by, bs, fme=True, grid_dims=dims, origin_row=origin),
                      h, w).to(torch.int16)


def pred_fetch_fme_vbs_plain(mv: torch.Tensor, sub_mv: torch.Tensor, planes: torch.Tensor, bs: int, *,
                             band_row0: int = 0, g_row0: int = 0, grid=None,
                             quad_margin: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``pred_fetch`` kernel's FME mode with
    the quad plane (any device)."""
    w = planes.shape[-1]
    h = mv.shape[0] // (w // bs) * bs
    g, dims, origin = _fme_fetch_args(planes, band_row0, g_row0, grid)
    return (pred_fetch_fme_plain(mv, planes, bs, band_row0=band_row0, g_row0=g_row0, grid=grid),
            _quad_plane(sub_mv, g, h, w, bs, True, g_row0, dims, origin, quad_margin))


def _check_planes4(planes: torch.Tensor) -> None:
    _check_plane(planes, "planes", 4)
    if planes.shape[1] != 4:
        raise ValueError(f"planes {tuple(planes.shape)} are not (nref, 4, bandh, w)")


def pred_fetch_fme(mv: torch.Tensor, planes: torch.Tensor, bs: int, *, band_row0: int = 0, g_row0: int = 0,
                   grid=None) -> torch.Tensor:
    """Half-pel prediction plane for given block MVs.

    mv: (nb, 3) int32 [dx, dy, ref] on the half-pel grid; planes: (nref, 4,
    bandh, w) uint8 parity planes of the frames or of a band of them.
    Returns (h, w) int16 with each block's prediction at its own position:
    case A (the stride-2 grid window), B (128) or C (the stride-1 grid
    window, zero off the grid), each decided at frame rows.  Reference
    indices must lie in [0, nref).
    """
    _check_planes4(planes)
    h, w, H = _check_fetch(mv, planes, bs, band_row0, g_row0, grid)
    if planes.device.type == "cpu":
        return pred_fetch_fme_plain(mv, planes, bs, band_row0=band_row0, g_row0=g_row0, grid=(H, w))
    pred = _launch_fetch("pred_fetch_fme", mv, None, planes, bs, True, h, (band_row0, g_row0, H))
    pred_fetch_fme.launches += 1
    return pred


pred_fetch_fme.launches = 0


def pred_fetch_fme_vbs(mv: torch.Tensor, sub_mv: torch.Tensor, planes: torch.Tensor, bs: int, *,
                       band_row0: int = 0, g_row0: int = 0, grid=None,
                       quad_margin: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-pel prediction planes for given block and quad MVs.

    mv: (nb, 3), sub_mv: (nb, 4, 3) int32 [dx, dy, ref] on the half-pel grid
    (quads in Z order); planes: (nref, 4, bandh, w) uint8 parity planes of
    the frames or of a band of them.  Returns (pred_full, pred_quads), both
    (h, w) int16 with each (sub)block's prediction at its own position: case
    A, B or C as in ``pred_fetch_fme``, per block and per quad; the quads'
    margin check is ``0 <= p + bs < D - quad_margin`` (default bs / 2, the
    quad's own size; the compat engine's reconstruction passes bs, quirk
    K18).  Reference indices must lie in [0, nref).
    """
    _check_planes4(planes)
    if bs % 2:
        raise ValueError(f"VBS needs an even block size, got {bs}")
    h, w, H = _check_fetch(mv, planes, bs, band_row0, g_row0, grid)
    _check_mv(sub_mv, "sub_mv", (mv.shape[0], 4, 3), planes.device)
    if planes.device.type == "cpu":
        return pred_fetch_fme_vbs_plain(mv, sub_mv, planes, bs, band_row0=band_row0, g_row0=g_row0, grid=(H, w),
                                        quad_margin=quad_margin)
    out = _launch_fetch("pred_fetch_fme_vbs", mv, sub_mv, planes, bs, True, h, (band_row0, g_row0, H), quad_margin)
    pred_fetch_fme_vbs.launches += 1
    if quad_margin is not None and quad_margin != bs // 2:
        pred_fetch_fme_vbs.margin_launches += 1
    return out


pred_fetch_fme_vbs.launches = 0
#: of those, the launches at a quad margin other than the quads' own size (the compat engine's K18)
pred_fetch_fme_vbs.margin_launches = 0


# ------------------------------------------------------------ window fetch
def window_fetch(planes: torch.Tensor, by0: torch.Tensor, bx0: torch.Tensor, nwin: int,
                 nwin_c: int | None = None) -> torch.Tensor:
    """``out[b, p, i, j] = planes[p, by0[b] + i, bx0[b] + j]``, zero outside
    the plane (a window partly outside is partly zero).

    planes: (P, H, W) uint8; by0, bx0: (nb,) int32 origins of any value.
    Returns (nb, P, nwin, nwin_c) uint8 (``nwin_c`` defaults to ``nwin``):
    plane values are pixels or ceil-averages of pixels, so uint8 holds them;
    the TPU kernel it replaces returns int32.  The plain version is
    ``window_fetch_plain``.  The kernel takes any P, H, W, extents and
    planes base address; an empty output (nb or P zero) launches nothing.
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

    P, H, W = planes.shape
    out = torch.empty((nb, P, nwin, nc), dtype=torch.uint8, device=planes.device)
    if out.numel() == 0:  # no window or no plane: nothing to launch
        return out
    lib = library()
    with torch.cuda.device(planes.device):
        rc = lib.so_window_fetch(planes.data_ptr(), by0.data_ptr(), bx0.data_ptr(), nb, P, H, W, nwin, nc,
                                 out.data_ptr(), _stream(planes.device))
    _launch_check(rc, "window_fetch")
    window_fetch.launches += 1
    return out


window_fetch.launches = 0


# ------------------------------------------------------------ rowscan pass
def rowscan_pass(cur: torch.Tensor, planes: torch.Tensor, seeds: torch.Tensor, bs: int, fme: bool, *,
                 g_row0: int = 0, grid=None) -> torch.Tensor:
    """One sweep pass of the fast-ME MVP chain over every block row.

    cur: (h, w) uint8, frame rows [g_row0, g_row0 + h) (a mesh tile's, or
    the whole frame); planes: (nref, 4, H, w) uint8 parity planes
    (``me.fme_parity_planes``) of the whole frame under ``fme``, else the
    (nref, H, w) uint8 references; ``grid``, if given, must be the frame's
    (H, w).  seeds: (S, 3) int32 [gx, gy, gref], the guessed MVP of each
    block row's first block (S = h / bs).  Returns (S, L, 3) int32, L = w / bs:
    ``mv[s, j]`` is the 3x3 fast-ME winner of block (s, j) around
    ``mv[s, j - 1]`` (``seeds[s]`` for j = 0), on the half-pel grid under
    ``fme``, every window and K7 bound at frame rows.  Rows are independent
    within a pass; the caller iterates the seeds.  The TPU kernel it replaces
    also returns its fetched windows for the confirm pass; here that pass
    reads through ``window_fetch``.  The plain version is
    ``rowscan_pass_plain``.
    """
    _check_plane(cur, "cur", 2)
    _check_plane(planes, "planes", 4 if fme else 3)
    h, w = cur.shape
    nref, H = planes.shape[0], planes.shape[-2]
    want = (nref, 4, H, w) if fme else (nref, H, w)
    if tuple(planes.shape) != want:
        raise ValueError(f"planes {tuple(planes.shape)} are not {want}")
    if grid is not None and tuple(grid) != (H, w):
        raise ValueError(f"grid {tuple(grid)} disagrees with the planes' {H}x{w} frame")
    if g_row0 < 0 or g_row0 + h > H:
        raise ValueError(f"cur's {h} rows at frame row {g_row0} do not fit the planes' {H} rows")
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
        return rowscan_pass_plain(cur, planes, seeds, bs, fme, g_row0=g_row0, grid=(H, w))
    from streamoptima_tpu_torch._build import library

    lib = library()
    if lib.so_rowscan_pass_smem(nref, bs, int(fme)) == 0:
        raise ValueError(f"bs={bs}, nref={nref}: the prefetched regions exceed a block's shared memory")
    mvs = torch.empty((h // bs, w // bs, 3), dtype=torch.int32, device=cur.device)
    with torch.cuda.device(cur.device):
        rc = lib.so_rowscan_pass(cur.data_ptr(), planes.data_ptr(), seeds.data_ptr(), nref, h, w, bs, int(fme),
                                 g_row0, H, mvs.data_ptr(), _stream(cur.device))
    _launch_check(rc, "rowscan_pass")
    rowscan_pass.launches += 1
    return mvs


rowscan_pass.launches = 0


# ------------------------------------------------------------ fast-ME confirm
def fast_confirm(win: torch.Tensor, cur_blocks: torch.Tensor, g: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                 bs: int, dims: tuple[int, int], fme: bool, vbs: bool) -> dict:
    """The fast-ME confirm at MVPs ``g``: each block's winner of the 3x3
    search and, with ``vbs``, its quads' (``fast_confirm_plain``, which is
    ``core.fastme.confirm``: the same contract, bit for bit).

    win: (nb, P, bs + 2, bs + 2) uint8, the regions ``window_fetch`` reads
    at ``core.fastme.region_base(g)`` (P = nref, or 4 * nref parity planes
    under ``fme``); cur_blocks: (nb, bs, bs) int32; g: (nb, 3) int32; X, Y:
    (nb,) int32 block origins on the grid (doubled under ``fme``), whose
    extent is ``dims`` = (H, W).  Returns {"mv", "sad", "ok"} and, with
    ``vbs``, {"sub_mv", "sub_sad", "sub_ok"}.  The tracer's
    ``confirm_blocks`` counts the blocks by route (``kernel``, ``plain``);
    an empty batch launches nothing."""
    _check_plane(win, "win", 4)
    nb, P = win.shape[:2]
    if tuple(win.shape[2:]) != (bs + 2, bs + 2) or bs < 1:
        raise ValueError(f"win {tuple(win.shape)} does not hold (bs + 2)^2 regions of bs={bs} blocks")
    if P < 1 or (fme and P % 4):
        raise ValueError(f"win's {P} planes are not {'4 * nref parity planes' if fme else 'nref references'}")
    dev = win.device
    if cur_blocks.dtype != torch.int32 or tuple(cur_blocks.shape) != (nb, bs, bs) or not cur_blocks.is_contiguous():
        raise ValueError(f"cur_blocks must be a contiguous {(nb, bs, bs)} int32 tensor, got {cur_blocks.dtype} "
                         f"{tuple(cur_blocks.shape)}")
    if cur_blocks.device != dev:
        raise ValueError("cur_blocks and win must be on one device")
    _check_mv(g, "g", (nb, 3), dev)
    _check_mv(X, "X", (nb,), dev)
    _check_mv(Y, "Y", (nb,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fast_confirm runs on cpu or cuda tensors, not {dev}")
    if dev.type == "cpu":
        if tracer.on:
            tracer.confirm_blocks["plain"] += nb
        return fast_confirm_plain(win, cur_blocks, g, X, Y, bs, dims, fme, vbs)
    from streamoptima_tpu_torch._build import library

    lib = library()
    if lib.so_fast_confirm_smem(P, bs, int(fme)) == 0:
        raise ValueError(f"bs={bs}, P={P}: a block's regions exceed a CUDA block's shared memory")
    shapes = {"mv": (nb, 3), "sad": (nb,), "ok": (nb,), "sub_mv": (nb, 4, 3), "sub_sad": (nb, 4), "sub_ok": (nb, 4)}
    keys = _BLOCK_KEYS + (_QUAD_KEYS if vbs else ())
    out = {k: torch.empty(shapes[k], dtype=torch.bool if k.endswith("ok") else torch.int32, device=dev) for k in keys}
    if tracer.on:
        tracer.confirm_blocks["kernel"] += nb
    if nb == 0:  # nothing to launch
        return out
    subs = [out[k].data_ptr() if vbs else None for k in _QUAD_KEYS]
    with torch.cuda.device(dev):
        rc = lib.so_fast_confirm(win.data_ptr(), cur_blocks.data_ptr(), g.data_ptr(), X.data_ptr(), Y.data_ptr(), nb,
                                 P, bs, int(fme), int(vbs), dims[0], dims[1],
                                 *(out[k].data_ptr() for k in _BLOCK_KEYS), *subs, _stream(dev))
    _launch_check(rc, "fast_confirm")
    fast_confirm.launches += 1
    return out


fast_confirm.launches = 0


# ----------------------------------------------------- scipy-exact DCT
def dct_scipy_plain(blocks: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the ``dct_scipy`` kernel (any device)."""
    return (idct2_scipy if inverse else dct2_scipy)(blocks)


def dct_scipy(blocks: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The compat engine's 2D DCT-II (``inverse``: its inverse, a DCT-III)
    of (nb, n, n) int64 blocks, n in {8, 16}: scipy.fftpack's orthonormal
    transform along axis -2 then axis -1, rounded half to even, bit for bit.
    Returns (nb, n, n) int64.  The plain version is ``dct_scipy_plain``
    (``transform.dct2_scipy`` / ``idct2_scipy``, any power of two n); the
    kernel replays its float64 operations in their order.  An empty batch
    launches nothing.
    """
    if blocks.dtype != torch.int64 or blocks.dim() != 3 or not blocks.is_contiguous():
        raise ValueError(f"dct_scipy takes contiguous (nb, n, n) int64 blocks, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    nb, n = blocks.shape[0], blocks.shape[-1]
    if blocks.shape[1] != n:
        raise ValueError(f"blocks must be square, got {tuple(blocks.shape)}")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dct_scipy runs on cpu or cuda tensors, not {blocks.device}")
    if blocks.device.type == "cpu":
        return dct_scipy_plain(blocks, inverse)
    if n not in (8, 16):
        raise ValueError(f"the dct_scipy kernel takes 8 x 8 and 16 x 16 blocks, got {n} x {n}")
    out = torch.empty_like(blocks)
    if nb == 0:
        return out
    from streamoptima_tpu_torch._build import library

    with torch.cuda.device(blocks.device):
        rc = library().so_dct_scipy(blocks.data_ptr(), out.data_ptr(), nb, n, int(inverse), _stream(blocks.device))
    _launch_check(rc, "dct_scipy")
    dct_scipy.launches += 1
    return out


dct_scipy.launches = 0


# ----------------------------------------------------- intra reconstruction
def intra_recon_plain(residual_full: torch.Tensor, mv: torch.Tensor, h: int, w: int, bs: int, sr: int,
                      residual_quads=None, split=None, sub_mv=None, transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the ``intra_recon`` kernel (any device)."""
    if not transpose:
        return wrap_uint8(I.intra_reconstruct_mode0(residual_full, mv, h, w, bs, sr, residual_quads=residual_quads,
                                                    split=split, sub_mv=sub_mv))
    rq = None if residual_quads is None else residual_quads.transpose(-1, -2)
    return wrap_uint8(I.intra_reconstruct_mode0(residual_full.transpose(-1, -2), mv, w, h, bs, sr, residual_quads=rq,
                                                split=split, sub_mv=sub_mv)).T.contiguous()


def intra_recon(residual_full: torch.Tensor, mv: torch.Tensor, h: int, w: int, bs: int, sr: int,
                residual_quads=None, split=None, sub_mv=None, transpose: bool = False) -> torch.Tensor:
    """Mode-0 intra reconstruction of an (h, w) frame, wrapped to uint8.

    residual_full: (nb, bs, bs) int32 or int64 dequantized residuals; mv:
    (nb,) int32; under VBS also residual_quads (nb, 4, s, s), split (nb,)
    bool and sub_mv (nb, 4) int32 (without ``residual_quads`` the flags and
    sub-MVs go unread).  ``transpose`` (intra mode 1): mode 0 on the
    transposed frame, whose raster order numbers the blocks; the residuals
    lie as in the frame (each block, and each quad, the transpose of the
    transposed frame's), and the result is the frame.  Returns (h, w)
    uint8: ``wrap_uint8`` of ``intra.intra_reconstruct_mode0``, which is the
    plain version (``intra_recon_plain``).  The kernel takes bs <= 32 (even
    under VBS) and sr + bs <= 256; int64 residuals are cast to int32 on the
    device (mod 2^32, which the final wrap mod 256 does not see), and MVs
    and flags of any stride are made contiguous.
    """
    hh, ww = (w, h) if transpose else (h, w)
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} is not a multiple of block size {bs}")
    nbr, nbc = hh // bs, ww // bs
    nb = nbr * nbc
    dev = residual_full.device
    vbs = residual_quads is not None
    ints = (torch.int32, torch.int64)
    want = {"residual_full": (residual_full, (nb, bs, bs), ints), "mv": (mv, (nb,), (torch.int32,))}
    if vbs:
        s = bs // 2
        want.update(residual_quads=(residual_quads, (nb, 4, s, s), ints), split=(split, (nb,), (torch.bool,)),
                    sub_mv=(sub_mv, (nb, 4), (torch.int32,)))
    for name, (t, shape, dtypes) in want.items():
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {shape} tensor, got {None if t is None else tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} and residual_full must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"intra_recon runs on cpu or cuda tensors, not {dev}")
    if dev.type == "cpu":
        return intra_recon_plain(residual_full, mv, h, w, bs, sr, residual_quads, split, sub_mv, transpose)
    if not 1 <= bs <= 32 or sr < 0 or sr + bs > 256 or (vbs and bs % 2):
        raise ValueError(f"the intra_recon kernel takes 1 <= bs <= 32 (even under VBS) and sr + bs <= 256, got "
                         f"bs={bs}, sr={sr}")
    out = torch.empty((h, w), dtype=torch.uint8, device=dev)
    if nb == 0:
        return out
    from streamoptima_tpu_torch._build import library

    rf, mv = residual_full.to(torch.int32).contiguous(), mv.contiguous()
    rq_p = split_p = smv_p = None  # without VBS the kernel reads no quads, flags or sub-MVs
    if vbs:
        rq, split, sub_mv = residual_quads.to(torch.int32).contiguous(), split.contiguous(), sub_mv.contiguous()
        rq_p, split_p, smv_p = rq.data_ptr(), split.data_ptr(), sub_mv.data_ptr()
    with torch.cuda.device(dev):
        rc = library().so_intra_recon(rf.data_ptr(), rq_p, split_p, mv.data_ptr(), smv_p, nbr, nbc, bs, sr,
                                      int(transpose), out.data_ptr(), _stream(dev))
    _launch_check(rc, "intra_recon")
    intra_recon.launches += 1
    return out


intra_recon.launches = 0


# ------------------------------------------------ residual coding: shared checks and tables
#: block sizes the transform kernels take (the transform's int32 bounds hold up to 16; the MAE divisions are exact)
_TRANSFORM_SIZES = (4, 8, 16)


def _check_tensors(what: str, want: dict, device) -> None:
    """``want``: name -> (tensor, shape, dtypes); each must be a contiguous
    tensor of that shape and one of those dtypes on ``device``."""
    for name, (t, shape, dtypes) in want.items():
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be a {tuple(shape)} tensor, got "
                             f"{None if t is None else tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {device}")


@functools.lru_cache(maxsize=None)
def _table(kind: str, n: int, device: torch.device) -> torch.Tensor:
    """An int32 table the transform kernels read, on ``device``: the n x n
    fixed-point DCT matrix ("dct") or the diagonal scan's flat indices ("scan")."""
    a = dct_matrix_fixed(n) if kind == "dct" else diag_scan_indices(n)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


_I32, _BOOL = (torch.int32,), (torch.bool,)


# ------------------------------------------------ transform, RD split, quantization
def transform_select_plain(res_full, res_quads, sad_full, sad_quads, frame_type: int, qps_blocks, *, qp_nominal: int,
                           lam, vbs_enable: bool, vbs_eligible, bs: int, sbs: int, ok_full=None, ok_quads=None):
    """Plain PyTorch version of the ``transform_select`` kernel (any device):
    ``rd.transform_and_select``."""
    return rd.transform_and_select(res_full, res_quads, sad_full, sad_quads, frame_type, qps_blocks,
                                   qp_nominal=qp_nominal, lam=lam, vbs_enable=vbs_enable, vbs_eligible=vbs_eligible,
                                   bs=bs, sbs=sbs, ok_full=ok_full, ok_quads=ok_quads)


def transform_select(res_full, res_quads, sad_full, sad_quads, frame_type: int, qps_blocks, *, qp_nominal: int, lam,
                     vbs_enable: bool, vbs_eligible, bs: int, sbs: int, ok_full=None, ok_quads=None):
    """A frame step's residual coding: ``rd.transform_and_select``'s
    arguments and results (its docstring), in one launch.

    res_full: (nb, bs, bs) int32; sad_full, qps_blocks: (nb,) int32; ok_full
    (nb,) bool or None; under ``vbs_enable`` also res_quads (nb, 4, s, s)
    and sad_quads (nb, 4) int32, vbs_eligible (nb,) bool and ok_quads (nb,
    4) bool or None (s = bs / 2 = ``sbs``), which are unread otherwise.  All
    contiguous, on one device.  Returns (split (nb,) bool, qtc_full (nb, bs,
    bs) int32, qtc_quads (nb, 4, s, s) int32, zeros without VBS, lens (nb,)
    int32, mae (nb,) float32).  The kernel takes bs in {4, 8, 16} and
    ``lam`` as the float32 PyTorch rounds it to; the QPs must lie in [0, 12].
    Each SAD is at most 255 n^2 (n the block's or quad's size) wherever its
    ok flag is True or not given, as the searches make them: every MAE and
    their sums are then exact in float32, in any order of summation.
    """
    if not isinstance(res_full, torch.Tensor) or res_full.dim() != 3:
        raise ValueError("transform_select: res_full must be an (nb, bs, bs) tensor")
    nb, s = res_full.shape[0], bs // 2
    want = {"res_full": (res_full, (nb, bs, bs), _I32), "sad_full": (sad_full, (nb,), _I32),
            "qps_blocks": (qps_blocks, (nb,), _I32)}
    if ok_full is not None:
        want["ok_full"] = (ok_full, (nb,), _BOOL)
    if vbs_enable:
        if sbs != s:
            raise ValueError(f"transform_select: sbs={sbs} is not bs / 2 = {s}")
        want.update(res_quads=(res_quads, (nb, 4, s, s), _I32), sad_quads=(sad_quads, (nb, 4), _I32),
                    vbs_eligible=(vbs_eligible, (nb,), _BOOL))
        if ok_quads is not None:
            want["ok_quads"] = (ok_quads, (nb, 4), _BOOL)
    dev = res_full.device
    _check_tensors("transform_select", want, dev)
    if dev.type == "cpu":
        return transform_select_plain(res_full, res_quads, sad_full, sad_quads, frame_type, qps_blocks,
                                      qp_nominal=qp_nominal, lam=lam, vbs_enable=vbs_enable,
                                      vbs_eligible=vbs_eligible, bs=bs, sbs=sbs, ok_full=ok_full, ok_quads=ok_quads)
    if bs not in _TRANSFORM_SIZES:
        raise ValueError(f"the transform_select kernel takes bs in {_TRANSFORM_SIZES}, got {bs}")
    if vbs_enable and (lam is None or not 0 <= int(qp_nominal) <= 12):
        raise ValueError(f"transform_select under VBS needs lam and a nominal QP in [0, 12], got {lam}, {qp_nominal}")
    from streamoptima_tpu_torch._build import library

    split = torch.empty((nb,), dtype=torch.bool, device=dev)
    qtc_full = torch.empty((nb, bs, bs), dtype=torch.int32, device=dev)
    qtc_quads = torch.empty((nb, 4, s, s), dtype=torch.int32, device=dev)
    lens = torch.empty((nb,), dtype=torch.int32, device=dev)
    mae = torch.empty((nb,), dtype=torch.float32, device=dev)
    if nb == 0:
        return split, qtc_full, qtc_quads, lens, mae
    quads = (res_quads, sad_quads, ok_quads, vbs_eligible, _table("dct", s, dev), _table("scan", s, dev)) \
        if vbs_enable else (None,) * 6
    rq, sq, okq, elig, aq, scq = map(_ptr, quads)
    with torch.cuda.device(dev):
        rc = library().so_transform_select(res_full.data_ptr(), rq, sad_full.data_ptr(), sq, _ptr(ok_full), okq,
                                           qps_blocks.data_ptr(), elig, _table("dct", bs, dev).data_ptr(), aq,
                                           _table("scan", bs, dev).data_ptr(), scq, nb, bs, int(qp_nominal),
                                           float(lam) if vbs_enable else 0.0, int(frame_type), split.data_ptr(),
                                           qtc_full.data_ptr(), qtc_quads.data_ptr(), lens.data_ptr(), mae.data_ptr(),
                                           _stream(dev))
    _launch_check(rc, "transform_select")
    transform_select.launches += 1
    return split, qtc_full, qtc_quads, lens, mae


transform_select.launches = 0


# ------------------------------------------------ dequantization and reconstruction
def residual_recon_plain(qtc_full, qtc_quads, qps, pred=None, pred_quads=None, split=None, ok=None, sub_ok=None):
    """Plain PyTorch version of the ``residual_recon`` kernel (any device)."""
    rf = idct2_int(rescale(qtc_full.to(torch.int32), qps))
    rq = None if qtc_quads is None else idct2_int(rescale(qtc_quads.to(torch.int32), qp_minus_1(qps)[:, None]))
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


def residual_recon(qtc_full, qtc_quads, qps, pred=None, pred_quads=None, split=None, ok=None, sub_ok=None):
    """Dequantize a frame's coefficients, and for an inter frame reconstruct it.

    qtc_full: (nb, bs, bs) and, with VBS, qtc_quads (nb, 4, s, s), both
    int16 or both int32 (None without VBS); qps: (nb,) int32 block QPs (the
    quads take QP - 1, floored at 0).  Without ``pred`` (intra frames)
    returns (rf (nb, bs, bs), rq (nb, 4, s, s) or None), int32:
    ``idct2_int(rescale(...))``.  With ``pred``, the (h, w) int16 prediction
    plane of the blocks in raster order (and with VBS ``pred_quads``, the
    quads' plane, and ``split`` (nb,) bool): returns the (h, w) uint8
    reconstruction, each pixel (pred + residual) mod 256 from the quads
    where split; ``ok`` (nb,) and ``sub_ok`` (nb, 4) bool, if given, put 128
    in place of the prediction where False.  All contiguous, on one device.
    The kernel takes bs in {4, 8, 16}; the QPs must lie in [0, 12].
    """
    if not isinstance(qtc_full, torch.Tensor) or qtc_full.dim() != 3:
        raise ValueError("residual_recon: qtc_full must be an (nb, bs, bs) tensor")
    nb, bs = qtc_full.shape[0], qtc_full.shape[-1]
    s = bs // 2
    coef = (torch.int16, torch.int32)
    want = {"qtc_full": (qtc_full, (nb, bs, bs), coef), "qps": (qps, (nb,), _I32)}
    vbs = qtc_quads is not None
    if vbs:
        want["qtc_quads"] = (qtc_quads, (nb, 4, s, s), (qtc_full.dtype,))
    if pred is not None:
        h, w = pred.shape if pred.dim() == 2 else (0, 0)
        if h % bs or w % bs or (h // bs) * (w // bs) != nb:
            raise ValueError(f"residual_recon: a {tuple(pred.shape)} prediction plane does not hold {nb} blocks of "
                             f"{bs}")
        want["pred"] = (pred, (h, w), (torch.int16,))
        if ok is not None:
            want["ok"] = (ok, (nb,), _BOOL)
        if vbs:
            want.update(pred_quads=(pred_quads, (h, w), (torch.int16,)), split=(split, (nb,), _BOOL))
            if sub_ok is not None:
                want["sub_ok"] = (sub_ok, (nb, 4), _BOOL)
    dev = qtc_full.device
    _check_tensors("residual_recon", want, dev)
    if dev.type == "cpu":
        return residual_recon_plain(qtc_full, qtc_quads, qps, pred, pred_quads, split, ok, sub_ok)
    if bs not in _TRANSFORM_SIZES:
        raise ValueError(f"the residual_recon kernel takes bs in {_TRANSFORM_SIZES}, got {bs}")
    from streamoptima_tpu_torch._build import library

    rf = rq = out = None
    if pred is None:
        rf = torch.empty((nb, bs, bs), dtype=torch.int32, device=dev)
        rq = torch.empty((nb, 4, s, s), dtype=torch.int32, device=dev) if vbs else None
        nbc = 1
    else:
        out = torch.empty(pred.shape, dtype=torch.uint8, device=dev)
        nbc = pred.shape[1] // bs
    if nb:
        inter_q = (pred_quads, split, sub_ok) if pred is not None and vbs else (None,) * 3
        with torch.cuda.device(dev):
            rc = library().so_residual_recon(qtc_full.data_ptr(), _ptr(qtc_quads), int(qtc_full.dtype == torch.int32),
                                             qps.data_ptr(), _table("dct", bs, dev).data_ptr(),
                                             _ptr(_table("dct", s, dev)) if vbs else None, nb, nbc, bs, _ptr(rf),
                                             _ptr(rq), _ptr(pred), *map(_ptr, inter_q[:2]),
                                             _ptr(ok) if pred is not None else None, _ptr(inter_q[2]), _ptr(out),
                                             _stream(dev))
        _launch_check(rc, "residual_recon")
        residual_recon.launches += 1
    return (rf, rq) if pred is None else out


residual_recon.launches = 0


# ------------------------------------------------ intra search
def intra_search_plain(cur: torch.Tensor, bs: int, sr: int, canvas_w: int, vbs: bool, transpose: bool = False):
    """Plain PyTorch version of the ``intra_search`` kernel (any device)."""
    work = cur.to(torch.int32)
    if transpose:
        work = work.T
    s = I.intra_search_mode0(work, bs, sr, canvas_w, vbs)
    rf, rq = I.intra_residuals_mode0(work, s["mv"], bs, sr, s["sub_mv"] if vbs else None)
    if transpose:  # each block (and quad) as the frame holds it
        rf = rf.transpose(-1, -2)
        rq = None if rq is None else rq.transpose(-1, -2)
    return s, rf.contiguous(), None if rq is None else rq.contiguous()


def intra_search(cur: torch.Tensor, bs: int, sr: int, canvas_w: int, vbs: bool, transpose: bool = False):
    """Mode-0 intra search and residuals of the (h, w) uint8 frame ``cur``,
    or with ``transpose`` (intra mode 1) of its transpose.

    Returns (search, res_full, res_quads): ``intra.intra_search_mode0``'s
    dict on the searched frame (mv, sad (nbr, nbc) int32; with ``vbs``
    sub_mv, sub_sad (nbr, nbc, 4)), and ``intra.intra_residuals_mode0``'s
    (nb, bs, bs) and (nb, 4, s, s) int32 residuals at its MVs (None without
    ``vbs``); under ``transpose`` the blocks are numbered in the transposed
    frame's raster order and each residual block and quad is transposed,
    as the frame holds it.  ``canvas_w`` bounds the shifts (the searched
    frame's width, or the compat engine's canvas).  The kernel takes bs <= 32
    (even with ``vbs``) and 0 <= sr <= 127.  The plain version is
    ``intra_search_plain``.
    """
    if not isinstance(cur, torch.Tensor) or cur.dim() != 2:
        raise ValueError("intra_search: cur must be an (h, w) tensor")
    h, w = cur.shape
    _check_tensors("intra_search", {"cur": (cur, (h, w), (torch.uint8,))}, cur.device)
    if h % bs or w % bs:
        raise ValueError(f"intra_search: frame {h}x{w} is not a multiple of block size {bs}")
    if cur.device.type == "cpu":
        return intra_search_plain(cur, bs, sr, canvas_w, vbs, transpose)
    if not 1 <= bs <= 32 or (vbs and bs % 2) or not 0 <= sr <= 127:
        raise ValueError(f"the intra_search kernel takes 1 <= bs <= 32 (even under VBS) and 0 <= sr <= 127, got "
                         f"bs={bs}, sr={sr}")
    from streamoptima_tpu_torch._build import library

    dev = cur.device
    hh, ww = (w, h) if transpose else (h, w)
    nbr, nbc = hh // bs, ww // bs
    nb, s = nbr * nbc, bs // 2
    i32 = {"dtype": torch.int32, "device": dev}
    out = {"mv": torch.empty((nbr, nbc), **i32), "sad": torch.empty((nbr, nbc), **i32)}
    if vbs:
        out.update(sub_mv=torch.empty((nbr, nbc, 4), **i32), sub_sad=torch.empty((nbr, nbc, 4), **i32))
    rf = torch.empty((nb, bs, bs), **i32)
    rq = torch.empty((nb, 4, s, s), **i32) if vbs else None
    if nb:
        with torch.cuda.device(dev):
            rc = library().so_intra_search(cur.data_ptr(), h, w, int(transpose), bs, sr, canvas_w, int(vbs),
                                           out["mv"].data_ptr(), out["sad"].data_ptr(), _ptr(out.get("sub_mv")),
                                           _ptr(out.get("sub_sad")), rf.data_ptr(), _ptr(rq), _stream(dev))
        _launch_check(rc, "intra_search")
        intra_search.launches += 1
    return out, rf, rq


intra_search.launches = 0


# ------------------------------------------------ the container's run-length coding
#: int16 a block takes in a frame's header of ``rle_pack``'s buffer: split, mv (3), sub_mv (4 x 3), lengths (4)
RLE_HDR = 20


def rle_pack_layout(frames: int, nb: int) -> tuple[int, int]:
    """Where ``rle_pack``'s buffer holds the frames' headers and the symbols
    (int16 elements): (A, S0)."""
    a = 4 * frames + 4
    return a, a + RLE_HDR * nb * frames


def _rle_units(seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The diagonal-scan RLE of each row of ``seq`` (U, m), the coefficients
    in scan order: (symbols (U, 2m), each row's first ``length`` entries;
    lengths (U,) int64).  A nonzero's slot is the count of nonzeros before
    it plus the count of run starts up to it; a run's header takes the slot
    before its first position: -L for L nonzeros, the count of a zero run,
    0 for the trailing one."""
    u, m = seq.shape
    nz = seq != 0
    start = torch.ones_like(nz)
    start[:, 1:] = nz[:, 1:] != nz[:, :-1]
    nz_i, st_i = nz.to(torch.int64), start.to(torch.int64)
    runs = st_i.cumsum(1)
    slot = nz_i.cumsum(1) - nz_i + runs
    run = runs - 1
    run_len = torch.zeros_like(run).scatter_add_(1, run, torch.ones_like(run)).gather(1, run)
    last = run == runs[:, -1:] - 1
    head = torch.where(nz, -run_len, torch.where(last, 0, run_len))
    rows = torch.arange(u, device=seq.device)[:, None].expand(u, m)
    sym = torch.zeros((u, 2 * m), dtype=torch.int64, device=seq.device)
    sym[rows[nz], slot[nz]] = seq[nz].to(torch.int64)
    sym[rows[start], slot[start] - 1] = head[start]
    return sym, nz_i.sum(1) + st_i.sum(1)


def rle_pack_plain(split: list, mv: list, sub_mv: list, qtc_full: list, qtc_quads: list, cap: int) -> torch.Tensor:
    """Plain PyTorch version of the ``rle_pack`` kernel (any device)."""
    frames, nb = len(split), split[0].shape[0]
    n = qtc_full[0].shape[-1]
    s = n // 2
    a, s0 = rle_pack_layout(frames, nb)
    dev = split[0].device
    sp = torch.stack(split).to(torch.bool)
    m3 = torch.stack([torch.nn.functional.pad(t.reshape(nb, -1).to(torch.int64), (0, 3 - t.reshape(nb, -1).shape[1]))
                      for t in mv])
    s3 = torch.stack([torch.nn.functional.pad(t.reshape(nb, 4, -1).to(torch.int64),
                                              (0, 3 - t.reshape(nb, 4, -1).shape[2])) for t in sub_mv])
    m3 = torch.where(sp[..., None], 0, m3)
    s3 = torch.where(sp[..., None, None], s3, 0)
    bad = bool(((m3 < -32768) | (m3 > 32767)).any() or ((s3 < -32768) | (s3 > 32767)).any())
    sym_f, len_f = _rle_units(torch.stack(qtc_full).reshape(-1, n * n)[:, scan_indices(n, dev)])
    sym_q, len_q = _rle_units(torch.stack(qtc_quads).reshape(-1, s * s)[:, scan_indices(s, dev)])
    len_f = torch.where(sp, 0, len_f.reshape(frames, nb))
    len_q = torch.where(sp[..., None], len_q.reshape(frames, nb, 4), 0)
    tf, tq = len_f.sum(1), len_q.sum((1, 2))
    base = (tf + tq).cumsum(0) - (tf + tq) + s0
    flat_q = len_q.reshape(frames, -1)
    off_f = base[:, None] + len_f.cumsum(1) - len_f
    off_q = (base + tf)[:, None] + flat_q.cumsum(1) - flat_q

    out = torch.empty(s0 + cap, dtype=torch.int16, device=dev)
    out[: 4 * frames].view(torch.int32).copy_(torch.stack([tf, tq], 1).reshape(-1))
    hdr = out[a:s0].view(frames, RLE_HDR * nb)
    lens = torch.where(sp[..., None], len_q, torch.nn.functional.pad(len_f[..., None], (0, 3)))
    hdr.copy_(torch.cat([sp.to(torch.int64), m3.reshape(frames, -1), s3.reshape(frames, -1),
                         lens.reshape(frames, -1)], 1).to(torch.int16))
    over = False
    for sym, length, off in ((sym_f, len_f, off_f), (sym_q, len_q, off_q)):
        k = torch.arange(sym.shape[1], device=dev)
        keep = k < length.reshape(-1, 1)
        pos = off.reshape(-1, 1) + k
        fits = keep & (pos < s0 + cap)
        over = over or bool((keep & ~fits).any())
        out[pos[fits]] = sym[fits].to(torch.int16)
    out[4 * frames: a].view(torch.int32).copy_(torch.tensor([int(bad) | 2 * int(over), 0], dtype=torch.int32))
    return out


def rle_pack(split: list, mv: list, sub_mv: list, qtc_full: list, qtc_quads: list, cap: int) -> torch.Tensor:
    """The binary container's coding of F frames' chosen coefficients, with
    their split flags and MVs, into one int16 buffer.

    Per frame (lists of F tensors, on one device): split (nb,) bool; mv
    (nb,) int32 (an intra frame's scalar MVs) and sub_mv (nb, 4), or (nb, 3)
    and (nb, 4, 3) int32; qtc_full (nb, bs, bs) and qtc_quads (nb, 4, s, s)
    int16, s = bs / 2.  All contiguous.  A block codes the variant it uses:
    unsplit, its full block's diagonal-scan RLE list; split, its four
    quads', Z order (``core/zigzag.rle_encode_block``'s symbols).  ``cap``:
    the symbols' room, the frames' coded lengths summed.  Returns the
    buffer of S0 + cap int16 (``rle_pack_layout``):

    - [0, 4F): per frame the symbol counts of its unsplit and of its split
      blocks, two int32;
    - [4F, A): int32 error bits, then 0: bit 0, an MV or a split block's
      sub-MV outside int16 (stored truncated); bit 1, symbols past ``cap``
      (dropped);
    - [A, S0): per frame 20 nb int16: split (0 / 1), mv (nb, 3; a split
      block's zero, an intra frame's in component 0), sub_mv (nb, 4, 3; an
      unsplit block's zero), the unit lengths (nb, 4; unsplit (L, 0, 0, 0));
    - [S0, S0 + cap): the symbols, frame after frame, each frame's unsplit
      blocks' lists in raster order and then its split blocks' quad lists:
      the container's vals_f and vals_q.

    The kernel takes bs in {4, 8, 16} and at most 65535 frames: two launches
    (the count, then the write), after a zeroing of [0, A).  The plain
    version is ``rle_pack_plain``.
    """
    frames = len(split)
    if frames == 0 or not all(len(x) == frames for x in (mv, sub_mv, qtc_full, qtc_quads)):
        raise ValueError("rle_pack: give one split, mv, sub_mv, qtc_full and qtc_quads tensor for each of >= 1 frames")
    if not isinstance(qtc_full[0], torch.Tensor) or qtc_full[0].dim() != 3:
        raise ValueError("rle_pack: qtc_full must hold (nb, bs, bs) tensors")
    nb, bs = qtc_full[0].shape[0], qtc_full[0].shape[-1]
    s = bs // 2
    dev = qtc_full[0].device
    ncomp = []
    for i in range(frames):
        one = isinstance(mv[i], torch.Tensor) and mv[i].dim() == 1
        ncomp.append(1 if one else 3)
        tail = () if one else (3,)
        _check_tensors("rle_pack", {"split": (split[i], (nb,), _BOOL), "mv": (mv[i], (nb,) + tail, _I32),
                                    "sub_mv": (sub_mv[i], (nb, 4) + tail, _I32),
                                    "qtc_full": (qtc_full[i], (nb, bs, bs), (torch.int16,)),
                                    "qtc_quads": (qtc_quads[i], (nb, 4, s, s), (torch.int16,))}, dev)
    if cap < 0:
        raise ValueError(f"rle_pack: cap must be >= 0, got {cap}")
    if dev.type == "cpu":
        return rle_pack_plain(split, mv, sub_mv, qtc_full, qtc_quads, cap)
    if bs not in _TRANSFORM_SIZES or frames > 65535:
        raise ValueError(f"the rle_pack kernel takes bs in {_TRANSFORM_SIZES} and at most 65535 frames, got bs={bs}, "
                         f"{frames} frames")
    from streamoptima_tpu_torch._build import library

    _, s0 = rle_pack_layout(frames, nb)
    out = torch.empty(s0 + cap, dtype=torch.int16, device=dev)
    table = np.array([[t.data_ptr() for t in (split[i], mv[i], sub_mv[i], qtc_full[i], qtc_quads[i])] + [ncomp[i]]
                      for i in range(frames)], dtype=np.int64)
    table = to_device(table, dev, "rle_table", pinned=True)  # queued behind the encode, no wait
    with torch.cuda.device(dev):
        rc = library().so_rle_pack(table.data_ptr(), frames, nb, bs, _table("scan", bs, dev).data_ptr(),
                                   _table("scan", s, dev).data_ptr(), out.data_ptr(), out.numel(), _stream(dev))
    _launch_check(rc, "rle_pack")
    rle_pack.launches += 2
    return out


#: kernel launches: two a call (the count and the write)
rle_pack.launches = 0


# ------------------------------------------------ the container's run-length decoding
def rle_unpack_head(frames: int, nb: int) -> int:
    """Bytes of ``rle_unpack``'s buffer before the container's fields: the
    frames' table and the blocks' unit indices."""
    return 32 * frames + 4 * frames * nb


def rle_unpack_plain(buf: torch.Tensor, frames: int, nb: int, bs: int) -> torch.Tensor:
    """Plain PyTorch version of the ``rle_unpack`` kernel (any device): every
    unit's walk in step, one header of each unit still walking at a time."""
    dev, nn, s = buf.device, bs * bs, bs // 2
    b = buf.to(torch.int64)
    tab = buf[: 32 * frames].view(torch.int64).reshape(frames, 4)
    index = buf[32 * frames: rle_unpack_head(frames, nb)].view(torch.int32).reshape(frames, nb).to(torch.int64)

    def u32(pos):
        return b[pos] | b[pos + 1] << 8 | b[pos + 2] << 16 | b[pos + 3] << 24

    def i16(pos):
        v = b[pos] | b[pos + 1] << 8
        return v - (v >> 15 << 16)

    # the units: each unsplit block, then each split block's four quads; where each list starts, its length,
    # its positions and its slot
    f_u, b_u = torch.nonzero(index >= 0, as_tuple=True)
    at = tab[f_u, 0] + 4 * index[f_u, b_u]
    o0, o1 = u32(at), u32(at + 4)
    f_q, b_q = torch.nonzero(index < 0, as_tuple=True)
    q = torch.arange(4, device=dev)
    at = tab[f_q, 2][:, None] + 4 * (4 * ~index[f_q, b_q][:, None] + q)
    p0, p1 = u32(at), u32(at + 4)
    start = torch.cat([tab[f_u, 1] + 2 * o0, (tab[f_q, 3][:, None] + 2 * p0).reshape(-1)])
    length = torch.cat([o1 - o0, (p1 - p0).reshape(-1)])
    m = torch.cat([torch.full_like(o0, nn), torch.full_like(p0.reshape(-1), s * s)])
    slot = torch.cat([(f_u * nb + b_u) * nn, ((f_q * nb + b_q) * nn)[:, None].expand(-1, 4).reshape(-1)])
    kind = torch.cat([torch.zeros_like(o0), (q + 1).expand(f_q.numel(), 4).reshape(-1)])
    # each kind's slot element of a scan position: the block's, then quad q's in its (q // 2, q % 2) tile
    sq = scan_indices(s, dev)
    dst = torch.zeros((5, nn), dtype=torch.int64, device=dev)
    dst[0] = scan_indices(bs, dev)
    for k in range(4):
        dst[k + 1, : s * s] = ((k // 2) * s + sq // s) * bs + (k % 2) * s + sq % s

    out = torch.zeros(frames * nb * nn, dtype=torch.int16, device=dev)
    i, pos = torch.zeros_like(length), torch.zeros_like(length)
    live = torch.nonzero(length > 0).reshape(-1)
    while live.numel():
        ln, il, sl, ml = length[live], i[live], pos[live], m[live]
        c = i16(start[live] + 2 * il)
        neg = c < 0
        run = torch.minimum(-c, ln - il)
        cnt = torch.where(neg, torch.minimum(torch.minimum(run, ln - il - 1), ml - sl), 0)
        width = int(cnt.max())
        if width > 0:
            u, k = torch.nonzero(torch.arange(width, device=dev) < cnt[:, None], as_tuple=True)
            g = live[u]
            out[slot[g] + dst[kind[g], sl[u] + k]] = i16(start[g] + 2 * (il[u] + 1 + k)).to(torch.int16)
        sl = sl + torch.where(neg, cnt, torch.where(c > 0, torch.minimum(c, ml), 0))
        il = il + torch.where(neg, run, 0) + 1
        i[live], pos[live] = il, sl
        live = live[(c != 0) & (il < ln) & (sl < ml)]
    return out.reshape(frames, nb, bs, bs)


def rle_unpack(buf: torch.Tensor, frames: int, nb: int, bs: int) -> torch.Tensor:
    """The container's coefficient lists of F frames of nb blocks, run-length
    decoded into the decoders' merged payload: (F, nb, bs, bs) int16, an
    unsplit block's slot its coefficients, a split block's its four quads as
    its 2 x 2 tiles (``engine.pack_stream``'s payload, ``unpack_payload``'s
    input).

    ``buf``: a contiguous uint8 tensor, 16-byte aligned, laid out as
    ``csrc/rle_unpack.cu`` says: per frame four int64, the byte positions of
    the container's offs_f, vals_f, offs_q and vals_q fields (each at an
    even position); the (F, nb) int32 unit index of each
    block (r >= 0, the r-th unsplit block of its frame; r < 0, the ~r-th
    split block); then the fields (``rle_unpack_head``).  The fields'
    offsets must start at 0, never fall and end at their value count, and
    every position lie inside ``buf``: the container's reader checks them
    (``binstream.read_binary``), this wrapper does not.  Each unit's list
    decodes as ``native/entropy.cpp`` ``rle_decode_blocks``, adversarial
    lists included.  The kernel takes bs in {4, 8, 16}: one launch.  The
    plain version is ``rle_unpack_plain``.
    """
    if not isinstance(buf, torch.Tensor) or buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("rle_unpack: buf must be a contiguous 1-D uint8 tensor")
    if frames < 1 or nb < 1 or buf.numel() < rle_unpack_head(frames, nb):
        raise ValueError(f"rle_unpack: {buf.numel()} bytes hold no table of {frames} frames of {nb} blocks")
    dev = buf.device
    if dev.type == "cpu":
        return rle_unpack_plain(buf, frames, nb, bs)
    if dev.type != "cuda":
        raise ValueError(f"rle_unpack runs on cpu or cuda tensors, not {dev}")
    if bs not in _TRANSFORM_SIZES or buf.data_ptr() % 16:
        raise ValueError(f"the rle_unpack kernel takes bs in {_TRANSFORM_SIZES} and a 16-byte aligned buffer, got "
                         f"bs={bs}")
    from streamoptima_tpu_torch._build import library

    out = torch.empty((frames, nb, bs, bs), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        rc = library().so_rle_unpack(buf.data_ptr(), frames, nb, bs, _table("scan", bs, dev).data_ptr(),
                                     _table("scan", bs // 2, dev).data_ptr(), out.data_ptr(), _stream(dev))
    _launch_check(rc, "rle_unpack")
    rle_unpack.launches += 1
    return out


#: kernel launches: one a call
rle_unpack.launches = 0
