"""The motion layer: which search, fetch and fast-ME kernels a tool set
launches, and on which planes.

One ``Motion`` per engine (``TorchCodec``, each mesh tile's, ``CompatCodec``)
makes the choice that FME x VBS x fast ME makes among ``core/kernels.py``'s
wrappers, and is the only caller of the search (``full_search*``), fetch
(``pred_fetch*``), ``window_fetch``, ``fast_confirm`` and ``rowscan_pass``
wrappers.  Built with ``rows``, it codes a band of whole block rows of the
frame (a mesh tile): its kernels take the reference band that holds those
rows at ``band_row0`` and evaluate every bound at frame rows.  The engines
keep what is their own: the native engine's 128 prediction of a block
without a valid candidate, the compat engine's MAE and K18 quad margin.
"""
from __future__ import annotations

import torch

from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.core import fastme as FM
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core.me import block_origins, fme_parity_planes, valid_candidates
from streamoptima_tpu_torch.profiling import host_flag, traced, tracer


class Motion:
    """The search, fetch and fast-ME kernels of ``cfg``'s tool set, for the
    frame rows ``rows`` (default: the whole frame) on ``device``."""

    def __init__(self, cfg: CodecConfig, device, rows: tuple[int, int] | None = None):
        self.device = torch.device(device)
        self.bs, self.sr = cfg.block_size, cfg.search_range
        self.fme, self.vbs = cfg.fme_enable, cfg.vbs_enable
        self.H, self.w = cfg.height, cfg.width
        self.g_row0, r1 = (0, self.H) if rows is None else rows
        self.h = r1 - self.g_row0
        bx, by = block_origins(self.h, self.w, self.bs, self.device)
        self.bx, self.by = bx.to(torch.int32), by.to(torch.int32)  # by: within these rows
        #: the full-search wrapper, looked up in ``core.kernels`` at each call
        self.search_name = "full_search" + "_fme" * self.fme + "_vbs" * self.vbs

    def planes(self, frames: list, flat=False) -> torch.Tensor:
        """What the searches and fetches read of the reference ``frames``: the
        (nref, 4, h, w) parity planes under FME, else the (nref, h, w) stack.
        ``flat`` (one bool, or one per reference): the all-128 plane's row
        pass does not wrap (quirk K17)."""
        if not self.fme:
            return torch.stack(frames)
        flats = [flat] * len(frames) if isinstance(flat, bool) else list(flat)
        if len(set(flats)) == 1:
            return fme_parity_planes(torch.stack(frames), wrap_row_pass=not flats[0])
        return torch.cat([fme_parity_planes(f[None], wrap_row_pass=not fl) for f, fl in zip(frames, flats)])

    def _band(self, band_row0: int) -> dict:
        """The kernels' band arguments: these rows at ``band_row0`` of the
        references (0 for whole frames)."""
        return {"band_row0": band_row0, "g_row0": self.g_row0, "grid": (self.H, self.w)}

    def search(self, cur: torch.Tensor, planes: torch.Tensor, band_row0: int = 0):
        """One full-search launch: its outputs and the winners' planes
        (``fetch``'s).  A block or quad without a valid candidate (``ok`` /
        ``sub_ok`` False) has mv (0, 0, 0), and zeros there in the whole-pel
        search's plane."""
        with tracer.span("engine.search"):
            if tracer.on:  # from the shapes alone: no sync
                tracer.set("refs", planes.shape[0])
                tracer.search_positions[self.search_name] += planes.shape[0] * valid_candidates(
                    self.h, self.w, self.bs, self.sr, fme=self.fme, vbs=self.vbs, row0=self.g_row0, H=self.H)
            s = getattr(K, self.search_name)(cur, planes, self.sr, self.bs, **self._band(band_row0))
            if self.search_name == "full_search":  # returns the winners' pixels itself
                return s, s["pred"], None
            return (s, *self.fetch(s["mv"], s.get("sub_mv"), planes, band_row0))

    @traced("engine.fetch")
    def fetch(self, mv, sub_mv, planes, band_row0: int = 0, quad_margin: int | None = None):
        """Each block's, and under VBS each quad's, prediction plane at the
        given MVs: (h, w) int16 each (the quads' None without VBS).
        ``quad_margin``: the FME quads' margin (default their own size; the
        compat engine's reconstruction passes the block size, K18)."""
        band = self._band(band_row0)
        if self.vbs and self.fme:
            return K.pred_fetch_fme_vbs(mv, sub_mv, planes, self.bs, quad_margin=quad_margin, **band)
        if self.vbs:
            return K.pred_fetch_vbs(mv, sub_mv, planes, self.bs, **band)
        return (K.pred_fetch_fme if self.fme else K.pred_fetch)(mv, planes, self.bs, **band), None

    @traced("engine.confirm")
    def confirm(self, cur_blocks: torch.Tensor, planes: torch.Tensor, g: torch.Tensor) -> dict:
        """The fast-ME 3x3 searches around MVPs ``g`` (nb, 3), block and
        quads: one ``window_fetch`` of every block's region of the
        whole-frame ``planes``, one ``fast_confirm`` over those regions."""
        n, fme = self.bs, self.fme
        y = self.by + self.g_row0
        by0, bx0 = FM.region_base(g, y, self.bx, fme)
        win = K.window_fetch(planes.reshape(-1, self.H, self.w), by0, bx0, n + 2)
        scale = 2 if fme else 1
        dims = (2 * self.H - 1, 2 * self.w - 1) if fme else (self.H, self.w)
        return K.fast_confirm(win, cur_blocks, g, scale * self.bx, scale * y, n, dims, fme, self.vbs)

    def fast_search(self, cur: torch.Tensor, cur_blocks: torch.Tensor, planes: torch.Tensor,
                    g0: torch.Tensor | None) -> tuple[dict, int]:
        """One frame's fast ME on these rows alone (``JaxCodec._fast_search_rowscan``):
        ``fast_chain`` from ``g0``, then the confirm at the converged MVPs,
        which re-derives the same MVs.  Returns the confirm's outputs, with
        the MVPs under "g_next", and the chain's passes."""
        (g,), passes = fast_chain([self], [cur], [planes], [g0])
        out = self.confirm(cur_blocks, planes, g)
        out["g_next"] = g
        return out, passes


@traced("engine.fast_chain")
def fast_chain(tiles: list, curs: list, planes: list, g0s: list) -> tuple[list, int]:
    """Solve one frame's fast-ME MVP chain over its tiles, top to bottom
    (``JaxCodec._fast_search_rowscan``; on a mesh ``_fast_tile_rowscan``).

    ``tiles``: the frame's tiles' ``Motion`` (one for the whole frame),
    each with its rows of the frame in ``curs``, the whole frame's
    ``planes`` on its device and the previous frame's converged MVPs or None
    in ``g0s``.  Each pass launches ``rowscan_pass`` once per tile: every
    block row is solved exactly from its seed.  The next seeds are the
    frame's rows' last MVs shifted down one row: within a tile the row
    above's, for a tile's first row the last MV of the tile above, copied
    across devices (tile 0's first row: zero).  The chain's solution is the
    one fixpoint of that map, so any start gives it; ``g0s`` only save
    passes.  Convergence is tested on the frame's whole seed vector, one flag
    read per pass.  (The JAX mesh tests it over the whole mesh, since its
    seed exchange is one SPMD collective for every data row; here data rows
    run in turn, so the frame's own test is the one that applies, and with
    a unique fixpoint the MVs are the same.)  At most the frame's block rows
    + 2 passes, the JAX bound.  Returns (each tile's (nb_t, 3) converged
    MVPs, the passes)."""
    e0 = tiles[0]
    bs, fme, fh, nbc = e0.bs, e0.fme, e0.H, e0.w // e0.bs
    zeros = [torch.zeros((1, 3), dtype=torch.int32, device=e.device) for e in tiles]
    seeds = [z.expand(e.h // bs, 3).contiguous() if g is None else g.reshape(-1, nbc, 3)[:, 0].contiguous()
             for e, z, g in zip(tiles, zeros, g0s)]
    passes, changed = 0, True
    while changed and passes <= fh // bs + 1:
        mvs = [K.rowscan_pass(c, p, s, bs, fme, g_row0=e.g_row0, grid=(e.H, e.w))
               for e, c, p, s in zip(tiles, curs, planes, seeds)]
        passes += 1
        nxt = [torch.cat([z if t == 0 else mvs[t - 1][-1, -1:].to(e.device), m[:-1, -1]])
               for t, (e, z, m) in enumerate(zip(tiles, zeros, mvs))]
        changed = host_flag(torch.stack([(a != b).any().to(e0.device) for a, b in zip(nxt, seeds)]).any(),
                            "chain_flag")
        seeds = nxt
    # each block's MVP: the MV before it in raster order, a tile's first the converged seed
    gs = [torch.cat([s[:1], m.reshape(-1, 3)[:-1]]) for s, m in zip(seeds, mvs)]
    tracer.set("passes", passes)
    return gs, passes
