"""The plain reference encoder: a segment's container bytes and reconstructions.

A frozen copy of the native engine's single-device encode loop (the port's
``engine.TorchCodec``: its intra and inter steps, the fast-ME chain and
confirm, the reference FIFO) over the plain kernels of ``plain.py``, for
intra mode 0, one to eight references, VBS and half-pel FME each on or off,
full search or fast ME, at a constant QP or under rate control (``rc.py``):

- ``rc_flag`` >= 1: every block takes its row's QP, from the rate table of
  the frame's type, and the container carries each frame's row QPs;
- ``rc_flag`` > 1, scene-change promotion (Encoder.py:1851-1856): an inter
  frame whose coded length, the sum of its blocks' RLE lengths, exceeds
  ``intra_thresh`` is coded again as an intra frame, which empties the
  reference FIFO as any intra frame does;
- ``two_pass``: pass 1 codes the segment at the table QPs and decides the
  promotions, pass 2 codes it again with pass 1's frame types and the row
  QPs ``rc.second_pass_row_qps`` gives from pass 1's bits of each row.

ROI maps, the parallel modes, intra mode 1 and the compat engine are
refused: no configuration here states them.

``encode`` takes the segment's frames as the benchmark generated them and
works out everything the program derives again: it shares nothing with the
program but the frames.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fastme as FM
from . import plain as P
from . import rc
from .blocks import blockify, quads_px, split_quads
from .container import write_container
from .me import block_origins, fme_parity_planes

#: CodecConfig fields this encoder reads; any other field must keep the default the encoder assumes
_REFUSED = {"roi_qp_map": None, "parallel_mode": 0, "intra_mode": 0, "engine": "jax"}


class ReferenceEncoder:
    """Encodes segments of one configuration (a dict of ``CodecConfig``
    fields) on ``device``.  ``control=True`` is the benchmark's
    lower-precision control: the transforms in float32 (``transform.py``)."""

    def __init__(self, cfg: dict, device, control: bool = False):
        for key, default in _REFUSED.items():
            if cfg.get(key, default) != default:
                raise ValueError(f"the reference encoder does not run {key}={cfg[key]!r}")
        self.h, self.w, self.frames = int(cfg["height"]), int(cfg["width"]), int(cfg["frames"])
        self.bs = int(cfg.get("block_size", 16))
        self.sbs = self.bs // 2
        self.sr = int(cfg.get("search_range", 16))
        self.qp = int(cfg.get("qp", 4))
        self.intra_dur = int(cfg.get("intra_dur", 21))
        self.vbs = bool(cfg.get("vbs_enable", False))
        self.fme = bool(cfg.get("fme_enable", False))
        self.fast = bool(cfg.get("fast_me", False))
        self.nref = int(cfg.get("n_ref_frames", 1))
        lam = cfg.get("lam")
        self.lam = 0.015 if lam is None and self.vbs else lam
        self.device = torch.device(device)
        self.control = control
        self.nbr, self.nbc = self.h // self.bs, self.w // self.bs
        self.nb = self.nbr * self.nbc
        rc_flag = cfg.get("rc_flag")
        self.rc = rc_flag is not None and rc_flag > 0
        self.promote = self.rc and rc_flag > 1
        self.two_pass = bool(cfg.get("two_pass", False))
        if self.two_pass and not self.rc:
            raise ValueError("two_pass needs rate control (rc_flag > 0)")
        self.intra_thresh = cfg.get("intra_thresh")
        if self.promote and self.intra_thresh is None:
            raise ValueError("scene-change promotion (rc_flag > 1) needs intra_thresh")
        if self.rc:
            if cfg.get("target_br") is None or cfg.get("qp_rate_tables") is None:
                raise ValueError("rate control (rc_flag > 0) needs target_br and qp_rate_tables")
            fps = int(cfg.get("frame_rate", 30))
            self.tables = [list(cfg["qp_rate_tables"][t]) for t in (0, 1)]
            self.frame_budget = rc.parse_bitrate(cfg["target_br"]) // fps
            per_row = rc.bitrate_per_row(cfg["target_br"], fps, self.h, self.bs)
            #: each frame type's row QPs (intra, inter)
            self.table_rows = [rc.row_qps(table, per_row, self.nbr) for table in self.tables]
        else:
            self.table_rows = [[self.qp] * self.nbr] * 2
        self.table_qps = [self._block_qps(rows) for rows in self.table_rows]
        border = torch.zeros((self.nbr, self.nbc), dtype=torch.bool, device=self.device)
        border[0, :] = True
        border[:, 0] = True
        self.vbs_eligible = ~border.reshape(-1)
        bx, by = block_origins(self.h, self.w, self.bs, self.device)
        self.bx, self.by = bx.to(torch.int32), by.to(torch.int32)

    # ------------------------------------------------------------ steps
    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _block_qps(self, rows) -> torch.Tensor:
        """(nb,) int32 block QPs in raster order: each block its row's QP."""
        q = torch.as_tensor(rows, dtype=torch.int32, device=self.device)
        return q[:, None].expand(self.nbr, self.nbc).reshape(-1).contiguous()

    def _select(self, res_full, res_quads, sad, sub_sad, ftype: int, qps, ok=None, sub_ok=None):
        return P.transform_select(res_full, res_quads, sad, sub_sad, ftype, qps, qp_nominal=self.qp,
                                  lam=self.lam, vbs_enable=self.vbs, vbs_eligible=self.vbs_eligible, bs=self.bs,
                                  sbs=self.sbs, ok_full=ok, ok_quads=sub_ok, control=self.control)

    def _intra_step(self, cur: torch.Tensor, qps: torch.Tensor) -> dict:
        s, res_full, res_quads = P.intra_search(cur, self.bs, self.sr, self.w, self.vbs)
        sub_sad = s["sub_sad"].reshape(self.nb, 4) if self.vbs else None
        split, qtc_full, qtc_quads, lens, _ = self._select(res_full, res_quads, s["sad"].reshape(-1), sub_sad, 0, qps)
        mv = s["mv"].reshape(-1)
        sub_mv = s["sub_mv"].reshape(self.nb, 4) if self.vbs else self._zeros(self.nb, 4)
        rf, rq = P.residual_recon(qtc_full, qtc_quads if self.vbs else None, qps, control=self.control)
        recon = P.intra_recon(rf, mv, self.h, self.w, self.bs, self.sr, rq, split, sub_mv)
        return {"mv": mv, "sub_mv": sub_mv, "split": split, "qtc_full": qtc_full, "qtc_quads": qtc_quads,
                "recon": recon, "lens": lens}

    def _fetch(self, mv, sub_mv, planes):
        if self.vbs:
            return (P.pred_fetch_fme_vbs if self.fme else P.pred_fetch_vbs)(mv, sub_mv, planes, self.bs)
        return (P.pred_fetch_fme if self.fme else P.pred_fetch)(mv, planes, self.bs), None

    def _full_search(self, cur, planes):
        if not (self.vbs or self.fme):
            s = P.full_search(cur, planes, self.sr, self.bs)
            return s, s["pred"], None
        search = {(False, True): P.full_search_vbs, (True, False): P.full_search_fme,
                  (True, True): P.full_search_fme_vbs}[self.fme, self.vbs]
        s = search(cur, planes, self.sr, self.bs)
        return (s, *self._fetch(s["mv"], s.get("sub_mv"), planes))

    def _chain(self, cur, planes, g0):
        """The fast-ME MVP chain of one frame, solved per block row from
        guessed seeds until they stop changing; returns (MVPs (nb, 3), passes)."""
        zero = self._zeros(1, 3)
        seeds = zero.expand(self.nbr, 3).contiguous() if g0 is None else \
            g0.reshape(self.nbr, self.nbc, 3)[:, 0].contiguous()
        passes, changed = 0, True
        while changed and passes <= self.h // self.bs + 1:
            mvs = FM.rowscan_pass_plain(cur, planes, seeds, self.bs, self.fme, grid=(self.h, self.w))
            passes += 1
            nxt = torch.cat([zero, mvs[:-1, -1]])
            changed = bool((nxt != seeds).any())
            seeds = nxt
        return torch.cat([seeds[:1], mvs.reshape(-1, 3)[:-1]]), passes

    def _confirm(self, cur_blocks, planes, g) -> dict:
        n, fme = self.bs, self.fme
        by0, bx0 = FM.region_base(g, self.by, self.bx, fme)
        win = FM.window_fetch_plain(planes.reshape(-1, self.h, self.w), by0, bx0, n + 2)
        scale = 2 if fme else 1
        dims = (2 * self.h - 1, 2 * self.w - 1) if fme else (self.h, self.w)
        return FM.confirm(win, cur_blocks, g, scale * self.bx, scale * self.by, n, dims, fme, self.vbs)

    def _inter_step(self, cur, planes, g0, qps: torch.Tensor) -> dict:
        cur_blocks = blockify(cur, self.bs).to(torch.int32)
        g_next = None
        if self.fast:
            g_next, _ = self._chain(cur, planes, g0)
            s = self._confirm(cur_blocks, planes, g_next)
            pf, pq = self._fetch(s["mv"], s.get("sub_mv"), planes)
            ok, sub_ok = None, None
        else:
            s, pf, pq = self._full_search(cur, planes)
            ok, sub_ok = s["ok"], s.get("sub_ok")
        pred_full = blockify(pf, self.bs).to(torch.int32)
        if ok is not None:
            pred_full = torch.where(ok[:, None, None], pred_full, 128)
        res_q = None
        if self.vbs:
            pred_q = quads_px(pq, self.bs).to(torch.int32)
            if sub_ok is not None:
                pred_q = torch.where(sub_ok[:, :, None, None], pred_q, 128)
            res_q = (split_quads(cur_blocks) - pred_q).contiguous()
        split, qtc_full, qtc_quads, lens, _ = self._select((cur_blocks - pred_full).contiguous(), res_q, s["sad"],
                                                           s.get("sub_sad"), 1, qps, ok=s["ok"], sub_ok=s.get("sub_ok"))
        recon = P.residual_recon(qtc_full, qtc_quads if self.vbs else None, qps, pf, pq,
                                 split if self.vbs else None, ok, sub_ok, control=self.control)
        sub_mv = s["sub_mv"] if self.vbs else self._zeros(self.nb, 4, 3)
        return {"mv": s["mv"], "sub_mv": sub_mv, "split": split, "qtc_full": qtc_full, "qtc_quads": qtc_quads,
                "recon": recon, "lens": lens, "g_next": g_next}

    # ------------------------------------------------------------ encode
    def _pass(self, y: torch.Tensor, ftypes_fixed: list | None = None, rqps: list | None = None):
        """One pass over the segment: (frame types, per-frame numpy outputs).
        ``ftypes_fixed`` and ``rqps``, two-pass's second pass: pass 1's frame
        types (no promotion is decided) and each frame's row QPs."""
        refs = [torch.full((self.h, self.w), 128, dtype=torch.uint8, device=self.device)]
        initial = True
        g_carry = None
        ftypes, outs = [], []
        for i in range(self.frames):
            qps = self.table_qps if rqps is None else [self._block_qps(rqps[i])] * 2
            if (i % self.intra_dur == 0) if ftypes_fixed is None else ftypes_fixed[i] == 0:
                out, ftype = self._intra_step(y[i], qps[0]), 0
            else:
                stack = torch.stack(refs)
                planes = fme_parity_planes(stack, wrap_row_pass=not initial) if self.fme else stack
                out, ftype = self._inter_step(y[i], planes, g_carry, qps[1]), 1
                if self.promote and ftypes_fixed is None and int(out["lens"].sum()) > self.intra_thresh:
                    # the promoted frame's MVPs are dropped: they seed the next chain, whose result they cannot move
                    out, ftype = self._intra_step(y[i], qps[0]), 0
                elif out["g_next"] is not None:
                    g_carry = out["g_next"]
            ftypes.append(ftype)
            outs.append({k: v.cpu().numpy() for k, v in out.items() if k != "g_next" and v is not None})
            if i < self.frames - 1:
                if ftype == 0:
                    refs = []
                if len(refs) >= self.nref:
                    refs.pop(0)
                refs.append(out["recon"])
                initial = False
        return ftypes, outs

    def encode(self, frames: np.ndarray) -> tuple[bytes, np.ndarray]:
        """Encode one segment, (frames, h, w) uint8 on the host.  Returns the
        SOTPB1 container's bytes and the (frames, h, w) uint8 reconstructions."""
        frames = np.asarray(frames, dtype=np.uint8)
        if frames.shape != (self.frames, self.h, self.w):
            raise ValueError(f"a segment is {(self.frames, self.h, self.w)}, got {frames.shape}")
        y = torch.from_numpy(frames).to(self.device)
        ftypes, outs = self._pass(y)
        rows = [self.table_rows[t] for t in ftypes]
        if self.two_pass:
            rows = [rc.second_pass_row_qps(o["lens"].reshape(self.nbr, self.nbc).sum(axis=1), self.tables[t],
                                           self.frame_budget, self.table_rows[t]) for t, o in zip(ftypes, outs)]
            ftypes, outs = self._pass(y, ftypes, rows)
        recon = np.stack([o["recon"] for o in outs])
        return write_container(self.h, self.w, self.bs, ftypes, outs, rows if self.rc else None), recon
