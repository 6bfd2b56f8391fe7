"""PyTorch engine: per-frame encode/decode steps on one device.

``TorchCodec`` is the counterpart of ``streamoptima_tpu.jax_engine.JaxCodec``
on one device, for every configuration of the native engine: I/P frames (an
intra frame every ``intra_dur``), up to eight reference frames in a FIFO,
intra mode 0 or 1 (mode 1 is mode 0 on the transposed frame), VBS and
half-pel FME each on or off, full search or fast ME, the three parallel
modes' semantics, and rate control.

An inter frame's search and prediction fetch are the kernels
``core/motion.py`` chooses for the tool set (one full-search launch, or fast
ME's chain and confirm, and ``pred_fetch`` in the matching mode).  Every
intra frame, in encode and decode and in either intra mode, is
reconstructed by one launch of the ``intra_recon`` kernel.

The residual coding is three kernels a frame: ``intra_search`` (an intra
frame's search and residuals, either intra mode), ``transform_select``
(every encoded frame's DCT, RD split, quantization and coded lengths) and
``residual_recon`` (every encoded and decoded frame's dequantization; an
inter frame's reconstruction from the prediction planes in the same
launch).  A decode uploads its stream once (``upload_stream``); a binary
container's coefficient lists go in undecoded, from a pinned stage the
decoder keeps, and one ``rle_unpack`` launch writes their payload.

Fast ME (``fast_me``: a 3x3 search around the previous block's MV, chained
in raster order) solves the chain per block row (``motion.fast_chain``: the
``rowscan_pass`` kernel walks every row exactly from a guessed seed MV, and
the seeds are iterated until they stop changing, starting from the previous
frame's), then confirms at the converged MVPs (``Motion.confirm``:
``window_fetch`` and ``fast_confirm``).  Decode is the same as for the full
search: a fast-ME stream is an ordinary MV stream.

Parallel modes (the reference's multiprocessing modes, run in order on one
device): mode 1 codes every frame as an inter frame against the all-128
plane, by full search; mode 2 runs fast ME from a zero MVP for every block
(no chain: one confirm pass at g = 0); mode 3 keeps the intra frames and
predicts every inter frame from the all-128 plane.

Rate control (``rc``): per-row QPs from the rate table of the frame's type
(``rc_flag`` >= 1), an ROI map of per-block QP offsets (``roi_qp_map``,
clipped to [0, 12]), scene-change promotion (``rc_flag`` > 1: an inter
frame whose size exceeds ``intra_thresh`` is coded intra, one size read per
inter frame) and clip-level two-pass (pass 1 at the table QPs, its row bits
in one device-to-host copy, ``rc.second_pass_row_qps``, pass 2 with pass 1's
frame types).  The decoder reads the row QPs from the stream.

On the CPU every kernel takes its plain PyTorch version.  Every value it
produces is bit-identical to the JAX engine's on the same input and config
(MVs, split flags, coefficients, sizes, reconstructions).

``engine='compat'`` raises ``ValueError`` here: that engine is
``compat_engine.CompatCodec``, which the facade picks for it.

A ``TorchCodec`` built with ``rows`` codes one mesh tile: a band of whole
block rows of the frame (``parallel/mesh.py``).  Its steps take the
reference band around the tile, or under fast ME the whole reference frames,
and every bound is evaluated at frame rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from streamoptima_tpu_torch import metrics
from streamoptima_tpu_torch import rc
from streamoptima_tpu_torch.bitstream import FrameMVArrays, FrameResArrays, widen_mvs
from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core.blocks import blockify, quads_px, split_quads
from streamoptima_tpu_torch.core.motion import Motion
from streamoptima_tpu_torch.profiling import to_device, to_host, traced, tracer

#: per-frame arrays that cross between this engine and the JAX engine
STATE_KEYS = ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "recon")


def check_slice(cfg: CodecConfig) -> None:
    """Refuse what this engine does not run: ``engine='compat'`` (``compat_engine.CompatCodec``'s)."""
    if cfg.compat:
        raise ValueError("engine='compat' runs on compat_engine.CompatCodec; TorchCodec is engine='jax'")


def row_qps_of(cfg: CodecConfig) -> tuple[np.ndarray, np.ndarray]:
    """The frame's per-row QPs of each frame type (intra, inter): the rate
    tables' sequences under rate control (jax_engine.py:72-81), else qp."""
    if cfg.rc_active:
        return tuple(np.asarray(rc.row_qp_sequence(cfg, t), dtype=np.int32) for t in (0, 1))
    const = np.full(cfg.block_rows, cfg.qp, dtype=np.int32)
    return const, const


class TorchCodec:
    """PyTorch encoder/decoder of the native engine, on an explicit ``device``."""

    @traced("engine.init")
    def __init__(self, cfg: CodecConfig, y_frames=None, *, device="cuda", rows: tuple[int, int] | None = None):
        check_slice(cfg)
        self.cfg = cfg
        self.vbs = cfg.vbs_enable
        self.device = torch.device(device)
        self.y = None if y_frames is None else np.asarray(y_frames, dtype=np.uint8)
        self._stage = PinnedStage()  # the decode's staging of a container's coded lists (nothing until used)
        # the clip is uploaded once; frames are device slices
        self._y_dev = None if self.y is None else to_device(self.y, self.device, "clip")
        #: the tool set's search, fetch and fast-ME kernels for the frame rows [g_row0, g_row0 + h) this
        #: instance codes: the frame, or a mesh tile's band
        self.motion = Motion(cfg, self.device, rows)
        self.g_row0, self.h, self.w = self.motion.g_row0, self.motion.h, cfg.width
        if rows is not None and cfg.parallel_mode:
            raise ValueError("a tile (rows=...) codes without parallel modes")
        self.bs = cfg.block_size
        self.sbs = cfg.sub_block_size
        self.nbr, self.nbc = self.h // self.bs, cfg.blocks_per_row
        self.nb = self.nbr * self.nbc
        rows_blk = slice(self.g_row0 // self.bs, self.g_row0 // self.bs + self.nbr)
        #: the frame's per-row QPs of each frame type, on the host (two-pass falls back to them)
        self.row_qps_np = row_qps_of(cfg)
        self.roi = None
        if cfg.roi_qp_map is not None:
            roi = np.asarray(cfg.roi_qp_map, dtype=np.int32).reshape(-1)
            if roi.shape[0] != cfg.n_blocks:
                raise ValueError(f"roi_qp_map has {roi.shape[0]} offsets for {cfg.n_blocks} blocks")
            self.roi = torch.from_numpy(roi.reshape(cfg.block_rows, self.nbc)[rows_blk].copy()).to(self.device)
        #: block QPs of this instance's rows for each frame type, at the table rows
        self.qps_by_type = tuple(self._frame_qps(torch.from_numpy(q[rows_blk].copy()).to(self.device), t)
                                 for t, q in enumerate(self.row_qps_np))
        # non-border blocks (frame row and column 0) may split
        # (jax_engine.py:68-71); intra mode 1 numbers the blocks in the
        # transposed frame's raster order
        border = torch.zeros((self.nbr, self.nbc), dtype=torch.bool, device=self.device)
        border[0, :] = self.g_row0 == 0
        border[:, 0] = True
        self.vbs_eligible = ~border.reshape(-1)
        self.vbs_eligible_t = ~border.T.reshape(-1)
        # parallel mode 1 searches every frame in full (jax_engine.py:714)
        self.fast = cfg.fast_me and cfg.parallel_mode != 1
        #: fast ME: ``rowscan_pass`` launches of each inter frame of the last encode
        self.fast_me_passes: list[int] = []
        #: the last encode's reconstructions, (n, h, w) uint8 on the device (None before an encode)
        self.recon: torch.Tensor | None = None

    @property
    def source(self) -> torch.Tensor | None:
        """The clip the metrics compare against: its copy on the device."""
        return self._y_dev

    # ------------------------------------------------------------ shared
    def _plane128(self) -> torch.Tensor:
        return torch.full((self.h, self.w), 128, dtype=torch.uint8, device=self.device)

    def _block_qps(self, row_qps: torch.Tensor, transposed: bool = False) -> torch.Tensor:
        """Per-block QPs in block raster order (``JaxCodec._block_qps``): the
        row QPs plus the ROI offsets, clipped to [0, 12]; ``transposed``, the
        intra mode 1 order, keeps them on pixel rows."""
        q = row_qps.to(torch.int32)[:, None].expand(self.nbr, self.nbc)
        if self.roi is not None:
            q = (q + self.roi).clamp(0, 12)
        if transposed:
            q = q.T
        return q.reshape(-1).contiguous()

    def _frame_qps(self, row_qps: torch.Tensor, ftype: int) -> torch.Tensor:
        """Block QPs of a frame coded as ``ftype``: intra frames of intra mode
        1 number their blocks in transposed order."""
        return self._block_qps(row_qps, ftype == 0 and self.cfg.intra_mode == 1)

    def _inter_refs(self, refs: list, initial: bool) -> tuple[list, bool]:
        """The references an inter frame predicts from: the FIFO, or under
        parallel modes 1 and 3 the all-128 plane alone."""
        if self.cfg.parallel_mode in (1, 3):
            return [self._plane128()], True
        return refs, initial

    def _select(self, res_full, res_quads, sad, sub_sad, ftype: int, qps, ok=None, sub_ok=None, transposed=False):
        return K.transform_select(res_full, res_quads, sad, sub_sad, ftype, qps,
                                  qp_nominal=int(self.cfg.qp), lam=self.cfg.lam, vbs_enable=self.vbs,
                                  vbs_eligible=self.vbs_eligible_t if transposed else self.vbs_eligible,
                                  bs=self.bs, sbs=self.sbs, ok_full=ok, ok_quads=sub_ok)

    def _pred_blocks(self, pf, pq, ok=None, sub_ok=None):
        """The residual's predictions from the planes: (nb, bs, bs) and (nb,
        4, s, s) int32 (None without VBS), 128 where ``ok`` / ``sub_ok`` is
        False."""
        pred_full = blockify(pf, self.bs).to(torch.int32)
        if ok is not None:
            pred_full = torch.where(ok[:, None, None], pred_full, 128)
        if pq is None:
            return pred_full, None
        pred_q = quads_px(pq, self.bs).to(torch.int32)
        if sub_ok is not None:
            pred_q = torch.where(sub_ok[:, :, None, None], pred_q, 128)
        return pred_full, pred_q

    def _recon_inter(self, pf, pq, split, qtc_full, qtc_quads, qps=None, ok=None, sub_ok=None) -> torch.Tensor:
        """An inter frame's (h, w) uint8 reconstruction from its prediction
        planes (``Motion.fetch``'s, or the whole-pel search's; 128 where ``ok`` /
        ``sub_ok`` is False), in one ``residual_recon`` launch."""
        return K.residual_recon(qtc_full, qtc_quads if self.vbs else None,
                                self.qps_by_type[1] if qps is None else qps, pf, pq, split if self.vbs else None,
                                ok, sub_ok)

    def _recon_intra(self, mv, split, sub_mv, qtc_full, qtc_quads, qps=None) -> torch.Tensor:
        rf, rq = K.residual_recon(qtc_full, qtc_quads if self.vbs else None,
                                  self.qps_by_type[0] if qps is None else qps)
        # without VBS rq is None, and the split flags and sub-MVs go unread; intra mode 1 is mode 0 on the
        # transposed frame (jax_engine.py:699-704)
        return K.intra_recon(rf, mv, self.h, self.w, self.bs, self.cfg.search_range, rq, split, sub_mv,
                             transpose=self.cfg.intra_mode == 1)

    def _outputs(self, mv, sub_mv, sel, recon, row_bits=None) -> dict:
        split, qtc_full, qtc_quads, lens, mae = sel
        return {
            "mv": mv, "split": split, "sub_mv": sub_mv,
            # |qtc| <= 4080 (orthonormal 16x16 DCT of +-255 residuals)
            "qtc_full": qtc_full.to(torch.int16),
            "qtc_quads": qtc_quads.to(torch.int16),
            "size": lens.sum(),
            "row_bits": lens.reshape(self.nbr, self.nbc).sum(dim=1) if row_bits is None else row_bits,
            "recon": recon,
            "mae": mae,  # per block: a mesh frame's mean is over its tiles' blocks together
        }

    # ------------------------------------------------------------- steps
    @traced("engine.intra_step")
    def _intra_step(self, cur: torch.Tensor, qps: torch.Tensor | None = None) -> dict:
        """One intra frame at block QPs ``qps`` (default: the table rows')."""
        cfg = self.cfg
        qps = self.qps_by_type[0] if qps is None else qps
        mode1 = cfg.intra_mode == 1
        # mode 1 searches the transposed frame (jax_engine.py:776-815); its residuals come back as the frame holds them
        canvas_w = cfg.intra_canvas[0] if mode1 else cfg.intra_canvas[1]
        s, res_full, res_quads = K.intra_search(cur, self.bs, cfg.search_range, canvas_w, self.vbs, transpose=mode1)
        sub_sad = s["sub_sad"].reshape(self.nb, 4) if self.vbs else None
        with tracer.span("engine.residual"):
            sel = self._select(res_full, res_quads, s["sad"].reshape(-1), sub_sad, 0, qps, transposed=mode1)
            mv = s["mv"].reshape(-1)
            sub_mv = s["sub_mv"].reshape(self.nb, 4) if self.vbs else torch.zeros((self.nb, 4), dtype=torch.int32,
                                                                                   device=self.device)
            recon = self._recon_intra(mv, sel[0], sub_mv, sel[1], sel[2], qps)
        # row bits sum pixel rows of blocks either way
        row_bits = sel[3].reshape(self.nbc, self.nbr).sum(dim=0) if mode1 else None
        return self._outputs(mv, sub_mv, sel, recon, row_bits)

    @traced("engine.inter_step")
    def _inter_step(self, cur: torch.Tensor, planes: torch.Tensor, g0: torch.Tensor | None = None,
                    band_row0: int = 0, qps: torch.Tensor | None = None, mvp: torch.Tensor | None = None) -> dict:
        """One inter frame against ``planes`` (``Motion.planes`` of the references,
        or of bands of them holding this instance's rows at ``band_row0``),
        at block QPs ``qps`` (default: the table rows').  Fast ME solves the
        chain from ``g0``, or confirms at MVPs ``mvp`` a caller has already
        solved (a mesh tile: ``fast_chain`` over its data row's tiles)."""
        qps = self.qps_by_type[1] if qps is None else qps
        mo = self.motion
        # contiguous for the confirm kernel (a one-row frame or tile blockifies to a strided view)
        cur_blocks = blockify(cur, self.bs).to(torch.int32, memory_format=torch.contiguous_format)
        if self.fast:
            if self.cfg.parallel_mode == 2:  # every block's MVP is zero (jax_engine.py:237-295)
                s = mo.confirm(cur_blocks, planes, torch.zeros((self.nb, 3), dtype=torch.int32, device=self.device))
            elif mvp is not None:
                s = mo.confirm(cur_blocks, planes, mvp)
                s["g_next"] = mvp
            else:
                s, passes = mo.fast_search(cur, cur_blocks, planes, g0)
                self.fast_me_passes.append(passes)
            # a block without a valid candidate keeps its MVP as MV (K8) and is
            # predicted at that MV like any other: no 128 mask here
            pf, pq = mo.fetch(s["mv"], s.get("sub_mv"), planes, band_row0)
            mask = (None, None)
        else:
            # a block or quad without a valid candidate is predicted by 128s
            s, pf, pq = mo.search(cur, planes, band_row0)
            mask = (s["ok"], s.get("sub_ok"))
        pred_full, pred_q = self._pred_blocks(pf, pq, *mask)
        with tracer.span("engine.residual"):
            res_q = (split_quads(cur_blocks) - pred_q).contiguous() if self.vbs else None
            sel = self._select((cur_blocks - pred_full).contiguous(), res_q, s["sad"], s.get("sub_sad"), 1, qps,
                               ok=s["ok"], sub_ok=s.get("sub_ok"))
            recon = self._recon_inter(pf, pq, sel[0], sel[1], sel[2], qps, *mask)
        sub_mv = s["sub_mv"] if self.vbs else torch.zeros((self.nb, 4, 3), dtype=torch.int32, device=self.device)
        out = self._outputs(s["mv"], sub_mv, sel, recon)
        if "g_next" in s:
            out["g_next"] = s["g_next"]
        return out

    # ------------------------------------------------------------ encode
    def _encode_pass(self, ftypes_fixed: list | None = None, rqps: np.ndarray | None = None, light: bool = False):
        """One encode pass over the clip (``JaxCodec._encode_pass``).

        ``ftypes_fixed`` / ``rqps``: two-pass's second pass, with pass 1's
        frame types (promotion is not decided again) and the clip's
        (n, block_rows) row QPs, uploaded here in one copy.  ``light`` keeps
        only each frame's row bits (pass 1).  Returns (per_frame, ftypes)."""
        cfg = self.cfg
        ftypes: list[int] = []
        per_frame: list[dict] = []
        refs = [self._plane128()]
        initial = True
        self.fast_me_passes = []
        promote = promotes(cfg, ftypes_fixed)
        rqps = None if rqps is None else to_device(rqps, self.device, "row_qps")
        g_carry = None  # fast ME: the last inter frame's converged MVPs warm-start the next
        for i in range(cfg.frames):
            with tracer.frame(i):
                cur = self._y_dev[i]

                def qps(ftype: int) -> torch.Tensor:
                    return self.qps_by_type[ftype] if rqps is None else self._frame_qps(rqps[i], ftype)

                intra = (i % cfg.intra_dur == 0 and cfg.parallel_mode != 1) if ftypes_fixed is None \
                    else ftypes_fixed[i] == 0
                if intra:
                    out, ftype = self._intra_step(cur, qps(0)), 0
                else:
                    out, ftype = self._inter_step(cur, self.motion.planes(*self._inter_refs(refs, initial)), g_carry,
                                                  qps=qps(1)), 1
                    # scene-change promotion (jax_engine.py:959-963): one size read per inter frame
                    if promote and int(to_host(out["size"], "promote_size")) > cfg.intra_thresh:
                        out, ftype = self._intra_step(cur, qps(0)), 0
                g_carry = out.pop("g_next", g_carry)
                ftypes.append(ftype)
                tracer.set("type", ftype)
                if light:
                    per_frame.append({"row_bits": out["row_bits"]})
                else:
                    out["psnr"] = metrics.psnr(cur, out["recon"])
                    per_frame.append(out)
                if i < cfg.frames - 1:
                    if ftype == 0:
                        refs = []
                    fifo_push(refs, out["recon"], cfg.n_ref_frames)
                    initial = False
        return per_frame, ftypes

    @traced("engine.encode")
    def encode(self, package: bool = True) -> dict:
        """Encode the clip.  ``package=False`` leaves the per-frame outputs as
        device tensors under "per_frame" instead of building the list-form
        "MVS per Frame" / "approx residual" interchange.  Two-pass is
        clip-level (``encode_passes``)."""
        if self._y_dev is None:
            raise ValueError("construct with y_frames to encode")
        cfg = self.cfg
        per_frame, ftypes, qp_rows = encode_passes(cfg, self.row_qps_np, self._encode_pass)
        pkg, self.recon = build_package(cfg, per_frame, ftypes, "full" if package else "arrays", qp_rows)
        if self.fast:
            pkg["fast_me_passes"] = list(self.fast_me_passes)
        return pkg

    # ------------------------------------------------------------ decode
    @traced("engine.decode")
    def decode(self, frame_types, residuals_per_frame, qp_rows_per_frame, mvs_per_frame) -> list:
        """Decode list- or array-form interchange (the bitstream readers'
        output) into a list of (h, w) uint8 device tensors; the row QPs come
        from the stream under rate control (jax_engine.py:1108-1109)."""
        cfg = self.cfg
        n = len(frame_types)
        # parallel mode 1 decodes every frame as an inter frame against the
        # all-128 plane (jax_engine.py:1180-1196)
        all_inter = cfg.parallel_mode == 1
        d_mv, d_smv, d_split, d_pay, d_rqp = upload_stream(
            pack_stream(cfg, frame_types, residuals_per_frame, mvs_per_frame, qp_rows_per_frame), self.device,
            self.vbs, cfg.rc_active, self._stage)

        out = []
        refs = [self._plane128()]
        initial = True
        for i in range(n):
            with tracer.frame(i):
                qf, qq = unpack_payload(d_split[i], d_pay[i], self.vbs)
                intra = int(frame_types[i]) == 0 and not all_inter
                ft = 0 if intra else 1
                tracer.set("type", ft)
                qps = self.qps_by_type[ft] if d_rqp is None else self._frame_qps(d_rqp[i], ft)
                if intra:
                    f = self._recon_intra(d_mv[i, :, 0], d_split[i], d_smv[i, :, :, 0] if self.vbs else None,
                                          qf, qq, qps)
                    refs = []
                else:
                    pf, pq = self.motion.fetch(d_mv[i], d_smv[i] if self.vbs else None,
                                               self.motion.planes(*self._inter_refs(refs, initial)))
                    f = self._recon_inter(pf, pq, d_split[i], qf, qq, qps)
                out.append(f)
                if i < n - 1:
                    fifo_push(refs, f, cfg.n_ref_frames)
                    initial = False
        return out


# ------------------------------------------- shared with the mesh (module level)
def promotes(cfg: CodecConfig, ftypes_fixed: list | None) -> bool:
    """Whether a pass decides scene-change promotion: ``rc_flag > 1``, except
    in two-pass's second pass, which keeps pass 1's frame types."""
    return ftypes_fixed is None and cfg.rc_flag is not None and cfg.rc_flag > 1


def encode_passes(cfg: CodecConfig, row_qps_np, run_pass) -> tuple[list, list, list]:
    """The clip's encode passes (``JaxCodec.encode``), for one device and the
    mesh alike.  ``run_pass(ftypes_fixed, rqps, light) -> (per_frame,
    ftypes)`` runs one pass; ``rqps`` is a host (n, block_rows) array.

    Two-pass is clip-level: pass 1 light at the table QPs (promotion decided
    there), its row bits in one device-to-host copy, the second pass's row
    QPs on the host, pass 2 with pass 1's frame types.  Returns (per_frame,
    ftypes, qp_rows): pass 2's rows under two-pass, the table rows of each
    frame's type under rate control, ``[]`` per frame without it."""
    if cfg.two_pass and cfg.rc_active:
        pf1, ftypes1 = run_pass(None, None, True)
        row_bits = to_host(torch.stack([o["row_bits"] for o in pf1]), "two_pass_bits")  # the one copy
        rqps = np.stack([rc.second_pass_row_qps(cfg, row_bits[i], t, row_qps_np[t]) for i, t in enumerate(ftypes1)])
        per_frame, ftypes = run_pass(ftypes1, rqps, False)
        return per_frame, ftypes, rqps.tolist()
    per_frame, ftypes = run_pass(None, None, False)
    return per_frame, ftypes, [row_qps_np[t].tolist() if cfg.rc_active else [] for t in ftypes]


def fifo_push(refs: list, frame: torch.Tensor, nref: int) -> None:
    """Reference FIFO update (Encoder.py:1864-1867): append the newest
    reconstruction, evicting the oldest once ``nref`` are held.  The one
    implementation for every encode and decode loop, single-device and mesh:
    encode and decode stay in step only if they update alike."""
    if len(refs) >= nref:
        refs.pop(0)
    refs.append(frame)


@traced("engine.package")
def build_package(cfg: CodecConfig, per_frame: list, ftypes: list, fetch: str = "full",
                  qp_rows=None) -> tuple[dict, torch.Tensor | None]:
    """The encode package from per-frame outputs (each with "psnr" and the
    per-block "mae").  ``fetch``: "full" adds the list-form "MVS per Frame"
    / "approx residual" interchange, "arrays" the per-frame device tensors
    under "per_frame", "light" neither, and "metrics" leaves out the
    reconstructions too.  ``qp_rows``: each frame's row QPs under rate
    control ([] per frame without).  Returns the package and the
    reconstructions on their device (None under "metrics")."""
    nb = cfg.block_rows * cfg.blocks_per_row
    stats = to_host(torch.stack([torch.stack([o["psnr"], o["mae"].mean()]) for o in per_frame]), "package")
    recon = None if fetch == "metrics" else torch.stack([o["recon"] for o in per_frame])
    sizes = to_host(torch.stack([o["size"] for o in per_frame]), "package")
    pkg = {
        "block size": cfg.block_size,
        "num frames": cfg.frames,
        "height in pixels": cfg.height,
        "width in pixels": cfg.width,
        "search range": cfg.search_range,
        "PSNR per frame": [float(v) for v in stats[:, 0]],
        "MAE per Frame": [float(v) for v in stats[:, 1]],
        "frame_type_seq": ftypes,
        "Qp_per_row_per_frame": [[] for _ in ftypes] if qp_rows is None else qp_rows,
        "residual size per frame": [int(v) for v in sizes],
        "reconstructed frames": None if recon is None else to_host(recon, "package"),
    }
    if fetch == "full":
        pkg["MVS per Frame"] = [mvs_to_list(o, ft, nb) for o, ft in zip(per_frame, ftypes)]
        pkg["approx residual"] = [res_to_list(o, nb) for o in per_frame]
    elif fetch == "arrays":
        pkg["per_frame"] = per_frame
    elif fetch not in ("light", "metrics"):
        raise ValueError(f"fetch must be full, arrays, light or metrics, not {fetch!r}")
    return pkg, recon


def _align16(n: int) -> int:
    return -(-n // 16) * 16


class CodedPayload(NamedTuple):
    """``pack_stream``'s coefficients where the stream holds the container's
    coded lists: each frame's ``binstream.CodedResiduals`` and each block's
    unit index (n, nb) int32 (r >= 0, the r-th unsplit block of its frame;
    r < 0, the ~r-th split one), for ``K.rle_unpack``."""
    frames: list
    index: np.ndarray
    bs: int

    @property
    def nbytes(self) -> int:
        """The bytes of the one upload (``fill``'s layout)."""
        return _align16(K.rle_unpack_head(*self.index.shape)) + sum(_align16(r.chunk[1] - r.chunk[0])
                                                                     for r in self.frames)

    def fill(self, host: np.ndarray) -> None:
        """Lay the upload out in ``host`` (``nbytes`` uint8), as ``K.rle_unpack``
        reads it: the frames' table, the unit indices, then each frame's four
        fields as the file holds them, at a multiple of 16 bytes."""
        n, nb = self.index.shape
        tab = host[: 32 * n].view(np.int64).reshape(n, 4)
        host[32 * n: K.rle_unpack_head(n, nb)].view(np.int32)[:] = self.index.reshape(-1)
        pos = _align16(K.rle_unpack_head(n, nb))
        for f, r in enumerate(self.frames):
            a, e = r.chunk
            host[pos: pos + e - a] = np.frombuffer(r.data, np.uint8, e - a, a)
            tab[f] = np.asarray(r.fields) + pos
            pos += _align16(e - a)


class PinnedStage:
    """The pinned host buffer a decoder stages its stream's coded lists in
    for their one upload: grown when a stream needs more, and refilled only
    once the copy out of it has run (an event recorded behind the copy).  On
    the CPU, a fresh array each stream."""

    def __init__(self):
        self.buf, self.copied = None, None

    def take(self, nbytes: int, device: torch.device) -> torch.Tensor:
        if device.type != "cuda":
            return torch.empty(nbytes, dtype=torch.uint8)
        if self.copied is not None:
            self.copied.synchronize()
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = torch.empty(nbytes + nbytes // 4, dtype=torch.uint8, pin_memory=True)
        return self.buf[:nbytes]

    def upload(self, host: torch.Tensor, device: torch.device, site: str) -> torch.Tensor:
        if device.type != "cuda":
            return to_device(host, device, site)
        out = to_device(host, device, site, pinned=True)
        self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(device))
        return out


@traced("engine.pack_stream")
def pack_stream(cfg: CodecConfig, frame_types, residuals_per_frame, mvs_per_frame, qp_rows_per_frame=None):
    """The decoders' host pass: the clip's MVs, sub-MVs, split flags,
    coefficients and row QPs packed for one upload each, (n, nb, 3), (n, nb,
    4, 3), (n, nb), (n, nb, bs, bs) and (n, nbr); intra frames' scalar MVs in
    component 0.  Row QPs are ``cfg.qp`` but where rate control is on and the
    stream gives a frame's rows (jax_engine.py:1108-1109).  A
    block is split or not, so its full-block and quad coefficients share one
    (bs, bs) payload slot.  Where every frame's residuals are the
    container's coded lists (``binstream.CodedResiduals``, with the MVs'
    split flags), the coefficients stay coded: a ``CodedPayload``, which
    ``upload_stream`` decodes on the device; any other input is decoded here.
    A frame that references a frame outside the decoder's FIFO raises
    ``ValueError`` before anything is launched."""
    from streamoptima_tpu_torch.binstream import CodedResiduals  # binstream imports this module

    n, bs, s = len(frame_types), cfg.block_size, cfg.sub_block_size
    nb = cfg.block_rows * cfg.blocks_per_row
    mv_all = np.zeros((n, nb, 3), np.int32)
    smv_all = np.zeros((n, nb, 4, 3), np.int32)
    split_all = np.zeros((n, nb), bool)
    rqp_all = np.full((n, cfg.block_rows), cfg.qp, np.int32)
    nref = 1  # length of the decoder's reference FIFO at frame i
    for i in range(n):
        ft = int(frame_types[i])
        mv_np, split_np, smv_np = list_to_mvs_np(mvs_per_frame[i], ft, nb)
        if ft == 0:
            mv_all[i, :, 0] = mv_np
            smv_all[i, :, :, 0] = smv_np
        else:
            refs_used = np.concatenate([mv_np[:, 2], smv_np[:, :, 2].reshape(-1)])
            held = 1 if cfg.parallel_mode in (1, 3) else nref
            if refs_used.min(initial=0) < 0 or refs_used.max(initial=0) >= held:
                raise ValueError(f"corrupt stream: frame {i} references a frame outside "
                                 f"its {held}-frame reference list")
            mv_all[i] = mv_np
            smv_all[i] = smv_np
        split_all[i] = split_np
        if cfg.rc_active and qp_rows_per_frame is not None and len(qp_rows_per_frame[i]):
            rqp_all[i] = np.asarray(qp_rows_per_frame[i], dtype=np.int32)
        nref = 1 if ft == 0 else min(nref + 1, cfg.n_ref_frames)
    if n and all(isinstance(r, CodedResiduals) and r.bs == bs and np.array_equal(r.split, split_all[i])
                 for i, r in enumerate(residuals_per_frame)):
        split_rank = np.cumsum(split_all, axis=1, dtype=np.int32)
        index = np.where(split_all, -split_rank, np.arange(nb, dtype=np.int32) - split_rank)
        return mv_all, smv_all, split_all, CodedPayload(list(residuals_per_frame), index, bs), rqp_all
    pay_all = np.zeros((n, nb, bs, bs), np.int16)
    for i in range(n):
        qf, qq = list_to_res_np(residuals_per_frame[i], nb, bs, s)
        pay_all[i] = qf
        if split_all[i].any():
            merged = qq.reshape(nb, 2, 2, s, s).swapaxes(2, 3).reshape(nb, bs, bs)
            pay_all[i][split_all[i]] = merged[split_all[i]]
    return mv_all, smv_all, split_all, pay_all, rqp_all


@traced("engine.upload_stream")
def upload_stream(packed: tuple, device, vbs: bool, rc_active: bool, stage: PinnedStage | None = None) -> tuple:
    """Every decoder's device input: ``pack_stream``'s arrays on ``device``,
    one copy each (site ``stream``), the sub-MVs only under ``vbs`` and the
    row QPs only under ``rc_active`` (else None).  A ``CodedPayload`` is
    laid out in ``stage``'s pinned buffer (the decoder's; a new one if
    None), copied in one piece (site ``container``) and decoded there by one
    ``K.rle_unpack`` launch (its plain version on the CPU)."""
    mv, smv, split, pay, rqp = packed
    device = torch.device(device)
    d_mv, d_split = (to_device(a, device, "stream") for a in (mv, split))
    if isinstance(pay, CodedPayload):
        stage = stage or PinnedStage()
        host = stage.take(pay.nbytes, device)
        pay.fill(host.numpy())
        d_pay = K.rle_unpack(stage.upload(host, device, "container"), *pay.index.shape, pay.bs)
        if tracer.on:
            tracer.rle_decoded_frames["device"] += len(pay.frames)
    else:
        d_pay = to_device(pay, device, "stream")
    d_smv = to_device(smv, device, "stream") if vbs else None
    d_rqp = to_device(rqp, device, "stream") if rc_active else None
    return d_mv, d_smv, d_split, d_pay, d_rqp


# ------------------------------------------------ interchange (module level)
def _np(x) -> np.ndarray:
    return to_host(x, "fetch") if isinstance(x, torch.Tensor) else np.asarray(x)


def unpack_payload(sp: torch.Tensor, pay: torch.Tensor, vbs: bool):
    """Merged-coefficient payload -> (qtc_full, qtc_quads) on the device, as
    the JAX ``_unpack_payload``: a split block's slot holds its merged quads,
    an unsplit block's its full-block coefficients; the other half reads 0.
    Without VBS the recon reads no quads, so that half is not built (None)."""
    qf = torch.where(sp[:, None, None], 0, pay)
    return qf, torch.where(sp[:, None, None, None], split_quads(pay), 0) if vbs else None


def frame_arrays_of(out: dict, ftype: int):
    """One per-frame output -> the array interchange (bitstream.FrameMVArrays,
    FrameResArrays) that ``bitstream.write_bitstream`` serializes."""
    sp = _np(out["split"]).astype(bool)
    m3, s3 = widen_mvs(int(ftype), _np(out["mv"]), _np(out["sub_mv"]))

    def narrow(a, what):
        a = _np(a)
        if a.size and (a.min() < -32768 or a.max() > 32767):
            raise OverflowError(f"{what} outside int16 range")
        return a.astype(np.int16)

    res = FrameResArrays(sp, narrow(out["qtc_full"], "qtc_full"), narrow(out["qtc_quads"], "qtc_quads"))
    return FrameMVArrays(int(ftype), m3, sp, s3), res


def mvs_to_list(out: dict, ftype: int, nb: int) -> list:
    """Per-frame outputs -> the list-form MV interchange."""
    mv = _np(out["mv"])
    split = _np(out["split"]).tolist()
    smv = _np(out["sub_mv"])
    if ftype == 0:
        mvl = (mv if mv.ndim == 1 else mv[:, 0]).tolist()
        smvl = (smv if smv.ndim == 2 else smv[:, :, 0]).tolist()
        return [(1, smvl[i]) if split[i] else (0, mvl[i]) for i in range(nb)]
    mvl = list(map(tuple, mv.tolist()))
    smvl = [[tuple(q) for q in b] for b in smv.tolist()]
    return [(1, smvl[i]) if split[i] else (0, mvl[i]) for i in range(nb)]


def res_to_list(out: dict, nb: int) -> list:
    """Per-frame outputs -> the list-form residual interchange."""
    qf = _np(out["qtc_full"])
    qq = _np(out["qtc_quads"])
    split = _np(out["split"])
    return [(1, [qq[i, q] for q in range(4)]) if split[i] else (0, qf[i]) for i in range(nb)]


def list_to_mvs_np(mvs_list, ftype: int, nb: int):
    """List- or array-form MVs -> numpy (mv, split, sub_mv); intra frames give
    (nb,) / (nb, 4) scalars, inter frames (nb, 3) / (nb, 4, 3) triples."""
    if isinstance(mvs_list, FrameMVArrays):
        if ftype == 0:
            return mvs_list.mv[:, 0], mvs_list.split, mvs_list.smv[:, :, 0]
        return mvs_list.mv, mvs_list.split, mvs_list.smv
    split = np.fromiter((sp for sp, _ in mvs_list), dtype=bool, count=nb)
    shape = () if ftype == 0 else (3,)
    mv = np.zeros((nb,) + shape, dtype=np.int32)
    smv = np.zeros((nb, 4) + shape, dtype=np.int32)
    fi = np.flatnonzero(~split)
    si = np.flatnonzero(split)
    if fi.size:
        mv[fi] = np.array([mvs_list[i][1] for i in fi], dtype=np.int32)
    if si.size:
        smv[si] = np.array([mvs_list[i][1] for i in si], dtype=np.int32)
    return mv, split, smv


def list_to_res_np(res_list, nb: int, bs: int, sbs: int):
    """List- or array-form residuals -> numpy int16 (qtc_full, qtc_quads);
    values outside int16 (corrupt streams) raise OverflowError."""
    if isinstance(res_list, FrameResArrays):
        return res_list.qf, res_list.qq
    split = np.fromiter((sp for sp, _ in res_list), dtype=bool, count=nb)
    qf = np.zeros((nb, bs, bs), dtype=np.int16)
    qq = np.zeros((nb, 4, sbs, sbs), dtype=np.int16)
    fi = np.flatnonzero(~split)
    si = np.flatnonzero(split)
    if fi.size:
        qf[fi] = np.array([res_list[i][1] for i in fi], dtype=np.int16)
    if si.size:
        qq[si] = np.array([res_list[i][1] for i in si], dtype=np.int16)
    return qf, qq


def from_jax_per_frame(per_frame, device) -> list[dict]:
    """JAX engine per-frame outputs (``encode(package=False)``, any array
    type) -> this engine's per-frame tensors on ``device``."""
    return [{k: torch.from_numpy(np.array(o[k])).to(device) for k in STATE_KEYS} for o in per_frame]


def to_numpy_per_frame(per_frame) -> list[dict]:
    """This engine's per-frame tensors -> numpy arrays (the JAX engine's
    interchange helpers accept them as they accept its own outputs)."""
    return [{k: _np(o[k]) for k in STATE_KEYS} for o in per_frame]
