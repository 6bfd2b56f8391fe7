"""Reference-exact engine (``engine="compat"``) on one device.

``CompatCodec`` is the counterpart of ``streamoptima_tpu.compat_engine.
CompatCodec``: the encoder/decoder pair that is bit-exact with the original
StreamOptima NumPy reference (Encoder.py, decoder.py), every quirk of
COMPAT_NOTES.md included.  Where it differs from the native engine
(``engine.TorchCodec``):

- the transform is ``scipy.fftpack``'s float64 DCT, rounded half to even:
  the ``dct_scipy`` kernel, which replays pocketfft's operations in their
  order (``core/transform.py``), computed once per residual and shared by
  the RD decision and the quantization;
- the VBS decision compares float64 ``lam * bits + MAE`` at the constant
  ``cfg.qp``, where MAE is SAD / n^2 (``inf`` without a valid candidate) and,
  under fast ME, the winner's reference index (quirk K6);
- a block without a valid full-search candidate is predicted at mv
  (0, 0, 0) like any other MV (cases A, B, C), not from 128s;
- the reconstruction and decode check the VBS quads' FME margin against the
  parent block's size (quirk K18: ``pred_fetch_fme_vbs(quad_margin=bs)``),
  the residual path against the quad's own;
- intra search runs on the reference's 288x352 canvas (quirk K12:
  ``cfg.intra_canvas``), so frames larger than CIF cannot be intra-coded,
  and intra mode 1 is refused (bug B2);
- the synthetic all-128 reference is float in the reference, so its
  half-pel row pass never wraps (quirk K17); reconstructions wrap;
- rate control takes the intra table's row QPs for every frame (quirks K9,
  K10; ``rc.row_qp_sequence``), scene-change promotion recodes an inter
  frame intra; no ROI maps, no two-pass (``CodecConfig`` refuses them);
- PSNR is the reference's float64 one, from each frame's integer squared
  error on the device.

Every search, fetch and transform is a kernel launch on a CUDA device
(``core/kernels.py``): the searches, prediction fetches and fast ME's chain
and confirm through the native engine's motion layer (``core/motion.py``),
``dct_scipy``, and each intra frame's
search and residuals (``intra_search``) and reconstruction
(``intra_recon``), one launch each a frame.  On the CPU each takes its plain
PyTorch version.  The package and the decoder's inputs are the JAX
engine's list forms, which ``bitstream.write_bitstream`` serializes.
"""
from __future__ import annotations

import numpy as np
import torch

from streamoptima_tpu_torch import rc
from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core.blocks import blockify, merge_quads, quads_px, split_quads, unblockify
from streamoptima_tpu_torch.core.motion import Motion
from streamoptima_tpu_torch.core.pred import wrap_uint8
from streamoptima_tpu_torch.core.quant import qp_minus_1, quantize, rescale
from streamoptima_tpu_torch.core.zigzag import rle_length
from streamoptima_tpu_torch.engine import (fifo_push, mvs_to_list, pack_stream, res_to_list, unpack_payload,
                                           upload_stream)
from streamoptima_tpu_torch.profiling import to_device


class CompatCodec:
    """Encoder/decoder bit-exact with the NumPy reference, on an explicit ``device``."""

    def __init__(self, cfg: CodecConfig, y_frames=None, *, device="cuda"):
        if not cfg.compat:
            raise ValueError("CompatCodec requires engine='compat'")
        if cfg.intra_mode != 0:
            raise NotImplementedError("intra_mode=1 is unrunnable in the reference (bug B2)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.y = None if y_frames is None else np.asarray(y_frames, dtype=np.uint8)
        self._y_dev = None if self.y is None else to_device(self.y, self.device, "clip")
        self.h, self.w = cfg.height, cfg.width
        self.bs, self.sbs = cfg.block_size, cfg.sub_block_size
        self.nbr, self.nbc = cfg.block_rows, cfg.blocks_per_row
        self.nb = self.nbr * self.nbc
        self.vbs, self.fme = cfg.vbs_enable, cfg.fme_enable
        #: the tool set's search, fetch and fast-ME kernels
        self.motion = Motion(cfg, self.device)
        self.vbs_eligible = (self.motion.bx != 0) & (self.motion.by != 0)
        #: every encoded frame's row QPs (the intra table's, K9/K10; [] without rate control) and block QPs
        self._row_qps = list(rc.row_qp_sequence(cfg)) if cfg.rc_active else []
        self._qps = self._block_qps(self._row_qps)
        # fast ME (Encoder.py:549-581) but in parallel mode 1, which searches in full
        self.fast = cfg.fast_me and cfg.parallel_mode != 1
        #: fast ME: ``rowscan_pass`` launches of each chained inter frame of the last encode
        self.fast_me_passes: list[int] = []
        #: the last encode's reconstructions, (n, h, w) uint8 on the device (None before an encode)
        self.recon: torch.Tensor | None = None

    @property
    def source(self) -> torch.Tensor | None:
        """The clip the metrics compare against: its copy on the device."""
        return self._y_dev

    # ------------------------------------------------------------- helpers
    def _plane128(self) -> tuple[torch.Tensor, bool]:
        """The initial reference: all 128, float in the reference (True: its
        half-pel row pass does not wrap, K17)."""
        return torch.full((self.h, self.w), 128, dtype=torch.uint8, device=self.device), True

    def _block_qps(self, qp_rows: list) -> torch.Tensor:
        """Per-block QPs from per-row values, or ``cfg.qp`` for an empty list."""
        rows = qp_rows if len(qp_rows) else [self.cfg.qp] * self.nbr
        return torch.tensor(rows, dtype=torch.int64, device=self.device).repeat_interleave(self.nbc)

    def _dct(self, blocks: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """``dct_scipy`` of (..., n, n) int64 blocks, batched flat."""
        n = blocks.shape[-1]
        return K.dct_scipy(blocks.reshape(-1, n, n).contiguous(), inverse).reshape(blocks.shape)

    # ------------------------------------------------------- motion search
    def _full_search(self, cur: torch.Tensor, planes: torch.Tensor) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """Full search (Encoder.py:678-717) of every block and, under VBS,
        quad; MAE = SAD / n^2, ``inf`` without a valid candidate.  Returns
        the search's outputs and the residual path's predictions at its MVs
        ((nb, bs, bs) and (nb, 4, s, s) int64, None without VBS): a block
        without a valid candidate is predicted at mv (0, 0, 0)."""
        bs, s = self.bs, self.sbs
        out, pred, pred_q = self.motion.search(cur, planes)
        if self.motion.search_name == "full_search" and not bool(out["ok"].all()):  # it gave zeros there
            pred = self.motion.fetch(out["mv"], None, planes)[0]
        inf = torch.tensor(float("inf"), dtype=torch.float64, device=self.device)
        out["mae"] = torch.where(out["ok"], out["sad"].to(torch.float64) / (bs * bs), inf)
        if self.vbs:
            out["sub_mae"] = torch.where(out["sub_ok"], out["sub_sad"].to(torch.float64) / (s * s), inf)
        return out, *self._as_blocks(pred, pred_q)

    def _as_blocks(self, pred: torch.Tensor, pred_q: torch.Tensor | None):
        return (blockify(pred, self.bs).to(torch.int64),
                None if pred_q is None else quads_px(pred_q, self.bs).to(torch.int64))

    def _fast_search(self, cur: torch.Tensor, planes: torch.Tensor, g0: torch.Tensor | None) -> tuple:
        """Fast ME (Encoder.py:549-581, :719-742), ``_full_search``'s outputs:
        the 3x3 search around the previous block's MV in raster order, its
        quads around the block's MVP; parallel mode 2 takes mvp (0, 0, 0) for
        every block (Encoder.py:641-642).  The MAE slot holds the winner's
        reference index (K6), 0 where no candidate is valid, and the MV is
        then the MVP itself (K8)."""
        cur_blocks = blockify(cur, self.bs).to(torch.int32, memory_format=torch.contiguous_format)
        if self.cfg.parallel_mode == 2:
            out = self.motion.confirm(cur_blocks, planes, torch.zeros((self.nb, 3), dtype=torch.int32,
                                                                      device=self.device))
        else:
            out, passes = self.motion.fast_search(cur, cur_blocks, planes, g0)
            self.fast_me_passes.append(passes)
        out["mae"] = torch.where(out["ok"], out["mv"][:, 2], 0).to(torch.float64)
        if self.vbs:
            out["sub_mae"] = torch.where(out["sub_ok"], out["sub_mv"][..., 2], 0).to(torch.float64)
        return out, *self._as_blocks(*self.motion.fetch(out["mv"], out.get("sub_mv"), planes))

    # ------------------------------------------------------------ RD + quant
    def _split_decision(self, tf, tq, mae_full, mae_quads, frame_type: int):
        """The VBS RD comparison (Encoder.py:564-575, :1133-1158) in float64
        at the constant ``cfg.qp`` (Encoder.py:1844), on the shared DCTs.
        Returns the split mask and each block's VBS MAE."""
        cfg = self.cfg
        len_full = rle_length(quantize(tf, cfg.qp))
        len_sub = rle_length(quantize(tq, qp_minus_1(cfg.qp))).sum(dim=1)
        base, base_vbs = (8, 32) if frame_type == 0 else (16, 64)
        vbs_mae = mae_quads.sum(dim=1) / 4.0
        rd_bs = cfg.lam * (base + 8 * len_full).to(torch.float64) + mae_full
        rd_vbs = cfg.lam * (base_vbs + 8 * len_sub).to(torch.float64) + vbs_mae
        return ~(rd_bs < rd_vbs) & self.vbs_eligible, vbs_mae

    def _code(self, res_full, res_quads, mae_full, mae_quads, frame_type: int) -> dict:
        """DCT each residual once, decide the splits, quantize at the row
        QPs (Encoder.py:1665-1697 / :1597-1628).  Returns the frame's split
        mask, coefficients, row QPs, size and MAE sum (float64, exact: every
        MAE is a multiple of 2^-8 below 256, or inf)."""
        qp_rows, qps = list(self._row_qps), self._qps
        tf = self._dct(res_full)
        qf = quantize(tf, qps)
        lens = rle_length(qf)
        out = {"qp_rows": qp_rows, "qps": qps, "qtc_full": qf}
        if self.vbs:
            tq = self._dct(res_quads)
            split, vbs_mae = self._split_decision(tf, tq, mae_full, mae_quads, frame_type)
            qq = quantize(tq, qp_minus_1(qps)[:, None])
            lens = torch.where(split, rle_length(qq).sum(dim=1), lens)
            mae = torch.where(self.vbs_eligible, vbs_mae, mae_full)
        else:
            split = torch.zeros(self.nb, dtype=torch.bool, device=self.device)
            qq = torch.zeros((self.nb, 4, self.sbs, self.sbs), dtype=torch.int64, device=self.device)
            mae = mae_full
        out.update(split=split, qtc_quads=qq, size=lens.sum(), mae_sum=mae.sum())
        return out

    def _dequant(self, qf, qq, qps):
        """Rescale + IDCT of every block's full and quad coefficients
        (Encoder.py:810-817); each block keeps the variant it coded."""
        rf = self._dct(rescale(qf.to(torch.int64), qps), inverse=True)
        if not self.vbs:
            return rf, None
        return rf, self._dct(rescale(qq.to(torch.int64), qp_minus_1(qps)[:, None]), inverse=True)

    # ------------------------------------------------------------ frames
    def _inter_flow(self, cur: torch.Tensor, refs: list, g0) -> dict:
        """One inter frame (complete_inter_flow, Encoder.py:1644-1709)."""
        planes = self.motion.planes(*zip(*refs))  # each reference with its own K17 wrap
        s, pred_full, pred_q = self._fast_search(cur, planes, g0) if self.fast else self._full_search(cur, planes)
        cur_blocks = blockify(cur, self.bs).to(torch.int64)
        res_q = split_quads(cur_blocks) - pred_q if self.vbs else None
        out = self._code(cur_blocks - pred_full, res_q, s["mae"], s.get("sub_mae"), 1)
        sub_mv = s["sub_mv"] if self.vbs else torch.zeros((self.nb, 4, 3), dtype=torch.int32, device=self.device)
        if self.vbs and self.fme:  # the reconstruction's quads see the parent block's margin (K18)
            _, pred_q = self._as_blocks(*self.motion.fetch(s["mv"], sub_mv, planes, quad_margin=self.bs))
        out.update(mv=s["mv"], sub_mv=sub_mv,
                   recon=self._recon_inter(pred_full, pred_q, out["split"], out["qtc_full"], out["qtc_quads"],
                                           out["qps"]))
        if "g_next" in s:
            out["g_next"] = s["g_next"]
        return out

    def _recon_inter(self, pred_full, pred_q, split, qf, qq, qps) -> torch.Tensor:
        """reconstruct_frame (Encoder.py:831-932) == decode_frame_inter."""
        rf, rq = self._dequant(qf, qq, qps)
        blocks = wrap_uint8(pred_full + rf)
        if self.vbs:
            blocks = torch.where(split[:, None, None], merge_quads(wrap_uint8(pred_q + rq)), blocks)
        return unblockify(blocks, self.h, self.w)

    def _intra_flow(self, cur: torch.Tensor) -> dict:
        """One intra frame (complete_intra_flow, Encoder.py:1582-1642) on the
        reference's canvas (K12)."""
        cfg, bs, s = self.cfg, self.bs, self.sbs
        srch, res_full, res_quads = K.intra_search(cur, bs, cfg.search_range, cfg.intra_canvas[1], self.vbs)
        sub_mv = srch["sub_mv"].reshape(self.nb, 4) if self.vbs else None
        mae_q = srch["sub_sad"].reshape(self.nb, 4).to(torch.float64) / (s * s) if self.vbs else None
        out = self._code(res_full.to(torch.int64), None if res_quads is None else res_quads.to(torch.int64),
                         srch["sad"].reshape(-1).to(torch.float64) / (bs * bs), mae_q, 0)
        mv = srch["mv"].reshape(-1)
        sub_mv = torch.zeros((self.nb, 4), dtype=torch.int32, device=self.device) if sub_mv is None else sub_mv
        out.update(mv=mv, sub_mv=sub_mv,
                   recon=self._recon_intra(mv, out["split"], sub_mv, out["qtc_full"], out["qtc_quads"], out["qps"]))
        return out

    def _recon_intra(self, mv, split, sub_mv, qf, qq, qps) -> torch.Tensor:
        """reconstruct_frame_intra (Encoder.py:1350-1417) == decode_frame_intra
        (decoder.py:330-432), mode 0."""
        rf, rq = self._dequant(qf, qq, qps)
        return K.intra_recon(rf, mv, self.h, self.w, self.bs, self.cfg.search_range, rq, split, sub_mv)

    # -------------------------------------------------------------- encode
    def encode(self) -> dict:
        """Encode the clip (Encoder.encode, Encoder.py:1790-1897): the JAX
        compat engine's package, list forms included, plus "residual size
        per frame"; without SSIM, which the facade adds
        (``codec.VideoCodec.encode``), as for ``TorchCodec``."""
        if self._y_dev is None:
            raise ValueError("construct with y_frames to encode")
        cfg = self.cfg
        self.fast_me_passes = []
        frames, ftypes = [], []
        refs = [self._plane128()]
        g_carry = None  # fast ME: the last inter frame's MVPs start the next frame's chain
        promote = cfg.rc_flag is not None and cfg.rc_flag > 1
        for i in range(cfg.frames):
            cur = self._y_dev[i]
            if i % cfg.intra_dur == 0 and cfg.parallel_mode != 1:
                out, ftype = self._intra_flow(cur), 0
            else:
                refs_use = [self._plane128()] if cfg.parallel_mode in (1, 3) else refs
                out, ftype = self._inter_flow(cur, refs_use, g_carry), 1
                g_carry = out.pop("g_next", g_carry)
                if promote and int(out["size"]) > cfg.intra_thresh:
                    out, ftype = self._intra_flow(cur), 0
            frames.append(out)
            ftypes.append(ftype)
            if i < cfg.frames - 1:
                if ftype == 0:
                    refs = []  # decoder-aligned reset (fix B3)
                fifo_push(refs, (out["recon"], False), cfg.n_ref_frames)
        self.recon = torch.stack([o["recon"] for o in frames])
        y = self._y_dev[: cfg.frames].to(torch.int64)
        sse = ((y - self.recon.to(torch.int64)) ** 2).sum(dim=(1, 2)).cpu().tolist()
        stats = torch.stack([torch.stack([o["mae_sum"], o["size"].to(torch.float64)]) for o in frames]).cpu()
        pkg = {
            "block size": self.bs,
            "num frames": cfg.frames,
            "height in pixels": self.h,
            "width in pixels": self.w,
            "search range": cfg.search_range,
            "PSNR per frame": [_psnr(e, self.h * self.w) for e in sse],
            "MAE per Frame": [float(m) / self.nb for m in stats[:, 0].tolist()],
            "MVS per Frame": [mvs_to_list(o, ft, self.nb) for o, ft in zip(frames, ftypes)],
            "approx residual": [res_to_list(o, self.nb) for o in frames],
            "Qp_per_row_per_frame": [o["qp_rows"] for o in frames],
            "frame_type_seq": ftypes,
            "residual size per frame": [int(v) for v in stats[:, 1].tolist()],
            "reconstructed frames": self.recon.cpu().numpy(),
        }
        if self.fast and cfg.parallel_mode != 2:
            pkg["fast_me_passes"] = list(self.fast_me_passes)
        return pkg

    # -------------------------------------------------------------- decode
    def decode(self, frame_types, qblocks_per_frame, qp_rows_per_frame, mvs_per_frame) -> list:
        """decoder.decode (decoder.py:487-545) of list- or array-form
        interchange (the bitstream readers' output) into a list of (h, w)
        uint8 device tensors; a frame's row QPs are the stream's where it
        gives them, else ``cfg.qp``."""
        cfg = self.cfg
        n = len(frame_types)
        # the row QPs are the stream's where it gives them, without the rate control rule
        d_mv, d_smv, d_split, d_pay, _ = upload_stream(
            pack_stream(cfg, frame_types, qblocks_per_frame, mvs_per_frame), self.device, self.vbs, False)
        out = []
        refs = [self._plane128()]
        for i in range(n):
            qf, qq = unpack_payload(d_split[i], d_pay[i], self.vbs)
            qps = self._block_qps(list(qp_rows_per_frame[i]))
            smv = d_smv[i] if self.vbs else None
            if cfg.parallel_mode == 1:  # every frame inter against the all-128 plane
                f = self._decode_inter(d_mv[i], smv, d_split[i], qf, qq, qps, [self._plane128()])
            elif int(frame_types[i]) == 0:
                f = self._recon_intra(d_mv[i, :, 0], d_split[i], None if smv is None else smv[:, :, 0], qf, qq, qps)
                refs = []
            else:
                if cfg.parallel_mode == 3:
                    refs = [self._plane128()]
                f = self._decode_inter(d_mv[i], smv, d_split[i], qf, qq, qps, refs)
            out.append(f)
            if i < n - 1 and cfg.parallel_mode != 1:
                fifo_push(refs, (f, False), cfg.n_ref_frames)
        return out

    def _decode_inter(self, mv, sub_mv, split, qf, qq, qps, refs) -> torch.Tensor:
        planes = self.motion.planes(*zip(*refs))
        pred_full, pred_q = self._as_blocks(*self.motion.fetch(mv, sub_mv, planes, quad_margin=self.bs))  # K18
        return self._recon_inter(pred_full, pred_q, split, qf, qq, qps)


def _psnr(sse: int, npix: int) -> float:
    """The reference's PSNR (metrics.psnr: float64, data range 255) from a
    frame's integer squared error: its mean is the exact sum over npix."""
    err = np.float64(sse) / npix
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((255.0 ** 2) / err))
