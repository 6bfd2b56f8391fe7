"""PyTorch engine: per-frame encode/decode steps on one device.

``TorchCodec`` is the counterpart of ``streamoptima_tpu.jax_engine.JaxCodec``
for I/P frames (an intra frame every ``intra_dur``), one reference frame and
mode-0 intra.  The full search runs in two configurations:

- whole-pel, no VBS: on a CUDA device the inter search runs the
  ``full_search`` kernel (which also returns the winner's pixels) and decode
  predicts through the ``pred_fetch`` kernel;
- VBS + half-pel FME together: each reference's parity planes are computed
  once per frame, the search runs the ``full_search_fme_vbs`` kernel (MVs
  only) and both encode (on the winners) and decode (on the transmitted
  MVs) predict through the ``pred_fetch_fme_vbs`` kernel, block and quad
  planes in one launch.

Fast ME (``fast_me``: a 3x3 search around the previous block's MV, chained
in raster order) runs in the same two configurations.  The chain is solved
per block row: the ``rowscan_pass`` kernel walks every row exactly from a
guessed seed MV, and the seeds (each row's is the last MV of the row above)
are iterated until they stop changing, starting from the previous frame's.
One confirm pass at the converged MVPs then reads every block's candidate
region through the ``window_fetch`` kernel and derives the block and quad
winners (``core/fastme.py``); the winners' pixels come from the same
``pred_fetch`` / ``pred_fetch_fme_vbs`` kernels.  Decode is the same as for
the full search: a fast-ME stream is an ordinary MV stream.

On the CPU every kernel takes its plain PyTorch version.  Every value it
produces is bit-identical to the JAX engine's on the same input and config
(MVs, split flags, coefficients, sizes, reconstructions).

Configurations outside the slice raise ``NotImplementedError`` naming the
feature; ``engine='compat'`` (the host reference engine) raises
``ValueError``.  Neither is a fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from streamoptima_tpu_torch import metrics
from streamoptima_tpu_torch.bitstream import FrameMVArrays, FrameResArrays, widen_mvs
from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.core import fastme as FM
from streamoptima_tpu_torch.core import intra as I
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import rd
from streamoptima_tpu_torch.core.blocks import blockify, merge_quads, quads_px, split_quads, unblockify
from streamoptima_tpu_torch.core.me import block_origins, fme_parity_planes
from streamoptima_tpu_torch.core.pred import wrap_uint8
from streamoptima_tpu_torch.core.quant import qp_minus_1, rescale
from streamoptima_tpu_torch.core.transform import idct2_int

#: per-frame arrays that cross between this engine and the JAX engine
STATE_KEYS = ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "recon")


def check_slice(cfg: CodecConfig) -> None:
    """Refuse, by name, every configuration the port does not run yet."""
    if cfg.compat:
        raise ValueError("engine='compat' is the host reference engine; TorchCodec ports engine='jax'")
    unported = {
        # the FME + VBS search kernel serves the two together only, and
        # fast ME is ported with both or with neither
        "fast_me with exactly one of vbs_enable and fme_enable": cfg.fast_me and cfg.vbs_enable != cfg.fme_enable,
        "vbs_enable without fme_enable": cfg.vbs_enable and not cfg.fme_enable,
        "fme_enable without vbs_enable": cfg.fme_enable and not cfg.vbs_enable,
        "rc_flag": cfg.rc_active,
        "roi_qp_map": cfg.roi_qp_map is not None,
        "two_pass": cfg.two_pass,
        "intra_mode=1": cfg.intra_mode == 1,
        "parallel_mode != 0": cfg.parallel_mode != 0,
        "n_ref_frames > 1": cfg.n_ref_frames > 1,
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported to the PyTorch engine yet")


class TorchCodec:
    """PyTorch encoder/decoder for the ported slice, on an explicit ``device``."""

    def __init__(self, cfg: CodecConfig, y_frames=None, *, device):
        check_slice(cfg)
        self.cfg = cfg
        self.vbs = cfg.vbs_enable  # VBS and FME come together (check_slice)
        self.device = torch.device(device)
        self.y = None if y_frames is None else np.asarray(y_frames, dtype=np.uint8)
        # the clip is uploaded once; frames are device slices
        self._y_dev = None if self.y is None else torch.from_numpy(self.y).to(self.device)
        self.h, self.w = cfg.height, cfg.width
        self.bs = cfg.block_size
        self.sbs = cfg.sub_block_size
        self.nbr, self.nbc = cfg.block_rows, cfg.blocks_per_row
        self.nb = self.nbr * self.nbc
        self.qps = torch.full((self.nb,), cfg.qp, dtype=torch.int32, device=self.device)
        # non-border blocks may split (jax_engine.py:68-69)
        border = torch.zeros((self.nbr, self.nbc), dtype=torch.bool, device=self.device)
        border[0, :] = True
        border[:, 0] = True
        self.vbs_eligible = ~border.reshape(-1)
        bx, by = block_origins(self.h, self.w, self.bs, self.device)
        self.bx, self.by = bx.to(torch.int32), by.to(torch.int32)
        #: fast ME: ``rowscan_pass`` launches of each inter frame of the last encode
        self.fast_me_passes: list[int] = []

    # ------------------------------------------------------------ shared
    def _plane128(self) -> torch.Tensor:
        return torch.full((self.h, self.w), 128, dtype=torch.uint8, device=self.device)

    def _planes(self, refs: list, initial: bool) -> torch.Tensor:
        """Parity planes of the reference list (wrap quirk K17: no wrap only
        for the synthetic all-128 initial reference)."""
        return fme_parity_planes(torch.stack(refs), wrap_row_pass=not initial)

    def _dequant(self, qtc_full: torch.Tensor, qtc_quads: torch.Tensor):
        rf = idct2_int(rescale(qtc_full.to(torch.int32), self.qps))
        if not self.vbs:
            return rf, None
        return rf, idct2_int(rescale(qtc_quads.to(torch.int32), qp_minus_1(self.qps)[:, None]))

    def _select(self, res_full, res_quads, sad, sub_sad, ftype: int, ok=None, sub_ok=None):
        return rd.transform_and_select(res_full, res_quads, sad, sub_sad, ftype, self.qps,
                                       qp_nominal=int(self.cfg.qp), lam=self.cfg.lam, vbs_enable=self.vbs,
                                       vbs_eligible=self.vbs_eligible, bs=self.bs, sbs=self.sbs,
                                       ok_full=ok, ok_quads=sub_ok)

    def _recon_inter(self, pred_full, pred_q, split, qtc_full, qtc_quads) -> torch.Tensor:
        rf, rq = self._dequant(qtc_full, qtc_quads)
        blocks = wrap_uint8(pred_full + rf)
        if self.vbs:
            quad_blocks = merge_quads(wrap_uint8(pred_q + rq))
            blocks = torch.where(split[:, None, None], quad_blocks, blocks)
        return unblockify(blocks, self.h, self.w)

    def _recon_intra(self, mv, split, sub_mv, qtc_full, qtc_quads) -> torch.Tensor:
        rf, rq = self._dequant(qtc_full, qtc_quads)
        # without VBS rq is None, and the split flags and sub-MVs go unread
        frame = I.intra_reconstruct_mode0(rf, mv, self.h, self.w, self.bs, self.cfg.search_range,
                                          residual_quads=rq, split=split, sub_mv=sub_mv)
        return wrap_uint8(frame)

    def _outputs(self, cur, mv, sub_mv, sel, recon) -> dict:
        split, qtc_full, qtc_quads, lens, mae = sel
        return {
            "mv": mv, "split": split, "sub_mv": sub_mv,
            # |qtc| <= 4080 (orthonormal 16x16 DCT of +-255 residuals)
            "qtc_full": qtc_full.to(torch.int16),
            "qtc_quads": qtc_quads.to(torch.int16),
            "size": lens.sum(), "row_bits": lens.reshape(self.nbr, self.nbc).sum(dim=1),
            "recon": recon,
            "mae": mae.mean(),
            "psnr": metrics.psnr(cur, recon),
        }

    # ------------------------------------------------------------- steps
    def _intra_step(self, cur: torch.Tensor) -> dict:
        cfg = self.cfg
        work = cur.to(torch.int32)
        s = I.intra_search_mode0(work, self.bs, cfg.search_range, cfg.intra_canvas[1], self.vbs)
        sub_mv = s["sub_mv"] if self.vbs else None
        res_full, res_quads = I.intra_residuals_mode0(work, s["mv"], self.bs, cfg.search_range, sub_mv)
        sub_sad = s["sub_sad"].reshape(self.nb, 4) if self.vbs else None
        sel = self._select(res_full, res_quads, s["sad"].reshape(-1), sub_sad, 0)
        mv = s["mv"].reshape(-1)
        sub_mv = sub_mv.reshape(self.nb, 4) if self.vbs else torch.zeros((self.nb, 4), dtype=torch.int32,
                                                                          device=self.device)
        recon = self._recon_intra(mv, sel[0], sub_mv, sel[1], sel[2])
        return self._outputs(cur, mv, sub_mv, sel, recon)

    def _fast_search_rowscan(self, cur: torch.Tensor, cur_blocks: torch.Tensor, planes: torch.Tensor,
                             g0: torch.Tensor | None) -> dict:
        """The fast-ME chain of one frame (``JaxCodec._fast_search_rowscan``).

        Each pass solves every block row exactly from its seed; the next
        seeds are the rows' last MVs shifted down one row (row 0: zero).  The
        chain's solution is the one fixpoint of that map, so any start gives
        it; ``g0`` (the previous frame's converged MVPs) only saves passes.
        Testing convergence reads one flag back per pass.  planes: the
        parity planes (nref, 4, h, w) under FME, else the references."""
        fme = self.vbs  # FME comes with VBS (check_slice)
        S, L, n = self.nbr, self.nbc, self.bs
        zero = torch.zeros((1, 3), dtype=torch.int32, device=self.device)
        seeds = zero.expand(S, 3).contiguous() if g0 is None else g0.reshape(S, L, 3)[:, 0].contiguous()
        passes, changed = 0, True
        while changed and passes <= S + 1:
            mvs = K.rowscan_pass(cur, planes, seeds, n, fme)
            passes += 1
            nxt = torch.cat([zero, mvs[:-1, -1]])
            changed = not torch.equal(nxt, seeds)
            seeds = nxt
        self.fast_me_passes.append(passes)
        # at the fixpoint the confirm pass at the MVPs re-derives the same MVs
        g = torch.cat([zero, mvs.reshape(self.nb, 3)[:-1]])
        by0, bx0 = FM.region_base(g, self.by, self.bx, fme)
        win = K.window_fetch(planes.reshape(-1, self.h, self.w), by0, bx0, n + 2)
        scale = 2 if fme else 1
        dims = (2 * self.h - 1, 2 * self.w - 1) if fme else (self.h, self.w)
        out = FM.confirm(win, cur_blocks, g, scale * self.bx, scale * self.by, n, dims, fme, self.vbs)
        out["g_next"] = g
        return out

    def _inter_step(self, cur: torch.Tensor, refs: list, initial: bool, g0: torch.Tensor | None = None) -> dict:
        cfg = self.cfg
        cur_blocks = blockify(cur, self.bs).to(torch.int32)
        if cfg.fast_me:
            planes = self._planes(refs, initial) if self.vbs else torch.stack(refs)
            s = self._fast_search_rowscan(cur, cur_blocks, planes, g0)
            # a block without a valid candidate keeps its MVP as MV (K8) and is
            # predicted at that MV like any other: no 128 mask here
            if self.vbs:
                pf, pq = K.pred_fetch_fme_vbs(s["mv"], s["sub_mv"], planes, self.bs)
                pred_full, pred_q = blockify(pf, self.bs).to(torch.int32), quads_px(pq, self.bs).to(torch.int32)
                sel = self._select(cur_blocks - pred_full, split_quads(cur_blocks) - pred_q, s["sad"], s["sub_sad"],
                                   1, ok=s["ok"], sub_ok=s["sub_ok"])
                sub_mv = s["sub_mv"]
            else:
                pred_full, pred_q = blockify(K.pred_fetch(s["mv"], planes, self.bs), self.bs).to(torch.int32), None
                sel = self._select(cur_blocks - pred_full, None, s["sad"], None, 1, ok=s["ok"])
                sub_mv = torch.zeros((self.nb, 4, 3), dtype=torch.int32, device=self.device)
            recon = self._recon_inter(pred_full, pred_q, sel[0], sel[1], sel[2])
            out = self._outputs(cur, s["mv"], sub_mv, sel, recon)
            out["g_next"] = s["g_next"]
            return out
        if not self.vbs:
            s = K.full_search(cur, torch.stack(refs), cfg.search_range, self.bs)
            # blocks without a valid candidate take mv = (0, 0, 0) against 128s
            pred_full = torch.where(s["ok"][:, None, None], blockify(s["pred"], self.bs).to(torch.int32), 128)
            sel = self._select(cur_blocks - pred_full, None, s["sad"], None, 1, ok=s["ok"])
            recon = self._recon_inter(pred_full, None, sel[0], sel[1], sel[2])
            sub_mv = torch.zeros((self.nb, 4, 3), dtype=torch.int32, device=self.device)
            return self._outputs(cur, s["mv"], sub_mv, sel, recon)
        planes = self._planes(refs, initial)
        s = K.full_search_fme_vbs(cur, planes, cfg.search_range, self.bs)
        # the winners' pixels (case A wherever ok); no valid candidate: 128s
        pf, pq = K.pred_fetch_fme_vbs(s["mv"], s["sub_mv"], planes, self.bs)
        pred_full = torch.where(s["ok"][:, None, None], blockify(pf, self.bs).to(torch.int32), 128)
        pred_q = torch.where(s["sub_ok"][:, :, None, None], quads_px(pq, self.bs).to(torch.int32), 128)
        sel = self._select(cur_blocks - pred_full, split_quads(cur_blocks) - pred_q, s["sad"], s["sub_sad"], 1,
                           ok=s["ok"], sub_ok=s["sub_ok"])
        recon = self._recon_inter(pred_full, pred_q, sel[0], sel[1], sel[2])
        return self._outputs(cur, s["mv"], s["sub_mv"], sel, recon)

    # ------------------------------------------------------------ encode
    def _encode_pass(self):
        cfg = self.cfg
        ftypes: list[int] = []
        per_frame: list[dict] = []
        refs = [self._plane128()]
        initial = True
        self.fast_me_passes = []
        g_carry = None  # fast ME: the last inter frame's converged MVPs warm-start the next
        for i in range(cfg.frames):
            cur = self._y_dev[i]
            if i % cfg.intra_dur == 0:
                out, ftype = self._intra_step(cur), 0
            else:
                out, ftype = self._inter_step(cur, refs, initial, g_carry), 1
                g_carry = out.pop("g_next", None)
            ftypes.append(ftype)
            per_frame.append(out)
            if i < cfg.frames - 1:
                if ftype == 0:
                    refs = []
                if len(refs) >= cfg.n_ref_frames:
                    refs.pop(0)
                refs.append(out["recon"])
                initial = False
        return per_frame, ftypes

    def encode(self, package: bool = True) -> dict:
        """Encode the clip.  ``package=False`` leaves the per-frame outputs as
        device tensors under "per_frame" instead of building the list-form
        "MVS per Frame" / "approx residual" interchange."""
        if self._y_dev is None:
            raise ValueError("construct with y_frames to encode")
        cfg = self.cfg
        per_frame, ftypes = self._encode_pass()
        stats = torch.stack([torch.stack([o["psnr"], o["mae"]]) for o in per_frame]).cpu().numpy()
        sizes = torch.stack([o["size"] for o in per_frame]).cpu().numpy()
        pkg = {
            "block size": self.bs,
            "num frames": cfg.frames,
            "height in pixels": self.h,
            "width in pixels": self.w,
            "search range": cfg.search_range,
            "PSNR per frame": [float(v) for v in stats[:, 0]],
            "MAE per Frame": [float(v) for v in stats[:, 1]],
            "frame_type_seq": ftypes,
            "Qp_per_row_per_frame": [[] for _ in ftypes],
            "residual size per frame": [int(v) for v in sizes],
            "reconstructed frames": torch.stack([o["recon"] for o in per_frame]).cpu().numpy(),
        }
        if cfg.fast_me:
            pkg["fast_me_passes"] = list(self.fast_me_passes)
        if package:
            pkg["MVS per Frame"] = [mvs_to_list(o, ft, self.nb) for o, ft in zip(per_frame, ftypes)]
            pkg["approx residual"] = [res_to_list(o, self.nb) for o in per_frame]
        else:
            pkg["per_frame"] = per_frame
        return pkg

    # ------------------------------------------------------------ decode
    def decode(self, frame_types, residuals_per_frame, qp_rows_per_frame, mvs_per_frame) -> list:
        """Decode list- or array-form interchange (the bitstream readers'
        output) into a list of (h, w) uint8 device tensors."""
        cfg = self.cfg
        n, nb, bs, s = len(frame_types), self.nb, self.bs, self.sbs
        # host pass: pack the clip's MVs, split flags and coefficients for
        # one upload each.  A block is split or not, so its full-block and
        # quad coefficients share one (bs, bs) payload slot.
        mv_all = np.zeros((n, nb, 3), np.int32)
        smv_all = np.zeros((n, nb, 4, 3), np.int32)
        split_all = np.zeros((n, nb), bool)
        pay_all = np.zeros((n, nb, bs, bs), np.int16)
        nref = 1  # length of the decoder's reference FIFO at frame i
        for i in range(n):
            ft = int(frame_types[i])
            mv_np, split_np, smv_np = list_to_mvs_np(mvs_per_frame[i], ft, nb)
            if ft == 0:
                mv_all[i, :, 0] = mv_np
                smv_all[i, :, :, 0] = smv_np
            else:
                refs_used = np.concatenate([mv_np[:, 2], smv_np[:, :, 2].reshape(-1)])
                if refs_used.min(initial=0) < 0 or refs_used.max(initial=0) >= nref:
                    raise ValueError(f"corrupt stream: frame {i} references a frame outside "
                                     f"its {nref}-frame reference list")
                mv_all[i] = mv_np
                smv_all[i] = smv_np
            split_all[i] = split_np
            qf, qq = list_to_res_np(residuals_per_frame[i], nb, bs, s)
            pay_all[i] = qf
            if split_np.any():
                merged = qq.reshape(nb, 2, 2, s, s).swapaxes(2, 3).reshape(nb, bs, bs)
                pay_all[i][split_np] = merged[split_np]
            nref = 1 if ft == 0 else min(nref + 1, cfg.n_ref_frames)
        d_mv, d_split, d_pay = (torch.from_numpy(a).to(self.device) for a in (mv_all, split_all, pay_all))
        d_smv = torch.from_numpy(smv_all).to(self.device) if self.vbs else None  # read only under VBS

        out = []
        refs = [self._plane128()]
        initial = True
        for i in range(n):
            qf, qq = unpack_payload(d_split[i], d_pay[i], self.vbs)
            if int(frame_types[i]) == 0:
                f = self._recon_intra(d_mv[i, :, 0], d_split[i], d_smv[i, :, :, 0] if self.vbs else None, qf, qq)
                refs = []
            elif self.vbs:
                pf, pq = K.pred_fetch_fme_vbs(d_mv[i], d_smv[i], self._planes(refs, initial), bs)
                f = self._recon_inter(blockify(pf, bs).to(torch.int32), quads_px(pq, bs).to(torch.int32),
                                      d_split[i], qf, qq)
            else:
                pred = K.pred_fetch(d_mv[i], torch.stack(refs), bs)
                f = self._recon_inter(blockify(pred, bs).to(torch.int32), None, d_split[i], qf, qq)
            out.append(f)
            if i < n - 1:
                if len(refs) >= cfg.n_ref_frames:
                    refs.pop(0)
                refs.append(f)
                initial = False
        return out


# ------------------------------------------------ interchange (module level)
def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
