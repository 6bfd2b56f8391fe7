"""PyTorch engine: per-frame encode/decode steps on one device.

``TorchCodec`` is the counterpart of ``streamoptima_tpu.jax_engine.JaxCodec``
for the main path: I/P frames (an intra frame every ``intra_dur``), whole-pel
full search over one reference frame, mode-0 intra, no VBS / FME / fast ME /
rate control.  On a CUDA device the inter search runs the ``full_search``
kernel (which also returns the winner's pixels) and decode predicts through
the ``pred_fetch`` kernel; on the CPU both take their plain PyTorch versions.
Every value it produces is bit-identical to the JAX engine's on the same
input and config (MVs, coefficients, sizes, reconstructions).

Configurations outside the slice raise ``NotImplementedError`` naming the
feature; ``engine='compat'`` (the host reference engine) raises
``ValueError``.  Neither is a fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from streamoptima_tpu.config import CodecConfig
from streamoptima_tpu_torch import metrics
from streamoptima_tpu_torch.core import intra as I
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import rd
from streamoptima_tpu_torch.core.blocks import blockify, unblockify
from streamoptima_tpu_torch.core.pred import wrap_uint8
from streamoptima_tpu_torch.core.quant import rescale
from streamoptima_tpu_torch.core.transform import idct2_int

#: per-frame arrays that cross between this engine and the JAX engine
STATE_KEYS = ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "recon")


def check_slice(cfg: CodecConfig) -> None:
    """Refuse, by name, every configuration the port does not run yet."""
    if cfg.compat:
        raise ValueError("engine='compat' is the host reference engine; TorchCodec ports engine='jax'")
    unported = {
        "vbs_enable": cfg.vbs_enable,
        "fme_enable": cfg.fme_enable,
        "fast_me": cfg.fast_me,
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
    """PyTorch encoder/decoder for the main path, on an explicit ``device``."""

    def __init__(self, cfg: CodecConfig, y_frames=None, *, device):
        check_slice(cfg)
        self.cfg = cfg
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

    # ------------------------------------------------------------ shared
    def _plane128(self) -> torch.Tensor:
        return torch.full((self.h, self.w), 128, dtype=torch.uint8, device=self.device)

    def _dequant(self, qtc_full: torch.Tensor) -> torch.Tensor:
        return idct2_int(rescale(qtc_full.to(torch.int32), self.qps))

    def _recon_inter(self, pred_full: torch.Tensor, qtc_full: torch.Tensor) -> torch.Tensor:
        blocks = wrap_uint8(pred_full + self._dequant(qtc_full))
        return unblockify(blocks, self.h, self.w)

    def _recon_intra(self, mv: torch.Tensor, qtc_full: torch.Tensor) -> torch.Tensor:
        frame = I.intra_reconstruct_mode0(self._dequant(qtc_full), mv, self.h, self.w, self.bs,
                                          self.cfg.search_range)
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
        s = I.intra_search_mode0(work, self.bs, cfg.search_range, cfg.intra_canvas[1])
        res_full = I.intra_residuals_mode0(work, s["mv"], self.bs, cfg.search_range)
        sel = rd.transform_and_select(res_full, s["sad"].reshape(-1), self.qps, bs=self.bs, sbs=self.sbs)
        mv = s["mv"].reshape(-1)
        recon = self._recon_intra(mv, sel[1])
        sub_mv = torch.zeros((self.nb, 4), dtype=torch.int32, device=self.device)
        return self._outputs(cur, mv, sub_mv, sel, recon)

    def _inter_step(self, cur: torch.Tensor, refs: torch.Tensor) -> dict:
        s = K.full_search(cur, refs, self.cfg.search_range, self.bs)
        # blocks without a valid candidate take mv = (0, 0, 0) against 128s
        pred_full = torch.where(s["ok"][:, None, None], blockify(s["pred"], self.bs).to(torch.int32), 128)
        res_full = blockify(cur, self.bs).to(torch.int32) - pred_full
        sel = rd.transform_and_select(res_full, s["sad"], self.qps, bs=self.bs, sbs=self.sbs, ok_full=s["ok"])
        recon = self._recon_inter(pred_full, sel[1])
        sub_mv = torch.zeros((self.nb, 4, 3), dtype=torch.int32, device=self.device)
        return self._outputs(cur, s["mv"], sub_mv, sel, recon)

    # ------------------------------------------------------------ encode
    def _encode_pass(self):
        cfg = self.cfg
        ftypes: list[int] = []
        per_frame: list[dict] = []
        refs = [self._plane128()]
        for i in range(cfg.frames):
            cur = self._y_dev[i]
            if i % cfg.intra_dur == 0:
                out, ftype = self._intra_step(cur), 0
            else:
                out, ftype = self._inter_step(cur, torch.stack(refs)), 1
            ftypes.append(ftype)
            per_frame.append(out)
            if i < cfg.frames - 1:
                if ftype == 0:
                    refs = []
                if len(refs) >= cfg.n_ref_frames:
                    refs.pop(0)
                refs.append(out["recon"])
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
        n, nb, bs = len(frame_types), self.nb, self.bs
        # host pass: pack the clip's MVs, split flags and full-block
        # coefficients for one upload each
        mv_all = np.zeros((n, nb, 3), np.int32)
        split_all = np.zeros((n, nb), bool)
        qf_all = np.zeros((n, nb, bs, bs), np.int16)
        nref = 1  # length of the decoder's reference FIFO at frame i
        for i in range(n):
            ft = int(frame_types[i])
            mv_np, split_np, _ = list_to_mvs_np(mvs_per_frame[i], ft, nb)
            if ft == 0:
                mv_all[i, :, 0] = mv_np
            else:
                refs_used = mv_np[:, 2]
                if refs_used.min(initial=0) < 0 or refs_used.max(initial=0) >= nref:
                    raise ValueError(f"corrupt stream: frame {i} references a frame outside "
                                     f"its {nref}-frame reference list")
                mv_all[i] = mv_np
            split_all[i] = split_np
            qf_all[i] = list_to_res_np(residuals_per_frame[i], nb, bs, self.sbs)[0]
            nref = 1 if ft == 0 else min(nref + 1, cfg.n_ref_frames)
        d_mv, d_split, d_qf = (torch.from_numpy(a).to(self.device) for a in (mv_all, split_all, qf_all))

        out = []
        refs = [self._plane128()]
        for i in range(n):
            qf = unpack_payload(d_split[i], d_qf[i])
            if int(frame_types[i]) == 0:
                f = self._recon_intra(d_mv[i, :, 0], qf)
                refs = []
            else:
                pred = K.pred_fetch(d_mv[i], torch.stack(refs), bs)
                f = self._recon_inter(blockify(pred, bs).to(torch.int32), qf)
            out.append(f)
            if i < n - 1:
                if len(refs) >= cfg.n_ref_frames:
                    refs.pop(0)
                refs.append(f)
        return out


# ------------------------------------------------ interchange (module level)
def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def unpack_payload(sp: torch.Tensor, qf: torch.Tensor) -> torch.Tensor:
    """Decoded full-block coefficients -> qtc_full on the device: split
    blocks read 0, as in the JAX ``_unpack_payload``.  The non-VBS recon
    uses no quads, so their half of the unpack waits for VBS decode."""
    return torch.where(sp[:, None, None], 0, qf)


def frame_arrays_of(out: dict, ftype: int):
    """One per-frame output -> the array interchange (bitstream.FrameMVArrays,
    FrameResArrays) that ``bitstream.write_bitstream`` serializes."""
    from streamoptima_tpu.bitstream import FrameMVArrays, FrameResArrays, widen_mvs

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
    from streamoptima_tpu.bitstream import FrameMVArrays

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
    from streamoptima_tpu.bitstream import FrameResArrays

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
