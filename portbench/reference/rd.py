"""RD mode decision + quantization: coded lengths and the VBS split.

Twin of ``streamoptima_tpu.core.rd.transform_and_select`` (calculate_RD_cost,
Encoder.py:1133-1158, applied per block).  Both the full-block and, under
VBS, the 4-quad encodings are transformed once; their coded bit counts come
from the RLE lengths, and a block splits when ``lam * bits + MAE`` of the
quads is not worse than the full block's (quads quantized at QP-1,
Encoder.py:527 / 1293).  The decision uses the nominal QP; the final
coefficients are quantized at the per-block QPs.  The RD costs are float32
like the JAX engine's: MAEs are exact multiples of 1/64, and
``lam * bits + MAE`` is one float32 multiply and one add.
"""
from __future__ import annotations

import torch

from .quant import qp_minus_1, quantize
from .transform import dct2_int
from .zigzag import rle_length


def transform_and_select(res_full, res_quads, sad_full, sad_quads, frame_type: int, qps_blocks, *,
                         qp_nominal: int, lam, vbs_enable: bool, vbs_eligible, bs: int, sbs: int,
                         ok_full=None, ok_quads=None, dct2=dct2_int):
    """DCT both variants once, RD-select, quantize at the per-block QPs.

    res_full: (nb, bs, bs) int; res_quads: (nb, 4, sbs, sbs) int or None
    without VBS; sad_full: (nb,) int32; sad_quads: (nb, 4) int32 or None;
    qps_blocks: (nb,) int32; vbs_eligible: (nb,) bool (non-border blocks).
    Returns (split (nb,) bool, qtc_full (nb, bs, bs) int32, qtc_quads (nb, 4,
    sbs, sbs) int32 (zeros without VBS), lens (nb,) int32 coded lengths of
    the chosen variant, mae (nb,) float32).

    ``dct2``: the forward transform (the exact ``dct2_int``; the benchmark's
    control passes its float32 one).

    Blocks without a valid search candidate (``ok_full`` / ``ok_quads``
    False) carry MAE = +inf, as in the reference: inf < inf is False, so a
    block with no valid candidate still splits under VBS.
    """
    nb = res_full.shape[0]
    dev = res_full.device
    tf = dct2(res_full)
    mae_full = sad_full.to(torch.float32) / (bs * bs)
    if ok_full is not None:
        mae_full = torch.where(ok_full, mae_full, torch.full_like(mae_full, float("inf")))
    qtc_full = quantize(tf, qps_blocks)
    lens_full = rle_length(qtc_full)
    if not vbs_enable:
        split = torch.zeros(nb, dtype=torch.bool, device=dev)
        qtc_quads = torch.zeros((nb, 4, sbs, sbs), dtype=qtc_full.dtype, device=dev)
        return split, qtc_full, qtc_quads, lens_full, mae_full
    if res_quads is None or sad_quads is None or vbs_eligible is None:
        raise ValueError("vbs_enable needs res_quads, sad_quads and vbs_eligible")
    tq = dct2(res_quads)
    base, base_v = (8, 32) if frame_type == 0 else (16, 64)
    bits_bs = base + 8 * rle_length(quantize(tf, int(qp_nominal)))
    bits_vbs = base_v + 8 * rle_length(quantize(tq, qp_minus_1(int(qp_nominal)))).sum(dim=1)
    mae_q = sad_quads.to(torch.float32) / (sbs * sbs)
    if ok_quads is not None:
        mae_q = torch.where(ok_quads, mae_q, torch.full_like(mae_q, float("inf")))
    vbs_mae = mae_q.sum(dim=1) / 4.0
    rd_bs = lam * bits_bs.to(torch.float32) + mae_full
    rd_vbs = lam * bits_vbs.to(torch.float32) + vbs_mae
    split = ~(rd_bs < rd_vbs) & vbs_eligible
    qtc_quads = quantize(tq, qp_minus_1(qps_blocks)[:, None])
    lens = torch.where(split, rle_length(qtc_quads).sum(dim=1, dtype=torch.int32), lens_full)
    mae = torch.where(vbs_eligible, vbs_mae, mae_full)
    return split, qtc_full, qtc_quads, lens, mae
