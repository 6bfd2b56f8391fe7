"""Transform + quantize + coded length per block (the non-VBS RD branch).

Twin of ``streamoptima_tpu.core.rd.transform_and_select`` with
``vbs_enable=False``: no split decision exists, so every block keeps its
full-block coefficients quantized at its own QP.  The VBS branch (quad
transform at QP-1 and the ``lam * bits + MAE`` split decision) is not ported
yet and raises.
"""
from __future__ import annotations

import torch

from streamoptima_tpu_torch.core.quant import quantize
from streamoptima_tpu_torch.core.transform import dct2_int
from streamoptima_tpu_torch.core.zigzag import rle_length


def transform_and_select(res_full, sad_full, qps_blocks, *, bs: int, sbs: int,
                         vbs_enable: bool = False, ok_full=None):
    """DCT, quantize at the per-block QPs, and measure the coded lengths.

    res_full: (nb, bs, bs) int; sad_full: (nb,) int32; qps_blocks: (nb,)
    int32 or an int.  Returns (split (nb,) bool, qtc_full (nb, bs, bs) int32,
    qtc_quads (nb, 4, sbs, sbs) zeros, lens (nb,) int32, mae (nb,) float32).
    Blocks without a valid search candidate (``ok_full`` False) carry
    MAE = +inf, as in the reference.
    """
    if vbs_enable:
        raise NotImplementedError("vbs_enable: the VBS split decision is not ported yet")
    nb = res_full.shape[0]
    tf = dct2_int(res_full)
    mae = sad_full.to(torch.float32) / (bs * bs)
    if ok_full is not None:
        mae = torch.where(ok_full, mae, torch.full_like(mae, float("inf")))
    qtc_full = quantize(tf, qps_blocks)
    lens = rle_length(qtc_full)
    split = torch.zeros(nb, dtype=torch.bool, device=res_full.device)
    qtc_quads = torch.zeros((nb, 4, sbs, sbs), dtype=qtc_full.dtype, device=res_full.device)
    return split, qtc_full, qtc_quads, lens, mae
