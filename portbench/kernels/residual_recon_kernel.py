"""``residual_recon_kernel`` (csrc/residual_recon.cu): a frame's
dequantization and inverse DCT, and an inter frame's reconstruction from
its prediction planes, one launch per frame (encode and decode).

An intra frame reads both coefficient sets (int32 in the encode, int16 in
the decode) and QPs and writes int32 residuals; its operations are both
IDCTs' multiply-adds.  An inter frame reads the coefficients and int16
prediction pixels of the variant each block uses, the QPs and flags (the
split flags with VBS; the ok flags where the full search gives them) and
writes the uint8 frame; its operations are the IDCT of each block's
variant, from the segment's split count.
"""
from __future__ import annotations

from portbench.kernels._shapes import dims, nth_frame


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    i = nth_frame(frames, launch["nth"])
    if i is None:
        return None
    vbs = bool(cfg.get("vbs_enable"))
    encode = launch["span"] == "encode"
    cb = 4 if encode else 2
    pxb = bs * bs
    if frames[i]["type"] == 0:
        nvar = 2 if vbs else 1
        return nvar * nb * pxb * (cb + 4) + nb * 4, nb * pxb * 2 * (bs + (bs // 2 if vbs else 0))
    full_search = encode and not cfg.get("fast_me")
    flags = (nb if vbs else 0) + (nb if full_search else 0) + (4 * nb if full_search and vbs else 0)
    nsplit = frames[i]["nsplit"] if vbs else 0
    ops = (nb - nsplit) * pxb * 2 * bs + nsplit * pxb * 2 * (bs // 2)
    return nb * pxb * (cb + 2) + nb * 4 + flags + px, ops
