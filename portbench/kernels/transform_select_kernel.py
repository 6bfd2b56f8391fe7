"""``transform_select_kernel`` (csrc/transform_select.cu): an encoded
frame's DCT, RD split, quantization and coded lengths, one launch per
encoded frame.

Bytes: the int32 residuals, SADs, QPs and (an inter frame's) ok flags read
once, with VBS the quads' too and the eligibility flags; the split flags,
lengths, MAEs and both int32 coefficient sets written.  Operations: the
int64 multiply-adds of both passes of each DCT.
"""
from __future__ import annotations

from portbench.kernels._shapes import dims, nth_frame


def count(launch: dict, cfg: dict, frames: list) -> tuple[int, int] | None:
    h, w, bs, nb, px = dims(cfg)
    i = nth_frame(frames, launch["nth"])
    if i is None:
        return None
    vbs, inter = bool(cfg.get("vbs_enable")), frames[i]["type"] == 1
    res = nb * bs * bs
    n_in = res * 4 + nb * 8 + (nb if inter else 0)
    if vbs:
        n_in += res * 4 + nb * 16 + nb + (4 * nb if inter else 0)
    return n_in + nb * (1 + 8) + 2 * res * 4, res * 2 * (bs + (bs // 2 if vbs else 0))
