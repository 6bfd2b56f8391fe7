"""Quantization by exact round-half-even power-of-two shifts.

Twin of ``streamoptima_tpu.core.quant``: ``Q[x, y] = 2**(qp + band)`` with
band 0 / 1 / 2 below / on / above the anti-diagonal, so quantization is a
round-half-even arithmetic right shift and rescaling a left shift, both in
pure integer ops (bit-identical on every device).  VBS quads are quantized
at QP-1 (``qp_minus_1``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def q_exponent_matrix(n: int) -> np.ndarray:
    """Band exponents: 0 if x+y < n-1, 1 if == n-1, else 2 (Encoder.py:938-945)."""
    i = np.add.outer(np.arange(n), np.arange(n))
    return np.where(i < n - 1, 0, np.where(i == n - 1, 1, 2)).astype(np.int32)


def qp_minus_1(qp):
    """Sub-block QP: QP-1 floored at 0 (Q vs Qm1, Encoder.py:57-59, :71-76);
    ``qp`` an int or an int tensor."""
    if isinstance(qp, int):
        return qp - 1 if qp > 0 else qp
    return torch.where(qp > 0, qp - 1, qp)


@functools.lru_cache(maxsize=None)
def band_exponents(n: int, device: torch.device) -> torch.Tensor:
    """(n, n) int32 band exponents on ``device`` (cached once per device)."""
    return torch.from_numpy(q_exponent_matrix(n)).to(device)


def rhe_shift_right(num: torch.Tensor, k) -> torch.Tensor:
    """round-half-even(num / 2**k) for int tensors; ``k`` int or int tensor >= 0.

    Arithmetic right shift floors and ``num - (q << k)`` is the non-negative
    remainder, so the half-even adjustment is exact for negative ``num``.
    """
    if isinstance(k, int):
        if k == 0:
            return num
        q = num >> k
        r = num - (q << k)
        half = 1 << (k - 1)
        inc = (r > half) | ((r == half) & ((q & 1) == 1))
        return q + inc.to(num.dtype)
    kc = k.clamp(min=1)
    q = num >> kc
    r = num - (q << kc)
    half = torch.ones_like(kc) << (kc - 1)
    inc = (r > half) | ((r == half) & ((q & 1) == 1))
    return torch.where(k == 0, num, q + inc.to(num.dtype))


def _exponents(x: torch.Tensor, qp) -> torch.Tensor | int:
    band = band_exponents(x.shape[-1], x.device)
    if isinstance(qp, int):
        return band + qp
    return band + qp[..., None, None]


def quantize(tc: torch.Tensor, qp) -> torch.Tensor:
    """QTC = round-half-even(TC / 2**(qp + band)); ``qp`` int or per-block (...,)."""
    return rhe_shift_right(tc, _exponents(tc, qp))


def rescale(qtc: torch.Tensor, qp) -> torch.Tensor:
    """QTC * Q as exact left shifts."""
    return qtc << _exponents(qtc, qp)
