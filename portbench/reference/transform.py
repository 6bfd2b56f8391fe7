"""The native engine's exact fixed-point 2D DCT-II / IDCT (int32 results).

A frozen copy of the port's plain transform (``core/transform.py``'s
``dct2_int`` / ``idct2_int``), which the port's CPU tests hold bit-exact to
the JAX package.  The orthonormal DCT matrix is rounded to 17-bit fixed
point, ``A = round(D * 2**17)``, and applied in two passes with exact
round-half-even rescaling between them.

Exactness of the products.  Each integer product runs as a float64 matmul
on integer-valued operands.  That is exact: every operand is an integer
with |A| <= 46341 < 2**15.5 and |X| <= 2**11 (after the splits below), so
every product is an integer below 2**26.5 and every partial sum below 2**31
in magnitude, far inside float64's 53-bit integer range.

``dct2_float32`` / ``idct2_float32`` are the benchmark's lower-precision
control, not the codec: the orthonormal transform computed in float32
(``D @ X @ D.T`` with the float32-rounded matrix, TF32 off) and rounded
half to even, in place of the exact fixed-point arithmetic the codec states.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .quant import rhe_shift_right

SCALE_BITS = 17


def dct_matrix_f64(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, nearest-float64 entries (scipy convention)."""
    i = np.arange(n)
    d = np.cos(np.pi * (2 * i[None, :] + 1) * i[:, None] / (2 * n)) * np.sqrt(2.0 / n)
    d[0, :] = np.sqrt(1.0 / n)
    return d


@functools.lru_cache(maxsize=None)
def dct_matrix_fixed(n: int, scale_bits: int = SCALE_BITS) -> np.ndarray:
    """Fixed-point DCT matrix ``A = round(D * 2**scale_bits)`` as int32."""
    return np.round(dct_matrix_f64(n) * (1 << scale_bits)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int, device: torch.device) -> torch.Tensor:
    """The fixed-point DCT matrix ``A`` as float64 on ``device`` (cached)."""
    return torch.from_numpy(dct_matrix_fixed(n).astype(np.float64)).to(device)


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul via float64 (see the module docstring's bound)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _round_half_even_from_parts(q_hi, inner, inner_bits: int):
    """round-half-even of ``q_hi + inner / 2**inner_bits`` (inner may be negative)."""
    qt = q_hi + (inner >> inner_bits)
    rr = inner & ((1 << inner_bits) - 1)
    half = 1 << (inner_bits - 1)
    inc = (rr > half) | ((rr == half) & ((qt & 1) == 1))
    return qt + inc.to(qt.dtype)


def dct2_int(x: torch.Tensor) -> torch.Tensor:
    """Exact fixed-point 2D DCT-II of int blocks ``(..., n, n)``, ``|x| <= 512``."""
    x = x.to(torch.int32)
    a = dct_matrix(x.shape[-1], x.device)
    # pass 1: M = A @ X, scale 2**17, |M| <= 16*46341*512 = 2**28.5
    m = _imatmul(a, x)
    # drop 6 fraction bits: M1 scale 2**11, |M1| <= 2**22
    m1 = rhe_shift_right(m, 6)
    # pass 2 split at 11 bits: |Sh|, |Sl| <= 16*2048*46341 = 2**30.5
    mh = m1 >> 11
    ml = m1 - (mh << 11)
    sh = _imatmul(mh, a.T)
    sl = _imatmul(ml, a.T)
    # T = rhe((Sh*2**11 + Sl) / 2**28)
    q = sh >> 17
    r = sh - (q << 17)
    inner = (r << 11) + sl  # <= 2**28 + 2**30.5 < 2**31
    return _round_half_even_from_parts(q, inner, 28)


def idct2_int(t: torch.Tensor) -> torch.Tensor:
    """Exact fixed-point 2D IDCT of int coefficients ``(..., n, n)``, ``|t| <= 12288``."""
    t = t.to(torch.int32)
    a = dct_matrix(t.shape[-1], t.device)
    # split the (14-bit) input so pass 1 stays in int32
    th = t >> 7
    tl = t - (th << 7)
    # P = A^T @ Th, Q = A^T @ Tl: |.| <= 16*46341*128 = 2**26.5
    p = _imatmul(a.T, th)
    qm = _imatmul(a.T, tl)
    # M1 = rhe((P*2**7 + Q) / 2**11): scale 2**6, |M1| <= 2**21.6
    q1 = p >> 4
    r1 = p - (q1 << 4)
    m1 = _round_half_even_from_parts(q1, (r1 << 7) + qm, 11)
    # pass 2 split at 11 bits: |Sh| <= 2**30.1, |Sl| <= 2**30.5
    mh = m1 >> 11
    ml = m1 - (mh << 11)
    sh = _imatmul(mh, a)
    sl = _imatmul(ml, a)
    # out = rhe((Sh*2**11 + Sl) / 2**23)
    q = sh >> 12
    r = sh - (q << 12)
    inner = (r << 11) + sl  # <= 2**23 + 2**30.5 < 2**31
    return _round_half_even_from_parts(q, inner, 23)


@functools.lru_cache(maxsize=None)
def _dct_matrix_float32(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dct_matrix_f64(n)).to(device=device, dtype=torch.float32)


def dct2_float32(x: torch.Tensor) -> torch.Tensor:
    """The control's forward transform: float32, rounded half to even."""
    d = _dct_matrix_float32(x.shape[-1], x.device)
    return torch.round(d @ x.to(torch.float32) @ d.T).to(torch.int32)


def idct2_float32(t: torch.Tensor) -> torch.Tensor:
    """The control's inverse transform: float32, rounded half to even."""
    d = _dct_matrix_float32(t.shape[-1], t.device)
    return torch.round(d.T @ t.to(torch.float32) @ d).to(torch.int32)
