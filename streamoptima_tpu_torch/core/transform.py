"""2D DCT-II / IDCT: the native engine's exact fixed-point transform and the
compat engine's scipy-exact float64 transform.

``dct2_int`` / ``idct2_int`` (int32 results, bit-identical everywhere):

Twin of ``streamoptima_tpu.core.transform.dct2_int`` / ``idct2_int``: the
orthonormal DCT matrix rounded to 17-bit fixed point, ``A = round(D * 2**17)``
(``dct_matrix_fixed``), applied in two passes with exact round-half-even
rescaling between them.  Every shift, split and rounding step below is the
JAX package's, on int32 tensors.

Exactness of the products.  CUDA has no int32 matmul and a float32 product is
not exact here (products reach 2**28.5, sums 2**30.5), so each integer product
runs as a float64 matmul on integer-valued operands.  That is exact: every
operand is an integer with |A| <= 46341 < 2**15.5 and |X| <= 2**11 (after the
splits below), so every product is an integer below 2**26.5 and every partial
sum of the 16-term dot products an integer below 2**31 in magnitude — far
inside float64's 53-bit integer range.  Each partial sum is therefore
represented exactly whatever the summation order or FMA use, and the final
conversion to int32 is exact.  The pass bounds are the JAX package's, restated
at each step.

``dct2_scipy`` / ``idct2_scipy`` (the compat engine's): the plain versions
of the ``dct_scipy`` kernel (core/kernels.py), twins of the JAX package's
host ``dct2_scipy`` / ``idct2_scipy``, which call
``scipy.fftpack.dct/idct(norm="ortho")`` along axis -2, then axis -1, and
round half to even.  A float64 matmul does not reproduce those: where a
coefficient's exact value is a half-integer, scipy's rounding direction
depends on pocketfft's order of operations.  So these replay pocketfft's
float64 arithmetic operation for operation: ``T_dcst23`` (the DCT-II /
DCT-III as a pre- and post-twiddled length-n real FFT) over ``rfftp``'s
radix-4 and radix-2 passes, with pocketfft's twiddles and scale factor.
Each add and multiply is its own tensor op, so nothing fuses or reorders,
and the float64 results before rounding equal scipy's bit for bit on any
device (``dct2_scipy_f64`` / ``idct2_scipy_f64``).  Block sizes are powers
of two.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from streamoptima_tpu_torch.core.quant import rhe_shift_right

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


# ---------------------------------------------------------------------------
# scipy-exact float64 transform: pocketfft's arithmetic, one tensor op each
#
# A transform of length n runs on ``c``, a list of n tensors: c[k] holds the
# k-th sample of every line being transformed.  Names follow pocketfft
# (pocketfft_hdronly.hpp: sincos_2pibyn, rfftp::radf2/radf4/radb2/radb4,
# rfftp::exec, T_dcst23::exec).

_SQRT2 = math.sqrt(2.0)  # pocketfft's sqrt2 and hsqt2, correctly rounded
_HSQT2 = math.sqrt(0.5)


def _unity_roots(n: int):
    """pocketfft's ``sincos_2pibyn(n)``: root k = (cos, sin)(2 pi k / n), from
    two tables of octant-reduced values multiplied in float64."""
    ang = 0.25 * math.pi / n  # Thigh(0.25L * pi / n): exact scaling for powers of two

    def calc(x: int):
        x <<= 3
        if x < 4 * n:
            if x < 2 * n:
                if x < n:
                    return math.cos(x * ang), math.sin(x * ang)
                return math.sin((2 * n - x) * ang), math.cos((2 * n - x) * ang)
            x -= 2 * n
            if x < n:
                return -math.sin(x * ang), math.cos(x * ang)
            return -math.cos((2 * n - x) * ang), math.sin((2 * n - x) * ang)
        x = 8 * n - x
        if x < 2 * n:
            if x < n:
                return math.cos(x * ang), -math.sin(x * ang)
            return math.sin((2 * n - x) * ang), -math.cos((2 * n - x) * ang)
        x -= 2 * n
        if x < n:
            return -math.sin(x * ang), -math.cos(x * ang)
        return -math.cos((2 * n - x) * ang), -math.sin((2 * n - x) * ang)

    nval = (n + 2) // 2
    shift = 1
    while (1 << shift) * (1 << shift) < nval:
        shift += 1
    mask = (1 << shift) - 1
    v1 = [(1.0, 0.0)] + [calc(i) for i in range(1, mask + 1)]
    v2 = [(1.0, 0.0)] + [calc(i * (mask + 1)) for i in range(1, (nval + mask) // (mask + 1))]

    def root(idx: int):
        neg = 2 * idx > n
        if neg:
            idx = n - idx
        (ar, ai), (br, bi) = v1[idx & mask], v2[idx >> shift]
        im = ar * bi + ai * br
        return ar * br - ai * bi, -im if neg else im

    return root


def _factors(n: int) -> list[int]:
    """rfftp's factorization of a power of two: radix 4s, and a radix 2 first."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"the scipy-exact transform takes power-of-two block sizes, got {n}")
    f, m = [], n
    while m % 4 == 0:
        f.append(4)
        m //= 4
    if m == 2:
        f.append(2)
        f[0], f[-1] = f[-1], f[0]
    return f


@functools.lru_cache(maxsize=None)
def scipy_plan(n: int) -> dict:
    """pocketfft's plan for a length-n DCT-II / III: the rfft's factors and
    each pass's twiddles (rfftp::comp_twiddle), the DCT twiddles
    (T_dcst23: the real parts of the 4n-th roots 1..n) and the ortho scale
    1 / sqrt(2n) (norm_fct in long double, rounded to float64)."""
    fac = _factors(n)
    root = _unity_roots(n)
    tws, l1 = [], 1
    for k, ip in enumerate(fac):
        ido = n // (l1 * ip)
        tw = [0.0] * ((ip - 1) * (ido - 1))
        if k < len(fac) - 1:
            for j in range(1, ip):
                for i in range(1, (ido - 1) // 2 + 1):
                    tw[(j - 1) * (ido - 1) + 2 * i - 2], tw[(j - 1) * (ido - 1) + 2 * i - 1] = root(j * l1 * i)
        tws.append(tw)
        l1 *= ip
    root4 = _unity_roots(4 * n)
    return {"factors": fac, "rfft_tw": tws, "dct_tw": [root4(i + 1)[0] for i in range(n)],
            "fct": math.sqrt(1.0 / (2 * n))}  # 1/sqrt(2n) is sqrt(2)/2^k or 2^-k: sqrt is correctly rounded


def _radf2(ido, l1, cc, ch, wa):
    def CC(a, b, c):
        return a + ido * (b + l1 * c)

    def CH(a, b, c):
        return a + ido * (b + 2 * c)

    for k in range(l1):
        ch[CH(0, 0, k)] = cc[CC(0, k, 0)] + cc[CC(0, k, 1)]
        ch[CH(ido - 1, 1, k)] = cc[CC(0, k, 0)] - cc[CC(0, k, 1)]
    if ido % 2 == 0:
        for k in range(l1):
            ch[CH(0, 1, k)] = -cc[CC(ido - 1, k, 1)]
            ch[CH(ido - 1, 0, k)] = cc[CC(ido - 1, k, 0)]
    for k in range(l1):
        for i in range(2, ido, 2):
            ic = ido - i
            wr, wi = wa[i - 2], wa[i - 1]
            tr2 = wr * cc[CC(i - 1, k, 1)] + wi * cc[CC(i, k, 1)]
            ti2 = wr * cc[CC(i, k, 1)] - wi * cc[CC(i - 1, k, 1)]
            ch[CH(i - 1, 0, k)] = cc[CC(i - 1, k, 0)] + tr2
            ch[CH(ic - 1, 1, k)] = cc[CC(i - 1, k, 0)] - tr2
            ch[CH(i, 0, k)] = ti2 + cc[CC(i, k, 0)]
            ch[CH(ic, 1, k)] = ti2 - cc[CC(i, k, 0)]


def _radf4(ido, l1, cc, ch, wa):
    def CC(a, b, c):
        return a + ido * (b + l1 * c)

    def CH(a, b, c):
        return a + ido * (b + 4 * c)

    for k in range(l1):
        tr1 = cc[CC(0, k, 3)] + cc[CC(0, k, 1)]
        ch[CH(0, 2, k)] = cc[CC(0, k, 3)] - cc[CC(0, k, 1)]
        tr2 = cc[CC(0, k, 0)] + cc[CC(0, k, 2)]
        ch[CH(ido - 1, 1, k)] = cc[CC(0, k, 0)] - cc[CC(0, k, 2)]
        ch[CH(0, 0, k)] = tr2 + tr1
        ch[CH(ido - 1, 3, k)] = tr2 - tr1
    if ido % 2 == 0:
        for k in range(l1):
            ti1 = -_HSQT2 * (cc[CC(ido - 1, k, 1)] + cc[CC(ido - 1, k, 3)])
            tr1 = _HSQT2 * (cc[CC(ido - 1, k, 1)] - cc[CC(ido - 1, k, 3)])
            ch[CH(ido - 1, 0, k)] = cc[CC(ido - 1, k, 0)] + tr1
            ch[CH(ido - 1, 2, k)] = cc[CC(ido - 1, k, 0)] - tr1
            ch[CH(0, 3, k)] = ti1 + cc[CC(ido - 1, k, 2)]
            ch[CH(0, 1, k)] = ti1 - cc[CC(ido - 1, k, 2)]
    for k in range(l1):
        for i in range(2, ido, 2):
            ic = ido - i
            cr, ci = [], []
            for j in range(3):  # MULPM: conj(w) * (re + i im)
                wr, wi = wa[i - 2 + j * (ido - 1)], wa[i - 1 + j * (ido - 1)]
                re, im = cc[CC(i - 1, k, j + 1)], cc[CC(i, k, j + 1)]
                cr.append(wr * re + wi * im)
                ci.append(wr * im - wi * re)
            tr1, tr4 = cr[2] + cr[0], cr[2] - cr[0]
            ti1, ti4 = ci[0] + ci[2], ci[0] - ci[2]
            tr2, tr3 = cc[CC(i - 1, k, 0)] + cr[1], cc[CC(i - 1, k, 0)] - cr[1]
            ti2, ti3 = cc[CC(i, k, 0)] + ci[1], cc[CC(i, k, 0)] - ci[1]
            ch[CH(i - 1, 0, k)], ch[CH(ic - 1, 3, k)] = tr2 + tr1, tr2 - tr1
            ch[CH(i, 0, k)], ch[CH(ic, 3, k)] = ti1 + ti2, ti1 - ti2
            ch[CH(i - 1, 2, k)], ch[CH(ic - 1, 1, k)] = tr3 + ti4, tr3 - ti4
            ch[CH(i, 2, k)], ch[CH(ic, 1, k)] = tr4 + ti3, tr4 - ti3


def _radb2(ido, l1, cc, ch, wa):
    def CC(a, b, c):
        return a + ido * (b + 2 * c)

    def CH(a, b, c):
        return a + ido * (b + l1 * c)

    for k in range(l1):
        ch[CH(0, k, 0)] = cc[CC(0, 0, k)] + cc[CC(ido - 1, 1, k)]
        ch[CH(0, k, 1)] = cc[CC(0, 0, k)] - cc[CC(ido - 1, 1, k)]
    if ido % 2 == 0:
        for k in range(l1):
            ch[CH(ido - 1, k, 0)] = 2.0 * cc[CC(ido - 1, 0, k)]
            ch[CH(ido - 1, k, 1)] = -2.0 * cc[CC(0, 1, k)]
    for k in range(l1):
        for i in range(2, ido, 2):
            ic = ido - i
            ch[CH(i - 1, k, 0)] = cc[CC(i - 1, 0, k)] + cc[CC(ic - 1, 1, k)]
            tr2 = cc[CC(i - 1, 0, k)] - cc[CC(ic - 1, 1, k)]
            ti2 = cc[CC(i, 0, k)] + cc[CC(ic, 1, k)]
            ch[CH(i, k, 0)] = cc[CC(i, 0, k)] - cc[CC(ic, 1, k)]
            wr, wi = wa[i - 2], wa[i - 1]
            ch[CH(i, k, 1)] = wr * ti2 + wi * tr2
            ch[CH(i - 1, k, 1)] = wr * tr2 - wi * ti2


def _radb4(ido, l1, cc, ch, wa):
    def CC(a, b, c):
        return a + ido * (b + 4 * c)

    def CH(a, b, c):
        return a + ido * (b + l1 * c)

    for k in range(l1):
        tr2 = cc[CC(0, 0, k)] + cc[CC(ido - 1, 3, k)]
        tr1 = cc[CC(0, 0, k)] - cc[CC(ido - 1, 3, k)]
        tr3 = 2.0 * cc[CC(ido - 1, 1, k)]
        tr4 = 2.0 * cc[CC(0, 2, k)]
        ch[CH(0, k, 0)], ch[CH(0, k, 2)] = tr2 + tr3, tr2 - tr3
        ch[CH(0, k, 3)], ch[CH(0, k, 1)] = tr1 + tr4, tr1 - tr4
    if ido % 2 == 0:
        for k in range(l1):
            ti1, ti2 = cc[CC(0, 3, k)] + cc[CC(0, 1, k)], cc[CC(0, 3, k)] - cc[CC(0, 1, k)]
            tr2, tr1 = cc[CC(ido - 1, 0, k)] + cc[CC(ido - 1, 2, k)], cc[CC(ido - 1, 0, k)] - cc[CC(ido - 1, 2, k)]
            ch[CH(ido - 1, k, 0)] = tr2 + tr2
            ch[CH(ido - 1, k, 1)] = _SQRT2 * (tr1 - ti1)
            ch[CH(ido - 1, k, 2)] = ti2 + ti2
            ch[CH(ido - 1, k, 3)] = -_SQRT2 * (tr1 + ti1)
    for k in range(l1):
        for i in range(2, ido, 2):
            ic = ido - i
            tr2, tr1 = cc[CC(i - 1, 0, k)] + cc[CC(ic - 1, 3, k)], cc[CC(i - 1, 0, k)] - cc[CC(ic - 1, 3, k)]
            ti1, ti2 = cc[CC(i, 0, k)] + cc[CC(ic, 3, k)], cc[CC(i, 0, k)] - cc[CC(ic, 3, k)]
            tr4, ti3 = cc[CC(i, 2, k)] + cc[CC(ic, 1, k)], cc[CC(i, 2, k)] - cc[CC(ic, 1, k)]
            tr3, ti4 = cc[CC(i - 1, 2, k)] + cc[CC(ic - 1, 1, k)], cc[CC(i - 1, 2, k)] - cc[CC(ic - 1, 1, k)]
            ch[CH(i - 1, k, 0)], cr3 = tr2 + tr3, tr2 - tr3
            ch[CH(i, k, 0)], ci3 = ti2 + ti3, ti2 - ti3
            cr4, cr2 = tr1 + tr4, tr1 - tr4
            ci2, ci4 = ti1 + ti4, ti1 - ti4
            for j, (ci, cr) in enumerate(((ci2, cr2), (ci3, cr3), (ci4, cr4))):  # MULPM
                wr, wi = wa[i - 2 + j * (ido - 1)], wa[i - 1 + j * (ido - 1)]
                ch[CH(i, k, j + 1)] = wr * ci + wi * cr
                ch[CH(i - 1, k, j + 1)] = wr * cr - wi * ci


def _rfft(c: list, plan: dict, forward: bool) -> list:
    """rfftp::exec: the passes (forward: last factor first), then the scale."""
    n, fac, tws = len(c), plan["factors"], plan["rfft_tw"]
    p1, p2 = list(c), [None] * n
    if forward:
        l1 = n
        for k in reversed(range(len(fac))):
            ido = n // l1
            l1 //= fac[k]
            (_radf4 if fac[k] == 4 else _radf2)(ido, l1, p1, p2, tws[k])
            p1, p2 = p2, p1
    else:
        l1 = 1
        for k, ip in enumerate(fac):
            (_radb4 if ip == 4 else _radb2)(n // (ip * l1), l1, p1, p2, tws[k])
            p1, p2 = p2, p1
            l1 *= ip
    return [plan["fct"] * v for v in p1]  # copy_and_norm (fct != 1 for every n > 1)


def _dct2_line(c: list, plan: dict) -> list:
    """T_dcst23::exec, type 2 (cosine, ortho)."""
    n = len(c)
    ns2, tw = (n + 1) // 2, plan["dct_tw"]
    c = list(c)
    c[0] = c[0] * 2.0
    c[n - 1] = c[n - 1] * 2.0
    for k in range(1, n - 1, 2):  # MPINPLACE(c[k + 1], c[k])
        c[k], c[k + 1] = c[k + 1] + c[k], c[k + 1] - c[k]
    c = _rfft(c, plan, forward=False)
    for k in range(1, ns2):
        kc = n - k
        t1 = tw[k - 1] * c[kc] + tw[kc - 1] * c[k]
        t2 = tw[k - 1] * c[k] - tw[kc - 1] * c[kc]
        c[k], c[kc] = 0.5 * (t1 + t2), 0.5 * (t1 - t2)
    c[ns2] = c[ns2] * tw[ns2 - 1]
    c[0] = c[0] * (_SQRT2 * 0.5)
    return c


def _dct3_line(c: list, plan: dict) -> list:
    """T_dcst23::exec, type 3 (cosine, ortho): the inverse of type 2."""
    n = len(c)
    ns2, tw = (n + 1) // 2, plan["dct_tw"]
    c = list(c)
    c[0] = c[0] * _SQRT2
    for k in range(1, ns2):
        kc = n - k
        t1, t2 = c[k] + c[kc], c[k] - c[kc]
        c[k] = tw[k - 1] * t2 + tw[kc - 1] * t1
        c[kc] = tw[k - 1] * t1 - tw[kc - 1] * t2
    c[ns2] = c[ns2] * (2.0 * tw[ns2 - 1])
    c = _rfft(c, plan, forward=True)
    for k in range(1, n - 1, 2):  # MPINPLACE(c[k], c[k + 1])
        c[k], c[k + 1] = c[k] - c[k + 1], c[k] + c[k + 1]
    return c


def _separable(line, x: torch.Tensor) -> torch.Tensor:
    """scipy's two 1-D passes over (..., n, n) blocks: axis -2, then axis -1."""
    x = x.to(torch.float64)
    n = x.shape[-1]
    if x.shape[-2] != n:
        raise ValueError(f"blocks must be square, got {tuple(x.shape)}")
    plan = scipy_plan(n)
    x = torch.stack(line([x[..., k, :] for k in range(n)], plan), dim=-2)
    return torch.stack(line([x[..., k] for k in range(n)], plan), dim=-1)


def dct2_scipy_f64(x: torch.Tensor) -> torch.Tensor:
    """scipy.fftpack's orthonormal 2D DCT-II of (..., n, n) blocks, float64,
    before rounding: bit-equal to ``dct(dct(x, axis=-2), axis=-1)``."""
    return _separable(_dct2_line, x)


def idct2_scipy_f64(t: torch.Tensor) -> torch.Tensor:
    """scipy.fftpack's orthonormal 2D IDCT (a DCT-III) of (..., n, n) blocks,
    float64, before rounding."""
    return _separable(_dct3_line, t)


def dct2_scipy(x: torch.Tensor) -> torch.Tensor:
    """The compat engine's 2D DCT, rounded half to even to int64 (Encoder.py:779-784)."""
    return torch.round(dct2_scipy_f64(x)).to(torch.int64)


def idct2_scipy(t: torch.Tensor) -> torch.Tensor:
    """The compat engine's 2D IDCT, rounded half to even to int64 (Encoder.py:810-817)."""
    return torch.round(idct2_scipy_f64(t)).to(torch.int64)
