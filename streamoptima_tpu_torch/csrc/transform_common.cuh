// Pieces shared by the residual-coding kernels, transform_select.cu and
// residual_recon.cu: the fixed-point 2D DCT-II and its inverse of
// core/transform.py (dct2_int / idct2_int), the round-half-even shift of
// core/quant.py (rhe_shift_right) and the quantizer's band exponents.
//
// The transforms.  A = round(D * 2^17) is the orthonormal DCT matrix in
// fixed point (dct_matrix_fixed), handed to the kernels as an int32 n x n
// table.  The plain version keeps every partial sum inside int32 by
// splitting operands (mh / ml, th / tl) and rounds twice per pass only
// where the JAX package does:
//   forward: M1 = rhe(A X / 2^6), T = rhe(M1 A^T / 2^28);
//   inverse: M1 = rhe(A^T T / 2^11), out = rhe(M1 A / 2^23).
// The splits are identities of integer arithmetic: (Sh << 11) + Sl = M1 A^T
// exactly, and likewise for the inverse's first pass.  So with int64 sums
// (|A| < 2^17, every block product below 2^48) each pass is one dot product
// and one rounding here; tests/test_torch_transform_select.py holds this
// one-pass form to the plain version.
//
// Each function is called by n * n threads together (one output element
// each, (r, c) its row and column in the n x n block), all of which must
// reach it: it holds one __syncthreads() between its two passes.  ``tmp``
// is an n * n shared scratch the caller does not touch again until after
// its next barrier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace so_transform {

constexpr int kMaxN = 16;  // the transform kernels' largest block

// round-half-even(num / 2^k) for 0 <= k <= 62; k = 0 returns num.  The
// remainder num & (2^k - 1) is the non-negative one, as in quant.py.
__device__ __forceinline__ int64_t rhe_shr(int64_t num, int k) {
    if (k <= 0) return num;
    const int64_t q = num >> k;
    const int64_t r = num & ((int64_t(1) << k) - 1);
    const int64_t half = int64_t(1) << (k - 1);
    return q + ((r > half || (r == half && (q & 1))) ? 1 : 0);
}

// quant.py's band exponent of coefficient (r, c): 0 above the anti-diagonal,
// 1 on it, 2 below
__device__ __forceinline__ int band(int r, int c, int n) {
    const int d = r + c;
    return d < n - 1 ? 0 : (d == n - 1 ? 1 : 2);
}

// QP - 1 floored at 0 (quant.py qp_minus_1)
__device__ __forceinline__ int qp_minus_1(int qp) { return qp > 0 ? qp - 1 : qp; }

// element (r, c) of dct2_int(x); x and a are n x n in shared memory
__device__ __forceinline__ int32_t dct2_px(const int32_t* a, const int32_t* x, int32_t* tmp, int n, int r, int c) {
    int64_t acc = 0;
    for (int p = 0; p < n; ++p) acc += (int64_t)a[r * n + p] * x[p * n + c];
    tmp[r * n + c] = (int32_t)rhe_shr(acc, 6);
    __syncthreads();
    acc = 0;
    for (int p = 0; p < n; ++p) acc += (int64_t)tmp[r * n + p] * a[c * n + p];
    return (int32_t)rhe_shr(acc, 28);
}

// element (r, c) of idct2_int(t)
__device__ __forceinline__ int32_t idct2_px(const int32_t* a, const int32_t* t, int32_t* tmp, int n, int r, int c) {
    int64_t acc = 0;
    for (int p = 0; p < n; ++p) acc += (int64_t)a[p * n + r] * t[p * n + c];
    tmp[r * n + c] = (int32_t)rhe_shr(acc, 11);
    __syncthreads();
    acc = 0;
    for (int p = 0; p < n; ++p) acc += (int64_t)tmp[r * n + p] * a[p * n + c];
    return (int32_t)rhe_shr(acc, 23);
}

}  // namespace so_transform
