// Dequantization and residual reconstruction of one frame for Hopper
// (sm_90a): one launch a frame (a mesh tile's rows, or the frame), in encode
// and in decode.
//
// Replaces: no TPU kernel.  The JAX engine's _dequant (rescale, then
// idct2_int; streamoptima_tpu/jax_engine.py:658-667) and _recon_inter (the
// prediction plus the residual, wrapped to uint8, the quads where split;
// :669-693) are fused by XLA into the jitted frame steps.  The port's plain
// version is TorchCodec's former _dequant / _recon_inter (core/kernels.py
// residual_recon_plain), about 70 to 150 eager ops a frame.
//
// The function, per block b (one CTA, a thread per coefficient):
//   rf = idct2_int(qtc_full[b] << (qps[b] + band)), and with the quads
//   rq = idct2_int(qtc_quads[b][q] << (qp_minus_1(qps[b]) + band)), the
//   coefficients widened to int32 before the shift (int16 in decode).
//   Intra frames (no prediction): rf and rq are written as int32, the
//   residuals the intra_recon kernel takes.
//   Inter frames: each pixel of the (h, w) uint8 frame is (pred + rf) mod
//   256, or where the block is split (pred_q + rq) mod 256, the predictions
//   read from the (h, w) int16 planes the search and fetch kernels return,
//   or 128 where the ok flags say the block (quad) had no valid candidate.
//   Only the variant the block uses is transformed.
//
// What bounds it on this card.  Bytes: at 720p with VBS in decode, two
// int16 coefficient planes and two int16 prediction planes in and the uint8
// frame out, about 8.3 MB, 2.5 us at 3.35 TB/s; the intra mode writes two
// int32 planes instead.  The integer work is two passes of n int64
// multiply-adds per coefficient.  A first, simple design: one CTA per block,
// the coefficients, the tables and the first pass in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "transform_common.cuh"

namespace {

using so_transform::band;
using so_transform::idct2_px;
using so_transform::kMaxN;
using so_transform::qp_minus_1;

constexpr int kMaxT = kMaxN * kMaxN;

// coefficient i of a plane of int16 (wide == 0) or int32 values
__device__ __forceinline__ int32_t coef(const void* p, int wide, int64_t i) {
    return wide ? ((const int32_t*)p)[i] : (int32_t)((const int16_t*)p)[i];
}

// v << k on int32 with the wrap of a 32-bit shift (quant.py rescale)
__device__ __forceinline__ int32_t shl32(int32_t v, int k) { return (int32_t)((uint32_t)v << (k & 31)); }

__global__ void __launch_bounds__(kMaxT)
residual_recon_kernel(const void* __restrict__ qf, const void* __restrict__ qq, int wide, const int32_t* __restrict__ qps,
                      const int32_t* __restrict__ a_full, const int32_t* __restrict__ a_quad, int n,
                      int32_t* __restrict__ rf_out, int32_t* __restrict__ rq_out, const int16_t* __restrict__ pred,
                      const int16_t* __restrict__ pred_q, const uint8_t* __restrict__ split,
                      const uint8_t* __restrict__ ok, const uint8_t* __restrict__ sub_ok, int nbc,
                      uint8_t* __restrict__ out) {
    __shared__ int32_t s_a[kMaxT], s_aq[kMaxT / 4];
    __shared__ int32_t s_t[kMaxT], s_tmp[kMaxT], s_tq[kMaxT], s_tmpq[kMaxT];

    const int64_t b = blockIdx.x;
    const int t = threadIdx.x;
    const int nn = n * n;
    const int s = n >> 1, ss = s * s;
    const bool vbs = qq != nullptr;
    const bool inter = out != nullptr;
    const int r = t / n, c = t % n;
    const int q = vbs ? t / ss : 0, u = vbs ? t % ss : 0;
    const int rq = vbs ? u / s : 0, cq = vbs ? u % s : 0;
    // the same for every thread of the CTA: which variants this block needs
    const bool sp = inter && vbs && split[b];
    const bool need_full = !sp;
    const bool need_quads = vbs && (!inter || sp);

    const int qp = qps[b];
    s_a[t] = a_full[t];
    if (need_full) s_t[t] = shl32(coef(qf, wide, b * nn + t), qp + band(r, c, n));
    if (need_quads) {
        if (t < ss) s_aq[t] = a_quad[t];
        s_tq[t] = shl32(coef(qq, wide, b * nn + t), qp_minus_1(qp) + band(rq, cq, s));
    }
    __syncthreads();

    const int64_t y0 = (b / nbc) * n, x0 = (b % nbc) * n;
    const int64_t w = (int64_t)nbc * n;
    if (need_full) {
        const int32_t v = idct2_px(s_a, s_t, s_tmp, n, r, c);
        if (!inter) {
            rf_out[b * nn + t] = v;
        } else {
            const int64_t o = (y0 + r) * w + x0 + c;
            const int p = (ok && !ok[b]) ? 128 : pred[o];
            out[o] = (uint8_t)(p + v);
        }
    }
    if (need_quads) {
        const int32_t v = idct2_px(s_aq, s_tq + q * ss, s_tmpq + q * ss, s, rq, cq);
        if (!inter) {
            rq_out[b * nn + t] = v;
        } else {  // the quad's pixel (rq, cq) lies at (rq, cq) + s * (q / 2, q % 2) of the block
            const int64_t o = (y0 + (q >> 1) * s + rq) * w + x0 + (q & 1) * s + cq;
            const int p = (sub_ok && !sub_ok[b * 4 + q]) ? 128 : pred_q[o];
            out[o] = (uint8_t)(p + v);
        }
    }
}

}  // namespace

// qf: (nb, n, n) and qq: (nb, 4, n/2, n/2) coefficients, int16 (wide == 0)
// or int32 (wide == 1); qq null without VBS; qps: (nb,) int32 block QPs;
// a_full / a_quad: the fixed-point DCT tables (int32).  The blocks lie in
// raster order, nbc to a row.  Intra (out null): writes rf_out (nb, n, n)
// and, with qq, rq_out (nb, 4, n/2, n/2), int32.  Inter: writes the
// (nb / nbc * n, nbc * n) uint8 frame ``out`` from the int16 planes pred
// (and pred_q with qq) of the same shape; split (nb,) bytes is read with qq;
// ok (nb,) and sub_ok (nb, 4) bytes may be null (every block valid).
// Returns a CUDA error code (cudaErrorInvalidValue for n outside
// {4, 8, 16}).
extern "C" int so_residual_recon(const void* qf, const void* qq, int wide, const void* qps, const void* a_full,
                                 const void* a_quad, int nb, int nbc, int n, void* rf_out, void* rq_out,
                                 const void* pred, const void* pred_q, const void* split, const void* ok,
                                 const void* sub_ok, void* out, void* stream) {
    if (n != 4 && n != 8 && n != 16) return (int)cudaErrorInvalidValue;
    if (nb <= 0) return 0;
    residual_recon_kernel<<<nb, n * n, 0, (cudaStream_t)stream>>>(
        qf, qq, wide, (const int32_t*)qps, (const int32_t*)a_full, (const int32_t*)a_quad, n, (int32_t*)rf_out,
        (int32_t*)rq_out, (const int16_t*)pred, (const int16_t*)pred_q, (const uint8_t*)split, (const uint8_t*)ok,
        (const uint8_t*)sub_ok, nbc, (uint8_t*)out);
    return (int)cudaGetLastError();
}
