// Transform, RD split and quantization of one frame's residuals for Hopper
// (sm_90a): one launch a frame step (a mesh tile's rows, or the frame).
//
// Replaces: no TPU kernel.  The JAX package's rd.transform_and_select
// (streamoptima_tpu/core/rd.py:27-89: dct2_int, quantize, rle_length, the
// RD split, quantize at the block QPs) is fused by XLA into the engine's
// jitted frame step.  The port's plain version is core/rd.py
// transform_and_select, a few hundred eager ops a frame.
//
// The function, per block b (one CTA, a thread per coefficient):
//   T = dct2_int(res_full[b]); with VBS Tq = dct2_int of each quad.
//   qtc_full = rhe(T >> (qps[b] + band)); with VBS qtc_quads = rhe(Tq >>
//   (qp_minus_1(qps[b]) + band)), else zeros.
//   Without VBS: split = 0, lens = rle_length(qtc_full), mae = mae_full.
//   With VBS the RD decision runs at the nominal QP:
//     bits_bs  = base   + 8 * rle_length(rhe(T  >> (qp_nominal + band)))
//     bits_vbs = base_v + 8 * sum_q rle_length(rhe(Tq >> (qp_minus_1(qp_nominal) + band)))
//     rd_bs  = lam * bits_bs  + mae_full      (each op one float32 rounding)
//     rd_vbs = lam * bits_vbs + vbs_mae
//     split = !(rd_bs < rd_vbs) && eligible[b]
//     lens = split ? sum_q rle_length(qtc_quads[q]) : rle_length(qtc_full)
//     mae = eligible[b] ? vbs_mae : mae_full
//   with (base, base_v) = (8, 32) for intra frames and (16, 64) for inter
//   frames, mae_full = sad / n^2 and vbs_mae = (sum of sub_sad / s^2) / 4,
//   +inf where the ok flags say no candidate was valid.
//
// rle_length over the anti-diagonal scan (core/zigzag.py) is the count of
// nonzeros plus the count of runs (a trailing zero run counts 1, an all-zero
// block 1): scan position u adds (v_u != 0) + (u == 0 || (v_u == 0) !=
// (v_{u-1} == 0)).  Each thread adds its position's share to a shared
// counter.
//
// The RD cost.  Both packages compute lam * bits + mae as a float32 multiply
// and a float32 add, each rounded; nvcc contracts a * b + c into an FMA
// unless told not to, so the products and sums are __fmul_rn / __fadd_rn,
// and lam arrives as the float32 PyTorch rounds the Python scalar to.  The
// MAE divisions are __fdiv_rn, the correctly rounded quotient the CPU
// computes (exact here: n is a power of two).
//
// What bounds it on this card.  Bytes: at 720p with VBS the two int32
// residual planes in and the two int32 coefficient planes out, about 15 MB,
// 4.4 us at 3.35 TB/s.  The integer work is ~2 x 16 int64 multiply-adds per
// coefficient and pass for both transforms, well below the byte time.  A
// first, simple design: one CTA per block, the block, its quads, the DCT
// tables and every intermediate in shared memory, one barrier per
// transform pass and three more around the counts.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "transform_common.cuh"

namespace {

using so_transform::band;
using so_transform::dct2_px;
using so_transform::kMaxN;
using so_transform::qp_minus_1;
using so_transform::rhe_shr;

constexpr int kMaxT = kMaxN * kMaxN;  // threads of a CTA: one per coefficient

// scan position u's share of rle_length (see the header comment)
__device__ __forceinline__ int rle_share(const int32_t* q, const int32_t* scan, int u) {
    const bool z = q[scan[u]] == 0;
    const bool start = u == 0 || z != (q[scan[u - 1]] == 0);
    return (z ? 0 : 1) + (start ? 1 : 0);
}

__global__ void __launch_bounds__(kMaxT)
transform_select_kernel(const int32_t* __restrict__ res_full, const int32_t* __restrict__ res_quads,
                        const int32_t* __restrict__ sad_full, const int32_t* __restrict__ sad_quads,
                        const uint8_t* __restrict__ ok_full, const uint8_t* __restrict__ ok_quads,
                        const int32_t* __restrict__ qps, const uint8_t* __restrict__ eligible,
                        const int32_t* __restrict__ a_full, const int32_t* __restrict__ a_quad,
                        const int32_t* __restrict__ scan_full, const int32_t* __restrict__ scan_quad, int n,
                        int qp_nominal, float lam, int frame_type, uint8_t* __restrict__ split_out,
                        int32_t* __restrict__ qtc_full, int32_t* __restrict__ qtc_quads, int32_t* __restrict__ lens,
                        float* __restrict__ mae_out) {
    __shared__ int32_t s_a[kMaxT], s_aq[kMaxT / 4], s_scan[kMaxT], s_scanq[kMaxT / 4];
    __shared__ int32_t s_x[kMaxT], s_tmp[kMaxT], s_xq[kMaxT], s_tmpq[kMaxT];
    __shared__ int32_t s_qfin[kMaxT], s_qnom[kMaxT], s_qqfin[kMaxT], s_qqnom[kMaxT];
    __shared__ int s_len[4];  // full at the block QP, full nominal, quads nominal, quads at the block QP

    const int64_t b = blockIdx.x;
    const int t = threadIdx.x;
    const int nn = n * n;
    const int s = n >> 1, ss = s * s;
    const bool vbs = res_quads != nullptr;
    const int r = t / n, c = t % n;
    const int q = vbs ? t / ss : 0, u = vbs ? t % ss : 0;  // the thread's quad and its place in it
    const int rq = vbs ? u / s : 0, cq = vbs ? u % s : 0;

    s_a[t] = a_full[t];
    s_scan[t] = scan_full[t];
    s_x[t] = res_full[b * nn + t];
    if (vbs) {
        if (t < ss) {
            s_aq[t] = a_quad[t];
            s_scanq[t] = scan_quad[t];
        }
        s_xq[t] = res_quads[b * nn + t];
    }
    if (t < 4) s_len[t] = 0;
    __syncthreads();

    const int qp_b = qps[b];
    const int32_t tf = dct2_px(s_a, s_x, s_tmp, n, r, c);
    const int32_t qf = (int32_t)rhe_shr(tf, qp_b + band(r, c, n));
    s_qfin[t] = qf;
    qtc_full[b * nn + t] = qf;
    int32_t qq = 0;
    if (vbs) {
        s_qnom[t] = (int32_t)rhe_shr(tf, qp_nominal + band(r, c, n));
        const int32_t tq = dct2_px(s_aq, s_xq + q * ss, s_tmpq + q * ss, s, rq, cq);
        qq = (int32_t)rhe_shr(tq, qp_minus_1(qp_b) + band(rq, cq, s));
        s_qqfin[t] = qq;
        s_qqnom[t] = (int32_t)rhe_shr(tq, qp_minus_1(qp_nominal) + band(rq, cq, s));
    }
    qtc_quads[b * nn + t] = qq;
    __syncthreads();

    int share = rle_share(s_qfin, s_scan, t);
    if (share) atomicAdd(&s_len[0], share);
    if (vbs) {
        share = rle_share(s_qnom, s_scan, t);
        if (share) atomicAdd(&s_len[1], share);
        share = rle_share(s_qqnom + q * ss, s_scanq, u);
        if (share) atomicAdd(&s_len[2], share);
        share = rle_share(s_qqfin + q * ss, s_scanq, u);
        if (share) atomicAdd(&s_len[3], share);
    }
    __syncthreads();

    if (t == 0) {
        const float inf = CUDART_INF_F;
        const float mae_full = (ok_full && !ok_full[b]) ? inf : __fdiv_rn((float)sad_full[b], (float)nn);
        if (!vbs) {
            split_out[b] = 0;
            lens[b] = s_len[0];
            mae_out[b] = mae_full;
            return;
        }
        float mq[4];
        for (int k = 0; k < 4; ++k)
            mq[k] = (ok_quads && !ok_quads[b * 4 + k]) ? inf : __fdiv_rn((float)sad_quads[b * 4 + k], (float)ss);
        const float vbs_mae = __fdiv_rn(__fadd_rn(__fadd_rn(__fadd_rn(mq[0], mq[1]), mq[2]), mq[3]), 4.0f);
        const int base = frame_type == 0 ? 8 : 16, base_v = frame_type == 0 ? 32 : 64;
        const float rd_bs = __fadd_rn(__fmul_rn(lam, (float)(base + 8 * s_len[1])), mae_full);
        const float rd_vbs = __fadd_rn(__fmul_rn(lam, (float)(base_v + 8 * s_len[2])), vbs_mae);
        const bool elig = eligible[b] != 0;
        const bool split = !(rd_bs < rd_vbs) && elig;
        split_out[b] = split ? 1 : 0;
        lens[b] = split ? s_len[3] : s_len[0];
        mae_out[b] = elig ? vbs_mae : mae_full;
    }
}

}  // namespace

// res_full: (nb, n, n) int32; res_quads: (nb, 4, n/2, n/2) int32, or null
// without VBS, and then sad_quads, ok_quads, eligible, a_quad and scan_quad
// go unread; sad_full: (nb,) int32, sad_quads (nb, 4) int32; ok_full (nb,)
// and ok_quads (nb, 4) bytes 0 / 1, each may be null (every candidate
// valid); qps: (nb,) int32; eligible: (nb,) bytes; a_full / a_quad: the
// n x n and n/2 x n/2 fixed-point DCT tables (int32); scan_full /
// scan_quad: the diagonal scan's flat indices (int32).  Outputs: split (nb,)
// bytes, qtc_full (nb, n, n) and qtc_quads (nb, 4, n/2, n/2) int32, lens
// (nb,) int32, mae (nb,) float32.  Returns a CUDA error code
// (cudaErrorInvalidValue for n outside {4, 8, 16}).
extern "C" int so_transform_select(const void* res_full, const void* res_quads, const void* sad_full,
                                   const void* sad_quads, const void* ok_full, const void* ok_quads, const void* qps,
                                   const void* eligible, const void* a_full, const void* a_quad,
                                   const void* scan_full, const void* scan_quad, int nb, int n, int qp_nominal,
                                   float lam, int frame_type, void* split, void* qtc_full, void* qtc_quads,
                                   void* lens, void* mae, void* stream) {
    if (n != 4 && n != 8 && n != 16) return (int)cudaErrorInvalidValue;
    if (nb <= 0) return 0;
    transform_select_kernel<<<nb, n * n, 0, (cudaStream_t)stream>>>(
        (const int32_t*)res_full, (const int32_t*)res_quads, (const int32_t*)sad_full, (const int32_t*)sad_quads,
        (const uint8_t*)ok_full, (const uint8_t*)ok_quads, (const int32_t*)qps, (const uint8_t*)eligible,
        (const int32_t*)a_full, (const int32_t*)a_quad, (const int32_t*)scan_full, (const int32_t*)scan_quad, n,
        qp_nominal, lam, frame_type, (uint8_t*)split, (int32_t*)qtc_full, (int32_t*)qtc_quads, (int32_t*)lens,
        (float*)mae);
    return (int)cudaGetLastError();
}
