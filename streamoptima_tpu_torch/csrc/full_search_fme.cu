// Half-pel (FME) full-search motion estimation, with or without the VBS
// quads, for Hopper (sm_90a).
//
// Replaces: streamoptima_tpu/core/me_pallas.py, _plane_search as reached
// through full_search_pallas_fme (vbs=True or False, want_pred=False),
// together with the plane-winner merge _assemble.  For every macroblock it evaluates every
// (ref, dy, dx) candidate of the half-pel grid in [-2sr, 2sr]^2 and keeps,
// for the block and for each of its four quads, the lexicographic minimum
// of (SAD, sec) with sec = ((l1 << 3 | ref) << 8 | dxi) << 8 | dyi on the
// grid range 2sr (core/me.py argmin_displacement).  It returns MVs, SADs and
// validity only; the winners' pixels come from the pred_fetch kernel.
//
// The half-pel grid is never built.  Grid pixel (Y, X) is parity plane
// (Y & 1, X & 1) at (Y >> 1, X >> 1) (core/me.fme_parity_planes, computed
// once per reference per frame by the caller), and a candidate's stride-2
// window on the grid is a contiguous whole-pel window of one parity plane:
// plane (dy & 1, dx & 1) at offset (dy >> 1, dx >> 1) from the block.  So a
// block needs only the (bs + 2sr)^2 window around it of each of the four
// planes.  The TPU kernel's 8 row-shifted planes, VMEM bands, bf16 0/1 MXU
// sums and four separate plane launches merged afterwards were TPU devices
// and are not carried over: here all four planes sit in shared memory and
// one pass covers every candidate, so the tie-break across planes is the
// same single unsigned min as within one.
//
// What bounds it on this card: integer operations, not device memory.  At
// 720p and sr = 8 each macroblock does 1089 candidates * 256 abs-diffs out
// of shared memory, 1.0 G abs-diff-accumulates per reference frame, against
// ~4.6 MB of device traffic (the current frame and four parity planes read
// once, ~0.4 MB of results).
//
// Design: one CUDA block per macroblock; the current block and the four
// plane windows (uint8 is exact: every parity value is <= 255) staged in
// shared memory, the planes at a stride that puts the same column of two
// planes in different banks.  Threads stride over the candidates; each
// computes its four quad SADs from one pass over the pixels (the full-block
// SAD is their sum), forms five packed 64-bit keys (SAD << 32 | sec), and
// keeps the minimum of each.  Validity is per key: the block and each quad
// check their own origin and size against the reference's strict bounds and
// the FME margin on the (2h-1, 2w-1) grid.  Five block-wide unsigned mins
// give the winners; a key that never saw a valid candidate stays all-ones
// and reports mv = (0, 0, 0), sad = INT32_MAX, ok = 0.  Without VBS (the
// kernel's template argument, so neither mode's loop branches on it) only the
// block key is kept: candidates valid for the block alone, one SAD each.
// Making it fast (packed byte SADs, several candidates per thread sharing
// loads) is later work.
//
// Band inputs (_plane_search's read_row0, g_px0 and grid_dims, as in
// full_search.cu): the planes may be those of a band of bandh frame rows
// holding cur row 0 at band row band_row0; cur is frame rows [g_row0,
// g_row0 + h) of an H-row frame.  Windows are staged from band rows, zero
// outside the band, and the bounds use frame rows on the (2H-1, 2w-1) grid.
// The wrapper checks that the band holds the rows a valid candidate's
// half-pel interpolation reads (sr above, sr + 1 below).  The defaults are
// the whole-frame search.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search_common.cuh"

namespace {

using so_search::kNone;
constexpr int kThreads = 256;

// the reference's candidate bounds on the half-pel grid (H2, W2) for an
// n x n (sub)block at grid position (gx, gy), with the FME margin
__device__ __forceinline__ bool valid_fme(int gx, int gy, int n, int H2, int W2) {
    return gx >= 0 && gx < W2 - n && gy >= 0 && gy < H2 - n && gx + 2 * n >= 0 && gx + 2 * n < W2 - n &&
           gy + 2 * n >= 0 && gy + 2 * n < H2 - n;
}

// VBS: the block key and the four quad keys; otherwise the block key alone
template <bool VBS>
__global__ void full_search_fme_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ planes,
                                       int nref, int h, int w, int sr, int bs, int bandh, int band_row0,
                                       int g_row0, int H, int32_t* __restrict__ mv_out, int32_t* __restrict__ sad_out,
                                       uint8_t* __restrict__ ok_out, int32_t* __restrict__ smv_out,
                                       int32_t* __restrict__ ssad_out, uint8_t* __restrict__ sok_out) {
    extern __shared__ uint8_t smem[];
    __shared__ unsigned long long s_red[33];
    const int gsr = 2 * sr;               // grid search range
    const int nd = 2 * gsr + 1;           // grid displacements per axis
    const int ncand = nd * nd;
    const int ww = bs + 2 * sr;           // plane window side
    const int pstride = ww * ww + 4;      // one bank apart per plane
    const int s = bs / 2;
    const int H2 = 2 * H - 1, W2 = 2 * w - 1;
    uint8_t* s_cur = smem;                // bs * bs
    uint8_t* s_win = smem + bs * bs;      // 4 planes * pstride
    const int bj = blockIdx.x, bi = blockIdx.y;
    const int bx = bj * bs, by = bi * bs;  // in cur
    const int gy0 = 2 * (g_row0 + by);     // the block's row on the frame's half-pel grid
    const int wy = band_row0 + by - sr;    // the band row of the windows' top row
    const int tid = threadIdx.x;

    for (int t = tid; t < bs * bs; t += blockDim.x) {
        s_cur[t] = cur[(size_t)(by + t / bs) * w + bx + t % bs];
    }
    unsigned long long best[5] = {kNone, kNone, kNone, kNone, kNone};  // full, quads in Z order
    for (int r = 0; r < nref; ++r) {
        __syncthreads();  // the previous reference's windows are no longer read
        for (int t = tid; t < 4 * ww * ww; t += blockDim.x) {
            const int p = t / (ww * ww), q = t % (ww * ww);
            const int y = wy + q / ww, x = bx - sr + q % ww;
            s_win[p * pstride + q] = (y >= 0 && y < bandh && x >= 0 && x < w)
                                         ? planes[(((size_t)r * 4 + p) * bandh + y) * w + x] : 0;
        }
        __syncthreads();
        for (int c = tid; c < ncand; c += blockDim.x) {
            const int dyi = c / nd, dxi = c % nd;
            const int dx = dxi - gsr, dy = dyi - gsr;
            const int gx = 2 * bx + dx, gy = gy0 + dy;
            bool vq[4] = {false, false, false, false};
            bool any = false;
            if constexpr (VBS) {
                for (int qi = 0; qi < 4; ++qi) {
                    vq[qi] = valid_fme(gx + 2 * (qi & 1) * s, gy + 2 * (qi >> 1) * s, s, H2, W2);
                    any |= vq[qi];
                }
            }
            const bool vf = valid_fme(gx, gy, bs, H2, W2);
            if (!vf && !any) continue;
            // parity plane (dy & 1, dx & 1) at whole-pel offset (dy >> 1, dx >> 1)
            const uint8_t* wp = s_win + ((dy & 1) * 2 + (dx & 1)) * pstride + ((dy >> 1) + sr) * ww + (dx >> 1) + sr;
            const unsigned long long sec = so_search::pack_sec(dx, dy, r, dxi, dyi);
            if constexpr (!VBS) {
                unsigned a = 0u;
                for (int i = 0; i < bs; ++i) {
                    const uint8_t* cr = s_cur + i * bs;
                    const uint8_t* rr = wp + i * ww;
                    for (int j = 0; j < bs; ++j) a = __sad((unsigned)cr[j], (unsigned)rr[j], a);
                }
                const unsigned long long key = ((unsigned long long)a << 32) | sec;
                best[0] = key < best[0] ? key : best[0];
            } else {
                unsigned qs[4];
                so_search::quad_sads(s_cur, wp, ww, bs, qs);
                so_search::keep_vbs(best, qs, vf, vq, sec);
            }
        }
    }
    const int b = bi * gridDim.x + bj;
    for (int k = 0; k < (VBS ? 5 : 1); ++k) {
        const unsigned long long v = so_search::block_min(best[k], s_red);
        if (tid != 0) continue;
        if (k == 0) {
            so_search::store_winner(v, gsr, mv_out + 3 * b, sad_out + b, ok_out + b);
        } else {
            const int q = 4 * b + k - 1;
            so_search::store_winner(v, gsr, smv_out + 3 * q, ssad_out + q, sok_out + q);
        }
    }
}

template <bool VBS>
int launch(const void* cur, const void* planes, int nref, int h, int w, int sr, int bs, int bandh, int band_row0,
           int g_row0, int H, void* mv, void* sad, void* ok, void* smv, void* ssad, void* sok, void* stream) {
    const int ww = bs + 2 * sr;
    const size_t smem = (size_t)bs * bs + 4 * ((size_t)ww * ww + 4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(full_search_fme_kernel<VBS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(w / bs, h / bs);
    full_search_fme_kernel<VBS><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)planes, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, (int32_t*)mv,
        (int32_t*)sad,
        (uint8_t*)ok, (int32_t*)smv, (int32_t*)ssad, (uint8_t*)sok);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int so_full_search_fme_vbs(const void* cur, const void* planes, int nref, int h, int w, int sr, int bs,
                                      int bandh, int band_row0, int g_row0, int H, void* mv, void* sad, void* ok,
                                      void* smv, void* ssad, void* sok, void* stream) {
    return launch<true>(cur, planes, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, mv, sad, ok, smv, ssad, sok,
                        stream);
}

extern "C" int so_full_search_fme(const void* cur, const void* planes, int nref, int h, int w, int sr, int bs,
                                  int bandh, int band_row0, int g_row0, int H, void* mv, void* sad, void* ok,
                                  void* stream) {
    return launch<false>(cur, planes, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, mv, sad, ok, nullptr, nullptr,
                         nullptr, stream);
}
