// Whole-pel full-search motion estimation for Hopper (sm_90a).
//
// Replaces: streamoptima_tpu/core/me_pallas.py, _plane_search as reached
// through full_search_pallas (whole-pel, want_pred=True, no VBS; the VBS
// mode is described below).  For every
// 16x16 macroblock it evaluates every (ref, dy, dx) candidate in
// [-sr, sr]^2, keeps the lexicographic minimum of (SAD, sec) with
// sec = ((l1 << 3 | ref) << 8 | dxi) << 8 | dyi, and writes the winner's
// pixels.  The TPU kernel's row-shifted plane copies, VMEM band model and
// bf16 0/1 aggregation matmuls were TPU layout devices and are not carried
// over: here the sums are plain int32 (the worst SAD is 256 * 255 = 65280).
//
// What bounds it on this card: arithmetic and shared-memory reads, not
// device memory.  Each macroblock reads its (bs + 2sr)^2 reference window
// once (32x32 bytes at sr = 8) and then does ncand * bs^2 abs-diffs
// (289 * 256 = 74k at sr = 8) out of shared memory; at 720p that is 266M
// abs-diffs per reference frame against ~3.7 MB of device traffic.
//
// Design: one CUDA block per macroblock (3600 at 720p, ~27 per SM), the
// current block (int32) and the zero-filled reference window (bytes) staged
// in shared memory, one thread per candidate (threads stride over the grid
// when ncand exceeds the block), a packed 64-bit key (SAD << 32 | sec) so the
// lexicographic min is one unsigned min, and a warp-shuffle block reduction.
// Invalid candidates never enter the min, so a block with none keeps the
// all-ones key and reports sad = INT32_MAX, ok = 0, mv = (0, 0, 0) and a
// zero pred (the caller substitutes 128, as the JAX engine does).  Making it
// fast (several macroblocks per CTA, register-tiled SADs) is later work.
//
// VBS mode (the kernel's template argument, so neither mode's loop branches
// on it): full_search_pallas(vbs=True, want_pred=False), the 8x8 quad
// winners beside the block's, MVs only (the pixels come from the pred_fetch
// kernel).  The same window staging serves the quads: every quad candidate
// lies inside the block's (bs + 2sr)^2 window.  As in full_search_fme.cu,
// each thread takes its four quad SADs from one pass over the pixels (the
// block SAD is their sum) and keeps five packed minima, one per key, each
// with its own validity: a quad checks its own origin and size (bs / 2)
// against the strict bounds, so a quad may have a valid winner where its
// block has none.  The tie-break key is the block's displacement's for all
// five.  It does the non-VBS mode's bs^2 abs-diffs per candidate, over the
// candidates valid for the block or one of its quads, and is bound the same
// way: by operations.
//
// Band inputs (both modes; _plane_search's read_row0, g_px0 and grid_dims):
// for a mesh tile, cur is frame rows [g_row0, g_row0 + h) and refs a band of
// bandh rows holding cur row 0 at band row band_row0 (the tile and its
// search-range halos); H is the frame's height.  The window is staged from
// band rows, zero outside the band, and every bound is evaluated at frame
// rows, so a tile's winners are the whole frame's.  The wrapper checks that
// the band holds every row a valid candidate reads.  The defaults (bandh = H
// = h, band_row0 = g_row0 = 0) are the whole-frame search: plain arguments,
// one loop for both.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "search_common.cuh"

namespace {

using so_search::kNone;

// the reference's strict bounds for an n x n (sub)block at (px, py)
__device__ __forceinline__ bool valid_whole(int px, int py, int n, int h, int w) {
    return px >= 0 && px < w - n && py >= 0 && py < h - n;
}

// VBS: the block key and the four quad keys, MVs only; otherwise the block
// key alone and the winner's pixels (pred_out)
template <bool VBS>
__global__ void full_search_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ refs,
                                   int nref, int h, int w, int sr, int bs, int bandh, int band_row0,
                                   int g_row0, int H, int32_t* __restrict__ mv_out, int32_t* __restrict__ sad_out,
                                   uint8_t* __restrict__ ok_out, int16_t* __restrict__ pred_out,
                                   int32_t* __restrict__ smv_out, int32_t* __restrict__ ssad_out,
                                   uint8_t* __restrict__ sok_out) {
    // the current block: int32 for the non-VBS mode's plain abs-diffs, bytes for VBS's __sad
    using Cur = std::conditional_t<VBS, uint8_t, int32_t>;
    extern __shared__ int32_t smem[];
    __shared__ unsigned long long s_red[33];
    const int nd = 2 * sr + 1;
    const int ncand = nd * nd;
    const int ww = bs + 2 * sr;
    Cur* s_cur = reinterpret_cast<Cur*>(smem);                   // bs * bs
    uint8_t* s_win = reinterpret_cast<uint8_t*>(s_cur + bs * bs);  // ww * ww
    const int bj = blockIdx.x, bi = blockIdx.y;
    const int bx = bj * bs, by = bi * bs;  // in cur
    const int gy = g_row0 + by;            // the block's frame row
    const int wy = band_row0 + by - sr;    // the band row of the window's top row
    const int tid = threadIdx.x;

    for (int t = tid; t < bs * bs; t += blockDim.x) {
        s_cur[t] = cur[(size_t)(by + t / bs) * w + bx + t % bs];
    }
    unsigned long long best[VBS ? 5 : 1];  // the block, then its quads in Z order
    for (auto& k : best) k = kNone;
    for (int r = 0; r < nref; ++r) {
        const uint8_t* ref = refs + (size_t)r * bandh * w;
        __syncthreads();  // the previous reference's window is no longer read
        for (int t = tid; t < ww * ww; t += blockDim.x) {
            const int y = wy + t / ww, x = bx - sr + t % ww;
            s_win[t] = (y >= 0 && y < bandh && x >= 0 && x < w) ? ref[(size_t)y * w + x] : 0;
        }
        __syncthreads();
        for (int c = tid; c < ncand; c += blockDim.x) {
            const int dyi = c / nd, dxi = c % nd;
            const int dx = dxi - sr, dy = dyi - sr;
            const int px = bx + dx, py = gy + dy;
            const uint8_t* wp = s_win + dyi * ww + dxi;
            if constexpr (!VBS) {
                // the reference's strict bounds (x + dx == W - bs is invalid)
                if (!valid_whole(px, py, bs, H, w)) continue;
                int sad = 0;
                for (int i = 0; i < bs; ++i) {
                    const int32_t* cr = s_cur + i * bs;
                    const uint8_t* rr = wp + i * ww;
                    for (int j = 0; j < bs; ++j) sad += abs(cr[j] - (int)rr[j]);
                }
                const unsigned long long key =
                    ((unsigned long long)(unsigned)sad << 32) | so_search::pack_sec(dx, dy, r, dxi, dyi);
                best[0] = key < best[0] ? key : best[0];
            } else {
                const int s = bs / 2;
                bool vq[4];
                bool any = false;
                for (int qi = 0; qi < 4; ++qi) {
                    vq[qi] = valid_whole(px + (qi & 1) * s, py + (qi >> 1) * s, s, H, w);
                    any |= vq[qi];
                }
                const bool vf = valid_whole(px, py, bs, H, w);
                if (!vf && !any) continue;
                unsigned qs[4];
                so_search::quad_sads(s_cur, wp, ww, bs, qs);
                so_search::keep_vbs(best, qs, vf, vq, so_search::pack_sec(dx, dy, r, dxi, dyi));
            }
        }
    }
    const int b = bi * gridDim.x + bj;
    const unsigned long long v = so_search::block_min(best[0], s_red);
    if (tid == 0) so_search::store_winner(v, sr, mv_out + 3 * b, sad_out + b, ok_out + b);
    if constexpr (VBS) {
        for (int k = 1; k < 5; ++k) {
            const unsigned long long vk = so_search::block_min(best[k], s_red);
            const int q = 4 * b + k - 1;
            if (tid == 0) so_search::store_winner(vk, sr, smv_out + 3 * q, ssad_out + q, sok_out + q);
        }
    } else {
        // a valid winner's window lies inside the frame and the band, so read
        // it directly; no valid candidate: a zero pred (the caller
        // substitutes 128)
        const bool ok = v != kNone;
        const unsigned sec = (unsigned)(v & 0xffffffffull);
        const int wdy = ok ? (int)(sec & 0xff) - sr : 0;
        const int wdx = ok ? (int)((sec >> 8) & 0xff) - sr : 0;
        const int wref = ok ? (int)((sec >> 16) & 0x7) : 0;
        const uint8_t* ref = refs + (size_t)wref * bandh * w;
        for (int t = tid; t < bs * bs; t += blockDim.x) {
            const int i = t / bs, j = t % bs;
            pred_out[(size_t)(by + i) * w + bx + j] =
                ok ? (int16_t)ref[(size_t)(wy + sr + wdy + i) * w + bx + wdx + j] : (int16_t)0;
        }
    }
}

template <bool VBS>
int launch(const void* cur, const void* refs, int nref, int h, int w, int sr, int bs, int bandh, int band_row0,
           int g_row0, int H, void* mv, void* sad, void* ok, void* pred, void* smv, void* ssad, void* sok,
           void* stream) {
    const int nd = 2 * sr + 1;
    const int threads = std::min(((nd * nd + 31) / 32) * 32, 1024);  // threads stride over the rest
    const int ww = bs + 2 * sr;
    const size_t smem = (size_t)bs * bs * (VBS ? 1 : sizeof(int32_t)) + (size_t)ww * ww;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(full_search_kernel<VBS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(w / bs, h / bs);
    full_search_kernel<VBS><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)refs, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, (int32_t*)mv,
        (int32_t*)sad, (uint8_t*)ok, (int16_t*)pred, (int32_t*)smv, (int32_t*)ssad, (uint8_t*)sok);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int so_full_search(const void* cur, const void* refs, int nref, int h, int w, int sr, int bs, int bandh,
                              int band_row0, int g_row0, int H, void* mv, void* sad, void* ok, void* pred,
                              void* stream) {
    return launch<false>(cur, refs, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, mv, sad, ok, pred, nullptr,
                         nullptr, nullptr, stream);
}

extern "C" int so_full_search_vbs(const void* cur, const void* refs, int nref, int h, int w, int sr, int bs,
                                  int bandh, int band_row0, int g_row0, int H, void* mv, void* sad, void* ok,
                                  void* smv, void* ssad, void* sok, void* stream) {
    return launch<true>(cur, refs, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, mv, sad, ok, nullptr, smv,
                        ssad, sok, stream);
}
