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
// What bounds it on this card: instructions, not device memory.  At 720p
// and sr = 8 each macroblock does 1089 candidates * 256 abs-diffs, 1.0 G
// abs-diffs per reference frame, against ~4.6 MB of device traffic (the
// current frame and four parity planes read once, ~0.4 MB of results).  A
// byte at a time (two byte loads from shared memory and one __sad per
// pixel) the load/store units, at half the INT32 lanes' issue rate, would
// set the time.  Packed, four candidates' sums over one word of four pixels
// take 9 instructions (two shared loads, three funnel shifts, four
// accumulating VABSDIFF4), and the VABSDIFF4 pipe sets the time (PERF.md
// section 6; the row sums are so_search::words4, shared with
// full_search.cu).
//
// Design: one CUDA block per macroblock; the current block and the four
// plane windows (uint8 is exact: every parity value is <= 255) staged in
// shared memory as 32-bit words, with 4-byte cp.async copies zero-filled
// outside the band (byte loads where the planes are not word-aligned or
// w % 4 != 0).  The window's first column is rounded down to a word.  A
// thread takes four candidates of one parity plane at one row offset and
// the four column offsets that share one staged word, 4a .. 4a + 3: per row
// of the block it reads the window's words a + m once, aligns them for the
// four candidates with three funnel shifts, and sums four abs-diffs per
// accumulating VABSDIFF4 (a partial word: __vabsdiffu4, then __dp4a with a
// byte selector, which masks a block's partial last word).  The current block's words are
// broadcast reads.  The left and right halves of each row and the top and
// bottom halves of the block give the four quad SADs of VBS (a byte
// selector splits a word that straddles the halves); the block SAD is their
// sum.  Sums are exact integers.  Each candidate forms its packed 64-bit
// keys (SAD << 32 | sec) and each thread keeps the minimum of each; the
// block's winners are five block-wide unsigned mins, so the winner cannot
// depend on thread order, nor on how candidates are split among threads
// and stages (sec is unique per candidate).  Validity is per key: the block
// and each quad check their own origin and size against the reference's
// strict bounds and the FME margin on the (2h-1, 2w-1) grid; a thread skips
// a group none of whose candidates is valid.  A key that never saw a valid
// candidate stays all-ones and reports mv = (0, 0, 0), sad = INT32_MAX,
// ok = 0.  Without VBS (the kernel's template argument) only the block key
// is kept.  The windows are summed in stages: a reference's four planes at
// a time or, where four windows do not fit a block (large blocks at wide
// ranges), one plane at a time, which fits wherever the four fit as bytes
// (the wrapper's budget).  With several stages the next stage's windows are
// copied while the current one is summed (two buffers, where they fit in
// shared memory).  The block size is a template argument where it is 16,
// the codec's default, so every row loop unrolls and each word's quad half
// is known; other block sizes run the same code with runtime bounds.
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
using so_search::kSmemLimit;
using so_search::Layout;
using so_search::row_range;
constexpr int kMaxThreads = 512;

// the reference's candidate bounds on the half-pel grid (H2, W2) for an
// n x n (sub)block at grid position (gx, gy), with the FME margin: 0 <= g,
// g < D - n, 0 <= g + 2n and g + 2n < D - n on each axis, which for n > 0
// is 0 <= g < D - 3n
__device__ __forceinline__ bool valid_fme(int gx, int gy, int n, int H2, int W2) {
    return gx >= 0 && gx < W2 - 3 * n && gy >= 0 && gy < H2 - 3 * n;
}

// VBS: the block key and the four quad keys; otherwise the block key alone.  BSC: the block size when it is
// known at compile time (16, the codec's default: every row loop unrolls and every word's half is fixed), else 0
template <bool VBS, int BSC>
__global__ void __launch_bounds__(kMaxThreads)
    full_search_fme_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ planes, int nref, int h,
                           int w, int sr, int bs_arg, int bandh, int band_row0, int g_row0, int H, int pps,
                           int nbuf, int32_t* __restrict__ mv_out, int32_t* __restrict__ sad_out,
                           uint8_t* __restrict__ ok_out,
                           int32_t* __restrict__ smv_out, int32_t* __restrict__ ssad_out,
                           uint8_t* __restrict__ sok_out) {
    extern __shared__ uint32_t smem[];
    __shared__ unsigned long long s_red[33];
    const int bs = BSC ? BSC : bs_arg;
    const Layout lay(sr, bs);
    const int gsr = 2 * sr;               // grid search range
    const int s = bs / 2;
    const int H2 = 2 * H - 1, W2 = 2 * w - 1;
    uint32_t* s_cur = smem;  // bs rows of G words, then nbuf buffers of a stage's pps plane windows
    const int bj = blockIdx.x, bi = blockIdx.y;
    const int bx = bj * bs, by = bi * bs;  // in cur
    const int gy0 = 2 * (g_row0 + by);     // the block's row on the frame's half-pel grid
    const int wy = band_row0 + by - sr;    // the band row of the windows' top row
    const int c0 = (bx - sr) & 3;          // the window's first column, rounded down to a word: sx
    const int sx = bx - sr - c0;
    const int tid = threadIdx.x;
    const bool aligned = ((uintptr_t)planes & 3) == 0 && (w & 3) == 0;

    const bool cur_aligned = ((uintptr_t)cur & 3) == 0 && (w & 3) == 0 && (bs & 3) == 0;
    for (int e = tid; e < lay.cur_words; e += blockDim.x) {
        const int i = e / lay.G;
        so_search::stage_word(s_cur + e, cur + (size_t)(by + i) * w, bx + 4 * (e - i * lay.G), bx + bs, true,
                              cur_aligned);
    }
    // stage t: planes t * pps .. t * pps + pps - 1 of the nref * 4 (of reference t * pps / 4), pps = 4 or 1
    const int buf_words = pps * lay.plane_words, nst = nref * 4 / pps;
    auto stage = [&](int t) {  // stage t's plane windows, zero outside the band, into buffer t % nbuf
        uint32_t* buf = smem + lay.cur_words + (t % nbuf) * buf_words;
        for (int e = tid; e < buf_words; e += blockDim.x) {
            const int row = e / lay.RW, k = e - row * lay.RW;
            const int p = row / lay.WH, y = wy + row - p * lay.WH;
            const bool row_ok = y >= 0 && y < bandh;
            const uint8_t* src = row_ok ? planes + (((size_t)t * pps + p) * bandh + y) * w : planes;
            so_search::stage_word(buf + e, src, sx + 4 * k, w, row_ok, aligned);
        }
        so_search::cp_async_commit();
    };
    stage(0);

    // a thread's item: plane p = (py, px), row offset oy, and the group a of column offsets 4a + k - c0, k < 4
    const int na0 = (c0 + gsr) / 4 + 1, na1 = (c0 + gsr - 1) / 4 + 1;  // groups of a row: 2sr + 1 - px offsets
    const int cnt[4] = {(gsr + 1) * na0, (gsr + 1) * na1, gsr * na0, gsr * na1};
    const int first[5] = {0, cnt[0], cnt[0] + cnt[1], cnt[0] + cnt[1] + cnt[2], cnt[0] + cnt[1] + cnt[2] + cnt[3]};
    unsigned long long best[5] = {kNone, kNone, kNone, kNone, kNone};  // full, quads in Z order
    for (int t = 0; t < nst; ++t) {
        if (nbuf == 2 && t + 1 < nst) {  // the next stage's copies fly while this one is summed
            stage(t + 1);
            so_search::cp_async_wait<1>();
        } else {
            so_search::cp_async_wait<0>();
        }
        __syncthreads();
        const int r = t * pps / 4, p0 = t * pps - 4 * r;  // the stage's reference and first plane
        const uint32_t* win = smem + lay.cur_words + (t % nbuf) * buf_words;  // planes p0 .. p0 + pps - 1
        for (int it = first[p0] + tid; it < first[p0 + pps]; it += blockDim.x) {
            int p = 0, rem = it;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                if (p == q && rem >= cnt[q]) {
                    rem -= cnt[q];
                    p = q + 1;
                }
            }
            const int py = p >> 1, px = p & 1;
            const int na = px ? na1 : na0;
            const int oy = rem / na, a = rem - oy * na;
            const int dy = 2 * (oy - sr) + py, gy = gy0 + dy;
            bool vf[4], vq[4][4];
            bool any = false;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int ox = 4 * a + k - c0;
                const bool col = ox >= 0 && ox < gsr + 1 - px;
                const int gx = 2 * bx + 2 * (ox - sr) + px;
                vf[k] = col && valid_fme(gx, gy, bs, H2, W2);
                any |= vf[k];
                if constexpr (VBS) {
#pragma unroll
                    for (int qi = 0; qi < 4; ++qi) {
                        vq[k][qi] = col && valid_fme(gx + 2 * (qi & 1) * s, gy + 2 * (qi >> 1) * s, s, H2, W2);
                        any |= vq[k][qi];
                    }
                }
            }
            if (!any) continue;
            // the four candidates' sums: quads in Z order under VBS, else the block in qs[0]
            unsigned qs[VBS ? 4 : 1][4] = {};
            const uint32_t* wb = win + (p - p0) * lay.plane_words + oy * lay.RW + a;
            if constexpr (VBS) {
#pragma unroll
                for (int i = 0; i < s; ++i) {
                    row_range(wb + i * lay.RW, s_cur + i * lay.G, 0, s, qs[0]);
                    row_range(wb + i * lay.RW, s_cur + i * lay.G, s, bs, qs[1]);
                }
#pragma unroll
                for (int i = s; i < bs; ++i) {
                    row_range(wb + i * lay.RW, s_cur + i * lay.G, 0, s, qs[2]);
                    row_range(wb + i * lay.RW, s_cur + i * lay.G, s, bs, qs[3]);
                }
            } else {
#pragma unroll
                for (int i = 0; i < bs; ++i) row_range(wb + i * lay.RW, s_cur + i * lay.G, 0, bs, qs[0]);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int dx = 2 * (4 * a + k - c0 - sr) + px;
                const unsigned long long sec = so_search::pack_sec(dx, dy, r, dx + gsr, dy + gsr);
                if constexpr (VBS) {
                    const unsigned q4[4] = {qs[0][k], qs[1][k], qs[2][k], qs[3][k]};
                    so_search::keep_vbs(best, q4, vf[k], vq[k], sec);
                } else if (vf[k]) {
                    const unsigned long long key = ((unsigned long long)qs[0][k] << 32) | sec;
                    best[0] = key < best[0] ? key : best[0];
                }
            }
        }
        if (t + nbuf < nst) __syncthreads();  // this buffer is restaged for stage t + nbuf
        if (nbuf == 1 && t + 1 < nst) stage(t + 1);
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

template <bool VBS, int BSC>
int launch(const void* cur, const void* planes, int nref, int h, int w, int sr, int bs, int bandh, int band_row0,
           int g_row0, int H, void* mv, void* sad, void* ok, void* smv, void* ssad, void* sok, void* stream) {
    // a stage: a reference's four plane windows where they fit a block, else one plane's (which fits wherever
    // the wrapper's budget does); two buffers where there is a next stage to copy and they fit, else one
    const Layout lay(sr, bs);
    const size_t cur_bytes = 4 * (size_t)lay.cur_words, plane_bytes = 4 * (size_t)lay.plane_words;
    const int pps = cur_bytes + 4 * plane_bytes <= kSmemLimit ? 4 : 1;
    const int nbuf = nref * 4 / pps > 1 && cur_bytes + 2 * pps * plane_bytes <= kSmemLimit ? 2 : 1;
    const size_t smem = cur_bytes + nbuf * pps * plane_bytes;
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(full_search_fme_kernel<VBS, BSC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // one thread per item where they fit: (4sr + 1) rows of groups, each at most NA groups
    const int items = (4 * sr + 1) * lay.NA;
    const int threads = items >= kMaxThreads ? kMaxThreads : (items + 31) / 32 * 32;
    dim3 grid(w / bs, h / bs);
    full_search_fme_kernel<VBS, BSC><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)planes, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, pps, nbuf,
        (int32_t*)mv, (int32_t*)sad, (uint8_t*)ok, (int32_t*)smv, (int32_t*)ssad, (uint8_t*)sok);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int so_full_search_fme_vbs(const void* cur, const void* planes, int nref, int h, int w, int sr, int bs,
                                      int bandh, int band_row0, int g_row0, int H, void* mv, void* sad, void* ok,
                                      void* smv, void* ssad, void* sok, void* stream) {
    return (bs == 16 ? launch<true, 16> : launch<true, 0>)(cur, planes, nref, h, w, sr, bs, bandh, band_row0, g_row0,
                                                           H, mv, sad, ok, smv, ssad, sok, stream);
}

extern "C" int so_full_search_fme(const void* cur, const void* planes, int nref, int h, int w, int sr, int bs,
                                  int bandh, int band_row0, int g_row0, int H, void* mv, void* sad, void* ok,
                                  void* stream) {
    return (bs == 16 ? launch<false, 16> : launch<false, 0>)(cur, planes, nref, h, w, sr, bs, bandh, band_row0,
                                                             g_row0, H, mv, sad, ok, nullptr, nullptr, nullptr,
                                                             stream);
}
