// Whole-pel full-search motion estimation for Hopper (sm_90a).
//
// Replaces: streamoptima_tpu/core/me_pallas.py, _plane_search as reached
// through full_search_pallas (whole-pel, want_pred=True, no VBS; the VBS
// mode is described below).  For every bs x bs macroblock it evaluates every
// (ref, dy, dx) candidate in [-sr, sr]^2, keeps the lexicographic minimum of
// (SAD, sec) with sec = ((l1 << 3 | ref) << 8 | dxi) << 8 | dyi, and writes
// the winner's pixels.  The TPU kernel's row-shifted plane copies, VMEM band
// model and bf16 0/1 aggregation matmuls were TPU layout devices and are not
// carried over: here the sums are exact integers.
//
// What bounds it on this card: the byte-difference instructions, not device
// memory.  At 720p and sr = 8 each macroblock does 289 candidates * 256
// abs-diffs, 266M a reference frame, against ~3.7 MB of device traffic.  A
// byte at a time (two shared loads, a subtraction, an abs and an add per
// pixel) the issue slots set the time at some 6x the one-operation bound.
// Packed, four candidates share each staged word of four window pixels: per
// word, two shared loads, three funnel shifts and four accumulating
// VABSDIFF4 (four byte differences summed into the candidate's SAD in one
// instruction).  Dropping a third of that loop's instructions (a __dp4a
// after each __vabsdiffu4) barely moved its time (PERF.md section 6): it waits
// on the VABSDIFF4 pipe.  What is left above the bound is mostly packing: a
// row's 2sr + 1 column offsets fill whole groups of four (20 slots for 17
// at sr = 8) and a macroblock's groups whole rounds of 32 lanes (96 for 85).
//
// Design: one warp per macroblock, up to kMaxWarps macroblocks (warps) a
// CTA.  Each warp stages its own block and window, so no block-wide barrier
// is needed anywhere: staging, sums and the winner's reduction synchronise
// within the warp, and one warp's copies overlap the other warps' sums on
// the SM.  (Splitting a macroblock's candidates over several warps, to put
// more warps on the SMs for a mesh tile's smaller grid, was slower: each
// warp then stages the whole window for a fraction of the sums.)  The block
// and each reference's (bs + 2sr)^2 window are staged as 32-bit words (4-byte
// cp.async, zero-filled outside the band; byte loads where the tensor or w
// is not word-aligned), the window's first column rounded down to a word
// (so_search::Layout).  A lane takes four candidates at one (ref, dy) whose
// column offsets share a staged word: per block row it reads the window's
// words once, aligns them with three funnel shifts and sums them
// (so_search::words4; byte selectors with __vabsdiffu4 + __dp4a mask a
// partial last word and split a word that straddles the quad halves).  A
// macroblock's groups, (2sr + 1) rows of at most NA, are spread over the
// warp's 32 lanes (85 groups at sr = 8, 297 at sr = 16: three and ten
// rounds), so no range leaves a second full pass for a few candidates.
// With several references the next one's window is copied while the
// current one is summed (two buffers where they fit).  Each lane keeps the
// minimum of each packed 64-bit key, and the warp's winners are warp-shuffle
// minima: sec is unique per candidate, so the winner cannot depend on how
// candidates are split among lanes, warps or references.  The block size is
// a template argument where it is 16, the codec's default, so every row loop
// unrolls; other block sizes run the same code with runtime bounds.  Where
// the block's words and one window do not fit a block's shared memory (VBS
// blocks near the wrapper's byte budget), the block's rows are read from
// device memory instead (the CUR_SMEM template argument); one window fits
// wherever the wrappers' budgets do.
//
// Invalid candidates never enter the min, so a block with none keeps the
// all-ones key and reports sad = INT32_MAX, ok = 0, mv = (0, 0, 0) and a
// zero pred (the caller substitutes 128, as the JAX engine does).  The
// winner's pixels are written as int16, eight a 16-byte store where the row
// allows, read from the staged window while the winning reference is still
// in shared memory and from device memory otherwise.
//
// VBS mode (the kernel's template argument, so neither mode's loop branches
// on it): full_search_pallas(vbs=True, want_pred=False), the 8x8 quad
// winners beside the block's, MVs only (the pixels come from the pred_fetch
// kernel).  The same window serves the quads: every quad candidate lies
// inside the block's window.  Each lane takes its four candidates' quad SADs
// from one pass over the rows (the block SAD is their sum) and keeps five
// packed minima, one per key, each with its own validity: a quad checks its
// own origin and size (bs / 2) against the strict bounds, so a quad may have
// a valid winner where its block has none.  The tie-break key is the block's
// displacement's for all five.  The five keys are reduced together by warp
// shuffles, with no block barrier.
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

#include "search_common.cuh"

namespace {

using so_search::kNone;
using so_search::kSmemLimit;
using so_search::Layout;
using so_search::row_range;
constexpr int kMaxWarps = 4;  // macroblocks per CTA, one warp each

// the reference's strict bounds for an n x n (sub)block at (px, py)
__device__ __forceinline__ bool valid_whole(int px, int py, int n, int h, int w) {
    return px >= 0 && px < w - n && py >= 0 && py < h - n;
}

// a row of the block read from device memory (where the block's words do not
// fit shared memory beside the window): word m is bytes [4m, 4m + 4) of the
// row's n bytes, zero past them
struct DeviceRow {
    const uint8_t* p;
    int n;
    __device__ __forceinline__ uint32_t operator[](int m) const {
        uint32_t v = 0u;
        for (int b = 0; b < 4; ++b) {
            if (4 * m + b < n) v |= (uint32_t)__ldg(p + 4 * m + b) << (8 * b);
        }
        return v;
    }
};

__device__ __forceinline__ unsigned long long warp_min_all(unsigned long long v) {
    return __shfl_sync(0xffffffffu, so_search::warp_min(v), 0);
}

// a macroblock's place: (bx, by) in cur, gy its frame row, wy the band row of its window's top row, sx the
// window's first column rounded down to a word by c0
struct Place {
    int bx, by, gy, wy, c0, sx;
    __device__ Place(int b, int nbc, int bs, int sr, int g_row0, int band_row0) {
        const int bi = b / nbc;
        bx = (b - bi * nbc) * bs;
        by = bi * bs;
        gy = g_row0 + by;
        wy = band_row0 + by - sr;
        c0 = (bx - sr) & 3;
        sx = bx - sr - c0;
    }
};

// a macroblock's search by one warp: stage the block (CUR_SMEM) and each reference's window into the warp's
// shared memory (s_cur: the block's words, then nbuf windows), and fold every candidate into best
template <bool VBS, int BSC, bool CUR_SMEM>
__device__ __forceinline__ void search(unsigned long long (&best)[VBS ? 5 : 1], const Place& pl, uint32_t* s_cur,
                                       const uint8_t* __restrict__ cur, const uint8_t* __restrict__ refs, int nref,
                                       int w, int sr, int bs, int bandh, int H, int nbuf) {
    const Layout lay(sr, bs);
    const int lane = threadIdx.x & 31;
    const int nd = 2 * sr + 1;
    const int na = (pl.c0 + 2 * sr) / 4 + 1;  // groups of a row: bytes 4a .. 4a + 3 hold offsets 4a + k - c0
    const int items = nd * na;
    uint32_t* s_win = s_cur + (CUR_SMEM ? lay.cur_words : 0);
    const bool aligned = ((uintptr_t)refs & 3) == 0 && (w & 3) == 0;
    if constexpr (CUR_SMEM) {
        const bool cur_aligned = ((uintptr_t)cur & 3) == 0 && (w & 3) == 0 && (bs & 3) == 0;
        for (int e = lane; e < lay.cur_words; e += 32) {
            const int i = e / lay.G;
            so_search::stage_word(s_cur + e, cur + (size_t)(pl.by + i) * w, pl.bx + 4 * (e - i * lay.G),
                                  pl.bx + bs, true, cur_aligned);
        }
    }
    auto cur_row = [&](int i) {  // word m of the block's row i: cur_row(i)[m]
        if constexpr (CUR_SMEM) {
            return (const uint32_t*)(s_cur + i * lay.G);
        } else {
            return DeviceRow{cur + (size_t)(pl.by + i) * w + pl.bx, bs};
        }
    };
    // a lane stages words e = lane, lane + 32, ... of a window: word k of row `row`, stepped without a division
    const int row0 = lane / lay.RW, k0 = lane - row0 * lay.RW, drow = 32 / lay.RW, dk = 32 - drow * lay.RW;
    auto stage = [&](int r) {  // reference r's window, zero outside the band, into buffer r % nbuf
        uint32_t* buf = s_win + (r % nbuf) * lay.plane_words;
        const uint8_t* ref = refs + (size_t)r * bandh * w;
        for (int e = lane, row = row0, k = k0; e < lay.plane_words; e += 32) {
            const int y = pl.wy + row;
            const bool row_ok = y >= 0 && y < bandh;
            so_search::stage_word(buf + e, row_ok ? ref + (size_t)y * w : ref, pl.sx + 4 * k, w, row_ok, aligned);
            row += drow;
            k += dk;
            if (k >= lay.RW) {
                k -= lay.RW;
                ++row;
            }
        }
        so_search::cp_async_commit();
    };
    stage(0);  // the block's copies ride in the same group

    const int s = bs / 2;
    for (int r = 0; r < nref; ++r) {
        if (nbuf == 2 && r + 1 < nref) {  // the next reference's copies fly while this one is summed
            stage(r + 1);
            so_search::cp_async_wait<1>();
        } else {
            so_search::cp_async_wait<0>();
        }
        __syncwarp();
        const uint32_t* win = s_win + (r % nbuf) * lay.plane_words;
        for (int it = lane; it < items; it += 32) {
            const int oy = it / na, a = it - oy * na;
            const int dy = oy - sr, py = pl.gy + dy;
            bool vf[4], vq[4][4];
            bool any = false;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int ox = 4 * a + k - pl.c0;
                const bool col = ox >= 0 && ox < nd;
                const int px = pl.bx + ox - sr;
                vf[k] = col && valid_whole(px, py, bs, H, w);
                any |= vf[k];
                if constexpr (VBS) {
#pragma unroll
                    for (int qi = 0; qi < 4; ++qi) {
                        vq[k][qi] = col && valid_whole(px + (qi & 1) * s, py + (qi >> 1) * s, s, H, w);
                        any |= vq[k][qi];
                    }
                }
            }
            if (!any) continue;
            // the four candidates' sums: quads in Z order under VBS, else the block in qs[0]
            unsigned qs[VBS ? 4 : 1][4] = {};
            const uint32_t* wb = win + oy * lay.RW + a;
            if constexpr (VBS) {
#pragma unroll
                for (int i = 0; i < s; ++i) {
                    row_range(wb + i * lay.RW, cur_row(i), 0, s, qs[0]);
                    row_range(wb + i * lay.RW, cur_row(i), s, bs, qs[1]);
                }
#pragma unroll
                for (int i = s; i < bs; ++i) {
                    row_range(wb + i * lay.RW, cur_row(i), 0, s, qs[2]);
                    row_range(wb + i * lay.RW, cur_row(i), s, bs, qs[3]);
                }
            } else {
#pragma unroll
                for (int i = 0; i < bs; ++i) row_range(wb + i * lay.RW, cur_row(i), 0, bs, qs[0]);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int ox = 4 * a + k - pl.c0;
                const unsigned long long sec = so_search::pack_sec(ox - sr, dy, r, ox, oy);
                if constexpr (VBS) {
                    const unsigned q4[4] = {qs[0][k], qs[1][k], qs[2][k], qs[3][k]};
                    so_search::keep_vbs(best, q4, vf[k], vq[k], sec);
                } else if (vf[k]) {
                    const unsigned long long key = ((unsigned long long)qs[0][k] << 32) | sec;
                    best[0] = key < best[0] ? key : best[0];
                }
            }
        }
        __syncwarp();  // every lane is done with this buffer before it is restaged
        if (nbuf == 1 && r + 1 < nref) stage(r + 1);
    }
}

// VBS: the block key and the four quad keys, MVs only; otherwise the block key alone and the winner's pixels
// (pred_out).  BSC: the block size when it is known at compile time (16), else 0.  CUR_SMEM: the block's words
// are staged in shared memory (else read from device memory).  nbuf: window buffers per warp (2: the next
// reference is copied while this one is summed); warp_words: a warp's shared memory (words).
template <bool VBS, int BSC, bool CUR_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps)
    full_search_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ refs, int nref, int h, int w,
                       int sr, int bs_arg, int bandh, int band_row0, int g_row0, int H, int nbuf, int warp_words,
                       int32_t* __restrict__ mv_out, int32_t* __restrict__ sad_out, uint8_t* __restrict__ ok_out,
                       int16_t* __restrict__ pred_out, int32_t* __restrict__ smv_out,
                       int32_t* __restrict__ ssad_out, uint8_t* __restrict__ sok_out) {
    extern __shared__ uint32_t smem[];
    const int bs = BSC ? BSC : bs_arg;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nbc = w / bs;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;  // the macroblock, in raster order
    if (b >= nbc * (h / bs)) return;  // a warp past the last macroblock: no barrier waits for it
    const Place pl(b, nbc, bs, sr, g_row0, band_row0);
    uint32_t* s_cur = smem + warp * warp_words;
    unsigned long long best[VBS ? 5 : 1];  // the block, then its quads in Z order
    for (auto& k : best) k = kNone;
    search<VBS, BSC, CUR_SMEM>(best, pl, s_cur, cur, refs, nref, w, sr, bs, bandh, H, nbuf);

    const unsigned long long v = warp_min_all(best[0]);
    if (lane == 0) so_search::store_winner(v, sr, mv_out + 3 * b, sad_out + b, ok_out + b);
    if constexpr (VBS) {
#pragma unroll
        for (int k = 1; k < 5; ++k) {
            const unsigned long long vk = so_search::warp_min(best[k]);
            const int q = 4 * b + k - 1;
            if (lane == 0) so_search::store_winner(vk, sr, smv_out + 3 * q, ssad_out + q, sok_out + q);
        }
    } else {
        // the winner's pixels: from this warp's staged window while the winning reference is still in shared
        // memory (the last one, or the last two with two buffers), else from device memory, where a valid
        // winner's window lies inside the frame and the band; no valid candidate: a zero pred (the caller
        // substitutes 128)
        const Layout lay(sr, bs);
        const bool ok = v != kNone;
        const unsigned sec = (unsigned)(v & 0xffffffffull);
        const int oy = ok ? (int)(sec & 0xff) : sr, ox = ok ? (int)((sec >> 8) & 0xff) : sr;
        const int wref = ok ? (int)((sec >> 16) & 0x7) : 0;
        const bool held = wref == nref - 1 || (nbuf == 2 && wref == nref - 2);
        const uint8_t* win =
            (const uint8_t*)(s_cur + (CUR_SMEM ? lay.cur_words : 0) + (wref % nbuf) * lay.plane_words);
        const uint8_t* src = held ? win + oy * 4 * lay.RW + pl.c0 + ox
                                  : refs + ((size_t)wref * bandh + pl.wy + oy) * w + pl.sx + pl.c0 + ox;
        const int stride = held ? 4 * lay.RW : w;
        int16_t* out = pred_out + (size_t)pl.by * w + pl.bx;
        if ((bs & 7) == 0 && (w & 7) == 0 && ((uintptr_t)pred_out & 15) == 0) {  // eight pixels a 16-byte store
            const int cpr = bs >> 3;
            for (int t = lane; t < bs * cpr; t += 32) {
                const int i = t / cpr, j = 8 * (t - i * cpr);
                const uint8_t* p = src + i * stride + j;
                uint32_t q[4] = {0u, 0u, 0u, 0u};
                if (ok) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) q[e] = (uint32_t)p[2 * e] | (uint32_t)p[2 * e + 1] << 16;
                }
                *reinterpret_cast<uint4*>(out + (size_t)i * w + j) = make_uint4(q[0], q[1], q[2], q[3]);
            }
        } else {
            for (int t = lane; t < bs * bs; t += 32) {
                const int i = t / bs, j = t - i * bs;
                out[(size_t)i * w + j] = ok ? (int16_t)src[i * stride + j] : (int16_t)0;
            }
        }
    }
}

template <bool VBS, int BSC, bool CUR_SMEM>
int launch_inst(int warps, size_t smem, const void* cur, const void* refs, int nref, int h, int w, int sr, int bs,
                int bandh, int band_row0, int g_row0, int H, int nbuf, int warp_words, void* mv, void* sad, void* ok,
                void* pred, void* smv, void* ssad, void* sok, void* stream) {
    auto kernel = full_search_kernel<VBS, BSC, CUR_SMEM>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int nb = (h / bs) * (w / bs);
    kernel<<<(nb + warps - 1) / warps, 32 * warps, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)refs, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, nbuf, warp_words,
        (int32_t*)mv, (int32_t*)sad, (uint8_t*)ok, (int16_t*)pred, (int32_t*)smv, (int32_t*)ssad, (uint8_t*)sok);
    return (int)cudaGetLastError();
}

// a warp's shared memory: the block's words where they fit beside one window (else the block is read from
// device memory; one window alone fits wherever the wrappers' budgets do), and two windows where there is a
// next reference to copy and they fit, else one
struct Plan {
    bool cur_smem;
    int nbuf;
    size_t per_warp;  // bytes; more than kSmemLimit: the shape does not fit
    Plan(int sr, int bs, int nref) {
        const Layout lay(sr, bs);
        const size_t win = 4 * (size_t)lay.plane_words, cur_b = 4 * (size_t)lay.cur_words;
        cur_smem = cur_b + win <= kSmemLimit;
        const size_t base = cur_smem ? cur_b : 0;
        nbuf = nref > 1 && base + 2 * win <= kSmemLimit ? 2 : 1;
        per_warp = base + nbuf * win;
    }
};

template <bool VBS>
int launch(const void* cur, const void* refs, int nref, int h, int w, int sr, int bs, int bandh, int band_row0,
           int g_row0, int H, void* mv, void* sad, void* ok, void* pred, void* smv, void* ssad, void* sok,
           void* stream) {
    const Plan pl(sr, bs, nref);
    if (pl.per_warp > kSmemLimit) return (int)cudaErrorInvalidValue;
    const int warps = (int)std::min<size_t>(kMaxWarps, kSmemLimit / pl.per_warp);  // as shared memory allows
    auto inst = bs == 16 && pl.cur_smem ? launch_inst<VBS, 16, true>
                : pl.cur_smem           ? launch_inst<VBS, 0, true>
                                        : launch_inst<VBS, 0, false>;
    return inst(warps, warps * pl.per_warp, cur, refs, nref, h, w, sr, bs, bandh, band_row0, g_row0, H, pl.nbuf,
                (int)(pl.per_warp / 4), mv, sad, ok, pred, smv, ssad, sok, stream);
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
