// Pieces shared by the hand-written search kernels:
// - full_search.cu (whole-pel) and full_search_fme.cu (half-pel): the packed
//   (SAD, sec) key, its warp- and block-wide minimum, the winners'
//   write-back, the staged window's Layout and the packed four-candidate
//   row sums (words4, row_range);
// - those two and rowscan_pass.cu: word staging (stage_word, cp_async4)
//   and packed byte SADs (sad4, byte_sel).
//
// A key is SAD << 32 | sec with sec = ((l1 << 3 | ref) << 8 | dxi) << 8 | dyi,
// so the lexicographic (SAD, sec) minimum of core/me.py is one unsigned min.
// A key that never saw a valid candidate stays all-ones (kNone).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace so_search {

constexpr unsigned long long kNone = ~0ull;

constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper (bytes)

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
    for (int off = 16; off > 0; off >>= 1) {
        unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
        v = o < v ? o : v;
    }
    return v;
}

// block-wide min of one key per thread (blockDim.x a multiple of 32); every
// thread gets the result; s_red holds 33 keys
__device__ __forceinline__ unsigned long long block_min(unsigned long long v, unsigned long long* s_red) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    v = warp_min(v);
    __syncthreads();  // s_red may still be read by a previous call
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = warp_min(lane < (int)(blockDim.x >> 5) ? s_red[lane] : kNone);
        if (lane == 0) s_red[32] = v;
    }
    __syncthreads();
    return s_red[32];
}

// the tie-break half of a key: displacement (dx, dy) = (dxi, dyi) - range
__device__ __forceinline__ unsigned long long pack_sec(int dx, int dy, int ref, int dxi, int dyi) {
    const unsigned l1 = (unsigned)(abs(dx) + abs(dy));
    return ((((l1 << 3) | (unsigned)ref) << 8 | (unsigned)dxi) << 8) | (unsigned)dyi;
}

// fold one candidate into the block key (best[0], when the block is valid
// there) and the quad keys (best[1..4], each where its quad is valid); the
// block SAD is the sum of the quads'
__device__ __forceinline__ void keep_vbs(unsigned long long best[5], const unsigned qs[4], bool vf, const bool vq[4],
                                         unsigned long long sec) {
    if (vf) {
        const unsigned long long key = ((unsigned long long)(qs[0] + qs[1] + qs[2] + qs[3]) << 32) | sec;
        best[0] = key < best[0] ? key : best[0];
    }
    for (int qi = 0; qi < 4; ++qi) {
        if (!vq[qi]) continue;
        const unsigned long long key = ((unsigned long long)qs[qi] << 32) | sec;
        best[qi + 1] = key < best[qi + 1] ? key : best[qi + 1];
    }
}

// a winner key -> mv (dx, dy, ref), sad and ok; no valid candidate gives
// mv (0, 0, 0), sad INT32_MAX and ok 0
__device__ __forceinline__ void store_winner(unsigned long long v, int range, int32_t* mv, int32_t* sad,
                                             uint8_t* ok) {
    const bool found = v != kNone;
    const unsigned sec = (unsigned)(v & 0xffffffffull);
    mv[0] = found ? (int)((sec >> 8) & 0xff) - range : 0;
    mv[1] = found ? (int)(sec & 0xff) - range : 0;
    mv[2] = found ? (int)((sec >> 16) & 0x7) : 0;
    *sad = found ? (int32_t)(v >> 32) : 0x7fffffff;
    *ok = found ? 1 : 0;
}

// ---- staging and packed byte sums

// one 4-byte asynchronous copy into shared memory, zero-filled where !ok
// (src is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src, bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// stage the word of bytes [xx, xx + 4) of one plane row (row: its first byte,
// or any valid address where !row_ok), zero outside [0, w) and where the
// row is outside the plane.  aligned: the row and xx are 4-byte aligned and
// w % 4 == 0, so a word lies wholly inside or outside the row and one
// asynchronous copy moves it; otherwise four byte loads, stored at once.
__device__ __forceinline__ void stage_word(uint32_t* dst, const uint8_t* row, long long xx, int w, bool row_ok,
                                           bool aligned) {
    if (aligned) {
        const bool ok = row_ok && xx >= 0 && xx < w;
        cp_async4(dst, ok ? row + xx : row, ok);
        return;
    }
    uint32_t v = 0u;
    for (int b = 0; b < 4; ++b) {
        const long long x = xx + b;
        if (row_ok && x >= 0 && x < w) v |= (uint32_t)row[x] << (8 * b);
    }
    *dst = v;
}

// dp4a selector: 1 in the bytes [p, q) of a word, 0 elsewhere
__device__ __forceinline__ uint32_t byte_sel(int p, int q) {
    uint32_t s = 0u;
    for (int b = p; b < q; ++b) s |= 1u << (8 * b);
    return s;
}

constexpr uint32_t kOnes = 0x01010101u;

// sum of |c - r| over the four bytes of c and r that sel selects
__device__ __forceinline__ unsigned sad4(uint32_t c, uint32_t r, uint32_t sel, unsigned acc) {
    return __dp4a(__vabsdiffu4(c, r), sel, acc);
}

// the same over all four bytes: one accumulating VABSDIFF4 (the byte differences are summed into acc in the
// instruction, so no __dp4a follows)
__device__ __forceinline__ unsigned sad4_all(uint32_t c, uint32_t r, unsigned acc) {
    unsigned d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(c), "r"(r), "r"(acc));
    return d;
}

// A macroblock's staged reference window (full_search.cu) or parity-plane
// window (full_search_fme.cu): WH = bs + 2sr rows of RW words, and the block
// itself as bs rows of G words.  The window's first column is rounded down
// to a word, by c0 <= 3 bytes, so a row's candidate column offsets
// 0 .. 2sr sit at bytes c0 .. c0 + 2sr.  A thread's group a < NA takes the
// four offsets at bytes 4a .. 4a + 3 and reads words [a, a + G] of a row, so
// NA = (2sr + 3) / 4 + 1 groups cover the worst c0 and RW = NA + G.
struct Layout {
    int G, WH, NA, RW, cur_words, plane_words;
    __host__ __device__ Layout(int sr, int bs)
        : G((bs + 3) / 4), WH(bs + 2 * sr), NA((2 * sr + 3) / 4 + 1), RW(NA + G), cur_words(bs * G),
          plane_words(WH * RW) {}
};

// acc[k] += the selected byte abs-diffs of the row's words [m0, m1) against
// candidate k, whose row starts k bytes into the staged row wr (whole words:
// sad4_all; a partial word: sad4 with its selector).  cr[m] is
// word m of the block's row: a pointer to its staged words, or any type
// whose operator[] returns them.
template <class CurRow>
__device__ __forceinline__ void words4(const uint32_t* wr, const CurRow& cr, int m0, int m1, uint32_t sel,
                                       unsigned (&acc)[4]) {
    if (m0 >= m1) return;
    uint32_t lo = wr[m0];
    for (int m = m0; m < m1; ++m) {
        const uint32_t hi = wr[m + 1], c = cr[m];
        const uint32_t r[4] = {lo, __funnelshift_r(lo, hi, 8), __funnelshift_r(lo, hi, 16),
                               __funnelshift_r(lo, hi, 24)};
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = sel == kOnes ? sad4_all(c, r[k], acc[k]) : sad4(c, r[k], sel, acc[k]);
        lo = hi;
    }
}

// the same over the row's bytes [lo, hi): whole words with no selector, a
// partial word at either end with one
template <class CurRow>
__device__ __forceinline__ void row_range(const uint32_t* wr, const CurRow& cr, int lo, int hi, unsigned (&acc)[4]) {
    if (lo & 3) {
        const int m = lo >> 2, e = min(hi, 4 * m + 4);
        words4(wr, cr, m, m + 1, byte_sel(lo - 4 * m, e - 4 * m), acc);
        lo = e;
    }
    if (lo < hi) {
        const int m0 = lo >> 2, m1 = hi >> 2;
        words4(wr, cr, m0, m1, kOnes, acc);
        if (hi & 3) words4(wr, cr, m1, m1 + 1, byte_sel(0, hi - 4 * m1), acc);
    }
}

}  // namespace so_search
