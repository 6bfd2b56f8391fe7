// The fast-ME confirm for Hopper (sm_90a): every block's 3x3 search around its converged MVP and, under VBS,
// its four quads' searches around the same MVP, in one launch.
//
// Replaces no TPU kernel.  It does the work of the JAX engine's confirm (streamoptima_tpu/core/fastme.py:1063),
// which runs inside the jitted frame step, where XLA fuses it.  Its plain version, core/fastme.py confirm of
// this package (sad9, pick9 and cand_valid for the block and again for each quad), is some 380 eager device
// operations a call, and the host's time to enqueue them, not the card's, was the fast-ME encode's confirm.
//
// Contract: exactly core/fastme.py confirm's, bit for bit.  win: (nb, P, n + 2, n + 2) uint8, each block's
// regions as window_fetch reads them at core/fastme.region_base(g) (P = nref whole-pel; under FME 4 * nref
// parity planes, plane 4 ref + 2 * row parity + column parity); cur: (nb, n, n) int32; g: (nb, 3) int32 MVPs
// [gx, gy, gref]; X, Y: (nb,) int32 block origins on the grid (doubled under FME), whose extent is DH x DW.
// Candidate (ref, dxi, dyi) of an m-sized (sub)block at grid origin (Ox, Oy) lies at p = O + g + d - 1 on
// each axis (d = dxi or dyi) and is valid when 0 <= p < D - m and 0 <= p + 2m < D - m on both (quirk K7).  The
// winner is the first least SAD in scan order k = 9 ref + 3 dxi + dyi; with no valid candidate it is the MVP
// itself, reference included, with SAD INT32_MAX (quirk K8).  The quads (Z order, pixel origin (ox, oy) in
// {0, s}^2 inside the block, s = n / 2) search around the block's MVP in its regions, with their own origin
// and size in K7.  The arithmetic is the plain version's: int32 that wraps where torch's int32 wraps (an
// abs-diff of any int32 pixel, the sums, the origin plus the MVP, the winner's MV), int64 where it promotes.
//
// What bounds it on this card: bytes, and few of them.  At 720p under FME it reads 3600 blocks' 4.7 MB of
// regions and 3.7 MB of int32 pixels and does 14.7 M abs-diffs: about 2.6 us of memory and 0.9 us of INT32
// lanes.  It was written for one launch and few instructions, not for its roofline.
//
// Design: a CTA of 64 threads per block.
// - Stage: the block's P regions (word copies where they lie on words, else bytes) and its int32 pixels go to
//   shared memory.
// - Sums: a candidate's SAD is the sum of its quads' SADs at the same region offset.  That holds for each of
//   the P * no^2 windows a block has (no = 3 offsets a side whole-pel; under FME 2, 16 windows a reference,
//   from which the MVP's parity picks nine), so each window needs four quad sums, and for an odd n a fifth
//   over the last row and column, which the quads leave out.  A thread sums one (window, part) at a time,
//   alone: no atomics, no order.
// - Picks: thread 0 takes the block (the sum of a window's parts), threads 1-4 the quads.  Each walks its
//   9 * nref candidates in scan order and keeps the first strict minimum, so the winner cannot depend on
//   thread order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper (bytes)
constexpr int kInt32Max = 0x7fffffff;

// one block's shared memory, in 4-byte words: its int32 pixels, its P regions (bytes, rounded up to a word)
// and the (window, part) sums.  no: region offsets a side; nw: windows; np: parts a window
struct Layout {
    int no, nw, np, region, cur_words, win_words, sum_words;
    __host__ __device__ Layout(int P, int n, int fme)
        : no(fme ? 2 : 3), nw(P * no * no), np(n & 1 ? 5 : 4), region((n + 2) * (n + 2)), cur_words(n * n),
          win_words((P * region + 3) / 4), sum_words(nw * np) {}
    __host__ __device__ long long bytes() const { return 4LL * ((long long)cur_words + win_words + sum_words); }
};

// torch's int32 a + b (two's complement, wrapping)
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

// the SAD of cur's rows [r0, r1) x columns [c0, c1) against the region at offset (oy, ox), in wrapping int32
template <int NC>
__device__ __forceinline__ unsigned rect_sad(const uint8_t* reg, const int32_t* cur, int n_arg, int oy, int ox,
                                             int r0, int r1, int c0, int c1) {
    const int n = NC ? NC : n_arg;
    unsigned acc = 0u;
    for (int i = r0; i < r1; ++i) {
        const uint8_t* wr = reg + (i + oy) * (n + 2) + ox;
        const int32_t* cr = cur + i * n;
#pragma unroll 8
        for (int j = c0; j < c1; ++j) {
            const unsigned d = (unsigned)wr[j] - (unsigned)cr[j];
            acc += (int)d < 0 ? 0u - d : d;
        }
    }
    return acc;
}

// part q of a window's SAD: q < 4 quad q (row half q >> 1, column half q & 1, s x s); q = 4 (odd n) the
// last row and the last column, which the quads leave out
template <int NC>
__device__ __forceinline__ unsigned part_sad(const uint8_t* reg, const int32_t* cur, int n_arg, int oy, int ox,
                                             int q) {
    const int n = NC ? NC : n_arg, s = n >> 1;
    if (q < 4) {
        const int r0 = (q >> 1) * s, c0 = (q & 1) * s;
        return rect_sad<NC>(reg, cur, n, oy, ox, r0, r0 + s, c0, c0 + s);
    }
    return rect_sad<NC>(reg, cur, n, oy, ox, 2 * s, n, 0, n) + rect_sad<NC>(reg, cur, n, oy, ox, 0, 2 * s, 2 * s, n);
}

// K7 on one axis of extent D for an m-sized (sub)block at grid position p
__device__ __forceinline__ bool k7(long long p, long long D, long long m) {
    return p >= 0 && p < D - m && p + 2 * m >= 0 && p + 2 * m < D - m;
}

// NC: the block size when it is known at compile time (16, the codec's default), else 0
template <int NC>
__global__ void __launch_bounds__(kThreads) fast_confirm_kernel(
    const uint8_t* __restrict__ win, const int32_t* __restrict__ cur, const int32_t* __restrict__ g,
    const int32_t* __restrict__ X, const int32_t* __restrict__ Y, int P, int n_arg, int fme, int vbs, long long DH,
    long long DW, int32_t* __restrict__ mv, int32_t* __restrict__ sad, uint8_t* __restrict__ ok,
    int32_t* __restrict__ sub_mv, int32_t* __restrict__ sub_sad, uint8_t* __restrict__ sub_ok) {
    extern __shared__ uint32_t smem[];
    const int n = NC ? NC : n_arg;
    const Layout lay(P, n, fme);
    const int b = blockIdx.x, tid = threadIdx.x;
    int32_t* scur = reinterpret_cast<int32_t*>(smem);
    uint8_t* sreg = reinterpret_cast<uint8_t*>(smem + lay.cur_words);
    unsigned* sums = smem + lay.cur_words + lay.win_words;

    // stage the block's regions and pixels
    const int nbytes = P * lay.region;
    const uint8_t* src = win + (size_t)b * nbytes;
    if ((((uintptr_t)src) & 3) == 0 && (nbytes & 3) == 0) {
        const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
        for (int i = tid; i < nbytes / 4; i += kThreads) smem[lay.cur_words + i] = __ldg(s4 + i);
    } else {
        for (int i = tid; i < nbytes; i += kThreads) sreg[i] = __ldg(src + i);
    }
    const int32_t* cb = cur + (size_t)b * n * n;
    for (int i = tid; i < n * n; i += kThreads) scur[i] = __ldg(cb + i);
    __syncthreads();

    // every (window, part) sum; window w = (plane * no + oy) * no + ox
    const int per_plane = lay.no * lay.no;
    for (int t = tid; t < lay.sum_words; t += kThreads) {
        const int w = t / lay.np, q = t - w * lay.np;
        const int p = w / per_plane, o = w - p * per_plane, oy = o / lay.no, ox = o - oy * lay.no;
        sums[t] = part_sad<NC>(sreg + p * lay.region, scur, n, oy, ox, q);
    }
    __syncthreads();

    // the picks: thread 0 the block, threads 1-4 its quads
    if (tid >= (vbs ? 5 : 1)) return;
    const int q = tid - 1;  // -1: the block
    const int s = n >> 1, m = q < 0 ? n : s;
    const int scale = fme ? 2 : 1;
    const int qx = q < 0 ? 0 : (q & 1) * s, qy = q < 0 ? 0 : (q >> 1) * s;
    const int gx = g[3 * b], gy = g[3 * b + 1], gr = g[3 * b + 2];
    const long long px = wrap_add(wrap_add(X[b], scale * qx), gx), py = wrap_add(wrap_add(Y[b], scale * qy), gy);
    unsigned vx = 0u, vy = 0u;  // bit d: the step d - 1 is valid on that axis
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        vx |= (unsigned)k7(px + d - 1, DW, m) << d;
        vy |= (unsigned)k7(py + d - 1, DH, m) << d;
    }
    const int nref = fme ? P / 4 : P;
    int best = kInt32Max, bk = 0;
    for (int k = 0; k < 9 * nref; ++k) {
        const int r = k / 9, c = k - 9 * r, dxi = c / 3, dyi = c - 3 * dxi;
        if (!((vx >> dxi) & (vy >> dyi) & 1u)) continue;  // invalid: INT32_MAX, which a strict minimum never takes
        int w;
        if (fme) {  // grid offset g + d - 1 from the block: plane parity t & 1 at region offset t >> 1
            const int ty = dyi + 1 - (gy & 1), tx = dxi + 1 - (gx & 1);
            w = ((4 * r + 2 * (ty & 1) + (tx & 1)) * 2 + (ty >> 1)) * 2 + (tx >> 1);
        } else {
            w = (r * 3 + dyi) * 3 + dxi;
        }
        unsigned v = 0u;
        if (q < 0) {
            for (int p = 0; p < lay.np; ++p) v += sums[w * lay.np + p];
        } else {
            v = sums[w * lay.np + q];
        }
        if ((int)v < best) {
            best = (int)v;
            bk = k;
        }
    }
    const bool found = best != kInt32Max;
    const int c = bk % 9;
    int32_t* mv_out = q < 0 ? mv + 3 * (size_t)b : sub_mv + 3 * (4 * (size_t)b + q);
    mv_out[0] = found ? wrap_add(gx, c / 3 - 1) : gx;
    mv_out[1] = found ? wrap_add(gy, c % 3 - 1) : gy;
    mv_out[2] = found ? bk / 9 : gr;
    if (q < 0) {
        sad[b] = best;
        ok[b] = found ? 1 : 0;
    } else {
        sub_sad[4 * (size_t)b + q] = best;
        sub_ok[4 * (size_t)b + q] = found ? 1 : 0;
    }
}

template <int NC>
int launch(const void* win, const void* cur, const void* g, const void* X, const void* Y, int nb, int P, int n,
           int fme, int vbs, long long DH, long long DW, void* mv, void* sad, void* ok, void* sub_mv, void* sub_sad,
           void* sub_ok, int smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(fast_confirm_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    fast_confirm_kernel<NC><<<nb, kThreads, smem, stream>>>(
        (const uint8_t*)win, (const int32_t*)cur, (const int32_t*)g, (const int32_t*)X, (const int32_t*)Y, P, n, fme,
        vbs, DH, DW, (int32_t*)mv, (int32_t*)sad, (uint8_t*)ok, (int32_t*)sub_mv, (int32_t*)sub_sad,
        (uint8_t*)sub_ok);
    return (int)cudaGetLastError();
}

}  // namespace

// shared memory of one block's CTA, in bytes; 0 where it does not fit a block
extern "C" int so_fast_confirm_smem(int P, int n, int fme) {
    if (P < 1 || n < 1 || P > 4096 || n > 512) return 0;  // keeps the layout's int sizes exact
    const long long bytes = Layout(P, n, fme).bytes();
    return bytes <= kSmemLimit ? (int)bytes : 0;
}

extern "C" int so_fast_confirm(const void* win, const void* cur, const void* g, const void* X, const void* Y, int nb,
                               int P, int n, int fme, int vbs, long long DH, long long DW, void* mv, void* sad,
                               void* ok, void* sub_mv, void* sub_sad, void* sub_ok, void* stream) {
    if (nb == 0) return 0;
    const int smem = so_fast_confirm_smem(P, n, fme);  // the wrapper refuses what does not fit
    if (smem == 0 || (fme && P % 4) || (vbs && (sub_mv == nullptr || sub_sad == nullptr || sub_ok == nullptr)))
        return (int)cudaErrorInvalidValue;
    auto go = n == 16 ? launch<16> : launch<0>;
    return go(win, cur, g, X, Y, nb, P, n, fme, vbs, DH, DW, mv, sad, ok, sub_mv, sub_sad, sub_ok, smem,
              (cudaStream_t)stream);
}
