// One sweep pass of the fast-ME MVP chain for Hopper (sm_90a).
//
// Replaces: streamoptima_tpu/core/me_pallas.py, rowscan_pass with its
// pass_prep (and the eval it runs, core/fastme.eval_chain_flat).  For every
// segment s (a block row) it walks the row's L block columns in order:
//   mv[s][j] = f_j(mv[s][j-1]),  mv[s][-1] = seeds[s],
// where f_j is the 3x3 fast-ME search of block (s, j) around that MVP
// (core/fastme.py of this package, pick9): the nine positions MVP +
// {-1, 0, 1}^2 of every reference, the first minimum SAD in (ref, dx, dy)
// scan order (dx outer, dy inner, strict improvement), a candidate valid
// when 0 <= p < D - n and 0 <= p + 2n < D - n on both axes of the grid
// (quirk K7), and with no valid candidate the MVP itself, reference index
// included (quirk K8).  Two modes: whole-pel (planes = the references, the
// grid is the frame) and FME (planes = the four half-pel parity planes of
// each reference, the grid is the (2h-1, 2w-1) upsample: grid pixel (Y, X)
// is plane (Y & 1, X & 1) at (Y >> 1, X >> 1), so a candidate's stride-2
// window is a contiguous window of one plane).
//
// A mesh tile passes its own rows as cur and the frame's full-height planes:
// g_row0 is the frame row of cur's row 0 and H the planes' (the frame's)
// height, the TPU kernel's tile ys and dims.  Segment s reads cur at local
// row s * n and the planes, its window and the K7 bound at frame row
// g_row0 + s * n.  g_row0 = 0 and H = h are the whole-frame call.
//
// Contract difference from the TPU kernel: it returns the MVs (S, L, 3)
// only.  The TPU kernel also returns the stack of wide windows it fetched,
// so that its confirm pass need not gather again; here the confirm pass
// reads its regions through the window_fetch kernel.  The TPU grid runs in
// sequence and carries the seeds across grid steps; CUDA blocks do not, so
// the sequential dimension is a loop inside the block.
//
// What bounds it on this card: neither bytes nor operations (a pass at 720p
// reads under 5 MB and does 8.3 M abs-diff-accumulates, microseconds of
// either), but the L dependent steps of each segment.  Only S blocks run
// (45 at 720p, 15 on a mesh tile), so nothing hides a step's latency: the
// pass costs L times one step: a step's loads must not wait on L2, and its
// sums, reduction and winner must take few instructions and barriers.  A
// step takes about 0.8 us at 720p (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// section 6, from chip_smoke.py).
//
// Design: one CUDA block of six warps per segment.
// - Prefetch.  Column j + A's MVP is column j - 1's plus at most A steps of
//   {-1, 0, 1}, so its region of each plane lies inside a fixed superset of
//   n + 2 + 2A rows and columns around the MVP known at step j (whole-pel;
//   on the half-pel grid the same after floor_half).  At step j one thread
//   has the tensor memory accelerator (TMA) copy column j + A's block and
//   all its planes' supersets as two boxes (one 3-D box spans the planes)
//   into a ring of A + 1 shared buffers; the hardware zero-fills what lies
//   outside the tensors, and the copies complete the buffer's mbarrier.
//   Step j waits only on column j's mbarrier, armed A steps earlier, so it
//   waits on shared memory, not on L2, and no thread spends instructions on
//   addresses.  A = 2, or 1 where three buffers do not fit.  Where the
//   tensors do not allow the TMA's boxes (16-byte aligned rows, boxes of at
//   most 256 per dim), every thread copies its share of the same words
//   (cp.async, or byte loads where cur or the planes are not word-aligned or
//   w % 4 != 0) and a block barrier publishes them.  Coordinates that
//   involve an MV are 64-bit (MVs are not bounded by the search range); a
//   box whose origin lies wholly outside a tensor moves to just outside it,
//   so 32-bit box coordinates copy the same zeros.
// - Packed sums.  Warps w and w + 3 take the three candidates of column
//   dxi = w % 3, on the block's words (row i, 4 columns) split between them.
//   For each candidate a lane reads the superset's two words that hold its
//   word, aligns them with one funnel shift, and sums four abs-diffs with
//   __vabsdiffu4 and __dp4a (a byte selector masks a block's partial last
//   word); one __reduce_add_sync per candidate gives the warp's part, which
//   lane 0 leaves in shared memory.  One block barrier per step.  The parts
//   alternate between two slots by step parity: a warp that is done with
//   step j's winner may write step j + 1's parts while another still reads
//   step j's, and it cannot reach step j + 2's writes before every warp has
//   passed step j + 1's barrier, so no write meets a read of the same slot.
// - The winner, in every warp alike.  Each lane takes the candidates
//   k = lane, lane + 32, ... of the scan index k = 9 * ref + 3 * dxi + dyi
//   in order and keeps the least SAD among those valid under K7 and, at
//   that SAD, the first k.  Two __reduce_min_sync then take the least SAD
//   and the least k that has it, which is the first strict minimum of the
//   scan order for any nref, so the winner cannot depend on thread order;
//   with no valid candidate the SAD stays all-ones (a valid SAD is at most
//   n^2 * 255) and the MVP carries on, reference included (K8).
// The TPU kernel's speculative lookahead (kl columns per scan step from one
// wide window) answered the same latency by doing more work per step; here
// the prefetch takes L2 off the chain and the step keeps its 9 * nref
// candidates.  The lane-interleaved int16 planes, aligned DMA origins,
// barrel shifts and one-hot selects were devices against the TPU's layout
// and have no counterpart.

#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled is looked up at run time: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "search_common.cuh"

namespace {

constexpr int kThreads = 192;  // six warps: two for each candidate column dxi

// floor(v / 2) for either sign (C++ division truncates)
__device__ __forceinline__ long long floor_half(long long v) { return (v - (v & 1)) / 2; }

// K7: 0 <= p < D - n and 0 <= p + 2n < D - n, which for n > 0 is 0 <= p < D - 3n
__device__ __forceinline__ bool k7_valid(long long p, long long D, int n) { return p >= 0 && p < D - 3 * n; }

// one buffer of a ring of A + 1 (A columns prefetched ahead): the current block (n rows of G words), then
// nplanes supersets of R = n + 2 + 2A rows of RW words.  A superset's first column is rounded down to 16 bytes
// (the TMA's box origin; to a word without it), so a candidate's row starts at most 2A + 2 + 15 bytes in and
// reads words up to G + (2A + 17) / 4: RW is one more, rounded up to 4 words (at n = 16 and A = 2, rows of
// 12 words put the eight rows a warp reads in distinct banks).
// The block and each buffer start on 128 bytes, as the tensor-memory copies below need.
struct Layout {
    int G, R, RW, cur_words, plane_words, buf_words;
    __host__ __device__ Layout(int n, int nplanes, int A)
        : G((n + 3) / 4), R(n + 2 + 2 * A), RW(4 * ((G + (2 * A + 17) / 4 + 4) / 4)),
          cur_words(32 * ((n * G + 31) / 32)), plane_words(R * RW),
          buf_words(32 * ((cur_words + nplanes * R * RW + 31) / 32)) {}
};

// ---- the tensor memory accelerator (TMA): one thread copies a column's block and all its plane supersets as
// two boxes, zero-filled outside the tensors by the hardware, and their arrival completes an mbarrier

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n .reg .pred p;\n WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra WAIT_%=;\n}\n" ::"r"(
            smem_addr(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
        "[%4];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x, int y, int z, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
        "%4}], [%5];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
        : "memory");
}

// a box origin for the TMA: a 32-bit coordinate.  An origin wholly past [0, D) moves to just past it (the
// box stays wholly outside and reads as zeros), so MVs beyond 32 bits copy exactly.
__device__ __forceinline__ int box_coord(long long v, int box, int D) {
    return v < -box ? -box : v > D ? D : (int)v;
}

// a thread's share of a copy of rows of cpr words by the block's kThreads threads: word lk of rows lr,
// lr + rpi, ... (rows are skipped where lr >= rpi, and a row of more words than threads is walked kThreads
// at a time)
struct Share {
    int lr, lk, rpi;
};

__device__ __forceinline__ Share share_of(int cpr, int tid) {
    if (cpr > kThreads) return {0, tid, 1};
    const int rpi = kThreads / cpr, lr = tid / cpr;
    return {lr < rpi ? lr : 1 << 30, tid - lr * cpr, rpi};
}

// the MVP a column's superset was cut around, and how far its first column was rounded down
struct Base {
    int gx, gy, al;
};

// this thread's part of staging column jj's block and, around MVP (gx, gy), its planes' supersets into buf,
// a word at a time (aligned: by cp.async; else by byte loads); the supersets' first column is rounded down to
// a word, and a row copies the G + 3 words a candidate can read.  Returns the base.
template <int A>
__device__ __forceinline__ Base stage_column(uint32_t* buf, const Layout& lay, int gx, int gy, const uint8_t* cur,
                                             const uint8_t* planes, int y, int yl, int jj, int n, int w, int H,
                                             int nplanes, bool fme, bool aligned, Share sc, Share sp) {
    const long long x0 = (long long)jj * n;
    for (int i = sc.lr; i < n; i += sc.rpi) {
        const uint8_t* row = cur + (size_t)(yl + i) * w;
        for (int k = sc.lk; k < lay.G; k += kThreads)
            so_search::stage_word(buf + i * lay.G + k, row, x0 + 4 * k, (int)(x0 + n), true, aligned);
    }
    const long long uy = y + (fme ? floor_half((long long)gy - 1 - A) : (long long)gy - 1 - A);
    const long long ux = x0 + (fme ? floor_half((long long)gx - 1 - A) : (long long)gx - 1 - A);
    const long long ox = ux - (ux & 3);
    uint32_t* sup = buf + lay.cur_words;
    for (int e = sp.lr; e < nplanes * lay.R; e += sp.rpi) {  // e: plane p's row rr
        const int p = e / lay.R, rr = e - p * lay.R;
        const long long yy = uy + rr;
        const bool row_ok = yy >= 0 && yy < H;
        const uint8_t* row = row_ok ? planes + ((size_t)p * H + (size_t)yy) * w : planes;
        for (int k = sp.lk; k < lay.G + 3; k += kThreads)
            so_search::stage_word(sup + e * lay.RW + k, row, ox + 4 * k, w, row_ok, aligned);
    }
    return {gx, gy, (int)(ux - ox)};
}

// the TMA's variant of stage_column, by one thread: the block (n x n) and the supersets (RW words x R rows x
// nplanes), a box each, both completing bar
template <int A>
__device__ __forceinline__ Base stage_column_tma(uint32_t* buf, const Layout& lay, int gx, int gy,
                                                 const CUtensorMap* map_cur, const CUtensorMap* map_planes, int y,
                                                 int yl, int jj, int n, int w, int H, int nplanes, bool fme,
                                                 uint64_t* bar) {
    const long long x0 = (long long)jj * n;
    const long long uy = y + (fme ? floor_half((long long)gy - 1 - A) : (long long)gy - 1 - A);
    const long long ux = x0 + (fme ? floor_half((long long)gx - 1 - A) : (long long)gx - 1 - A);
    const long long ox = ux - (ux & 15);
    mbar_expect(bar, (unsigned)(n * n + 4 * lay.RW * lay.R * nplanes));
    tma_load_2d(buf, map_cur, (int)x0, yl, bar);
    tma_load_3d(buf + lay.cur_words, map_planes, box_coord(ox, 4 * lay.RW, w), box_coord(uy, lay.R, H), 0, bar);
    return {gx, gy, (int)(ux - ox)};
}

// NC: the block size when it is known at compile time (16, the codec's default: the unit loops unroll and
// divide by constants), else 0.  A: the columns prefetched ahead (2; 1 where three buffers do not fit)
template <int NC, int A>
__global__ void __launch_bounds__(kThreads) rowscan_pass_kernel(const __grid_constant__ CUtensorMap map_cur,
                                                                const __grid_constant__ CUtensorMap map_planes,
                                                                int tma, const uint8_t* __restrict__ cur,
                                                                const uint8_t* __restrict__ planes,
                                                                const int32_t* __restrict__ seeds, int nref, int w,
                                                                int n_arg, int fme, int g_row0, int H,
                                                                int32_t* __restrict__ mvs) {
    extern __shared__ __align__(128) uint32_t smem[];  // the TMA's boxes land on 128 bytes
    constexpr int kBufs = A + 1;
    const int n = NC ? NC : n_arg;
    const int P = fme ? 4 : 1;  // planes per reference
    const int nplanes = nref * P;
    const Layout lay(n, nplanes, A);
    const int part_words = kThreads / 32 * 3 * nref;
    unsigned* part = smem + kBufs * lay.buf_words;  // [step parity][warp][ref][3]: each warp's sums
    uint64_t* bars = reinterpret_cast<uint64_t*>(part + 2 * part_words);  // one per buffer (TMA)
    const int s = blockIdx.x;
    const int L = w / n;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int yl = s * n;         // the segment's row in cur
    const int y = g_row0 + yl;    // and in the frame
    const int scale = fme ? 2 : 1;
    const long long DH = fme ? 2LL * H - 1 : H, DW = fme ? 2LL * w - 1 : w;
    // without the TMA: word copies where cur, the planes, w and n are word-aligned, else byte loads
    const bool aligned = (((uintptr_t)cur | (uintptr_t)planes) & 3) == 0 && (w & 3) == 0 && (n & 3) == 0;
    const Share sc = share_of(lay.G, tid), sp = share_of(lay.G + 3, tid);
    // the sums: warp w takes the three candidates of dxi = w % 3 on units (block words) w / 3 * 32 + lane,
    // stepping by the group's threads
    const int dxi = warp % 3;
    const int nunits = n * lay.G;
    constexpr int kGroupThreads = kThreads / 3;
    const uint32_t last_sel = so_search::byte_sel(0, n - 4 * (lay.G - 1));  // the bytes of a row's last word

    int gx = seeds[3 * s], gy = seeds[3 * s + 1], gr = seeds[3 * s + 2];
    if (tma) {
        if (tid == 0) {
            for (int b = 0; b < kBufs; ++b) mbar_init(bars + b);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
    }
    // column jj's staging around the current MVP into its buffer: by thread 0 through the TMA, or by every
    // thread's copies
    auto stage = [&](int jj) -> Base {
        uint32_t* buf = smem + (jj % kBufs) * lay.buf_words;
        if (!tma)
            return stage_column<A>(buf, lay, gx, gy, cur, planes, y, yl, jj, n, w, H, nplanes, fme, aligned, sc, sp);
        if (tid == 0)
            return stage_column_tma<A>(buf, lay, gx, gy, &map_cur, &map_planes, y, yl, jj, n, w, H, nplanes, fme,
                                       bars + jj % kBufs);
        const long long ux = (long long)jj * n + (fme ? floor_half((long long)gx - 1 - A) : (long long)gx - 1 - A);
        return {gx, gy, (int)(ux & 15)};
    };
    Base base[A] = {};  // base[t]: column j + t's (compile-time indices: registers)
#pragma unroll
    for (int t = 0; t < A; ++t) {  // columns 0 .. A - 1 around the seed
        if (t < L) base[t] = stage(t);
        so_search::cp_async_commit();
    }

    for (int j = 0; j < L; ++j) {
        const int jn = j + A;
        Base bn = {gx, gy, 0};
        if (jn < L) bn = stage(jn);
        if (tma) {
            mbar_wait(bars + j % kBufs, (unsigned)(j / kBufs) & 1u);  // column j's boxes have landed
        } else {
            so_search::cp_async_commit();
            so_search::cp_async_wait<A>();  // this thread's copies of column j have landed
            __syncthreads();                // and every thread's
        }

        // this warp's three candidates' windows in the buffer: word offset and byte shift in plane (0 .. P-1)
        // of ref 0.  The MVP moved at most A steps since the superset was cut, so 32-bit differences are exact.
        const uint32_t* buf = smem + (j % kBufs) * lay.buf_words;
        unsigned* pj = part + (j & 1) * part_words;  // this step's slot of the warps' sums
        const Base b = base[0];
#pragma unroll
        for (int t = 0; t + 1 < A; ++t) base[t] = base[t + 1];
        base[A - 1] = bn;
        const int tx = gx - b.gx + A + dxi, dgy = gy - b.gy + A;  // grid offsets from the cut's first column, row
        const int px0 = (b.gx - 1 - A) & 1, py0 = (b.gy - 1 - A) & 1;  // FME: the cut's parities
        int cbase[3], cshift[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const int ty = dgy + d;
            int q = 0, ry = ty, rx = tx;
            if (fme) {
                q = ((ty + py0) & 1) * 2 + ((tx + px0) & 1);
                ry = (ty + py0) >> 1;
                rx = (tx + px0) >> 1;
            }
            rx += b.al;
            cbase[d] = lay.cur_words + (q * lay.R + ry) * lay.RW + (rx >> 2);
            cshift[d] = 8 * (rx & 3);
        }
        for (int r = 0; r < nref; ++r) {
            const int rbase = r * P * lay.plane_words;
            unsigned acc[3] = {0u, 0u, 0u};
#pragma unroll
            for (int t = 0; t < (nunits + kGroupThreads - 1) / kGroupThreads; ++t) {
                const int u = warp / 3 * 32 + lane + kGroupThreads * t;
                if (u >= nunits) break;
                const int i = u / lay.G, m = u - i * lay.G;
                const uint32_t sel = m == lay.G - 1 ? last_sel : so_search::kOnes;
                const uint32_t cw = buf[i * lay.G + m];
                const int ub = rbase + i * lay.RW + m;
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    const uint32_t* p = buf + cbase[d] + ub;
                    acc[d] = so_search::sad4(cw, __funnelshift_r(p[0], p[1], cshift[d]), sel, acc[d]);
                }
            }
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                const unsigned sum = __reduce_add_sync(0xffffffffu, acc[d]);
                if (lane == 0) pj[(warp * nref + r) * 3 + d] = sum;
            }
        }
        __syncthreads();  // every warp's sums are in; column j's buffer is free for the next step's copies

        // the winner, in every warp alike: this lane's least valid SAD and its first scan index
        // k = 9 ref + 3 dxi + dyi, then the warp's least SAD and the least k that has it
        unsigned best = ~0u, best_k = ~0u;
        for (int k = lane; k < 9 * nref; k += 32) {
            const int r = k / 9, c = k - 9 * r, kx = c / 3, ky = c - 3 * kx;
            unsigned sad = 0u;
            for (int v = kx; v < kThreads / 32; v += 3) sad += pj[(v * nref + r) * 3 + ky];
            const bool ok = k7_valid((long long)scale * j * n + gx + kx - 1, DW, n) &&
                            k7_valid((long long)scale * y + gy + ky - 1, DH, n);
            if (ok && sad < best) {
                best = sad;
                best_k = (unsigned)k;
            }
        }
        const unsigned least = __reduce_min_sync(0xffffffffu, best);
        if (least != ~0u) {  // else K8: the MVP carries on unchanged
            const int k = (int)__reduce_min_sync(0xffffffffu, best == least ? best_k : ~0u), c = k % 9;
            gx = (int)((long long)gx + c / 3 - 1);
            gy = (int)((long long)gy + c % 3 - 1);
            gr = k / 9;
        }
        if (tid < 3) mvs[((size_t)s * L + j) * 3 + tid] = tid == 0 ? gx : tid == 1 ? gy : gr;
    }
    so_search::cp_async_wait<0>();
}

using so_search::kSmemLimit;

// the ring's bytes with A columns ahead, the warps' sums (two slots) and the buffers' mbarriers
int ring_bytes(int nref, int n, int fme, int A) {
    return ((A + 1) * Layout(n, nref * (fme ? 4 : 1), A).buf_words + 2 * kThreads / 32 * 3 * nref) *
               (int)sizeof(uint32_t) +
           (A + 1) * (int)sizeof(uint64_t);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a uint8 tensor map of `rank` dims (innermost first), zero-filled outside, or a nonzero error
int tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
    static EncodeTiled encode = [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult q;
        return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) == cudaSuccess &&
                       q == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(fn)
                   : nullptr;
    }();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint32_t ones[3] = {1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides, box,
                              ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NC, int A>
int launch(const void* cur, const void* planes, const void* seeds, int nref, int S, int w, int n, int fme,
           int g_row0, int H, void* mvs, int smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e =
            cudaFuncSetAttribute(rowscan_pass_kernel<NC, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    // the TMA where the tensors allow its boxes (16-byte aligned rows and origins, boxes of at most 256 per
    // dim); else every thread's copies
    const int nplanes = nref * (fme ? 4 : 1);
    const Layout lay(n, nplanes, A);
    const int tma = (((uintptr_t)cur | (uintptr_t)planes) & 15) == 0 && w % 16 == 0 && n % 16 == 0 && n <= 256 &&
                    4 * lay.RW <= 256 && lay.R <= 256 && nplanes <= 256;
    CUtensorMap map_cur{}, map_planes{};
    if (tma) {
        const cuuint64_t dc[2] = {(cuuint64_t)w, (cuuint64_t)(S * n)}, sc[1] = {(cuuint64_t)w};
        const cuuint32_t bc[2] = {(cuuint32_t)n, (cuuint32_t)n};
        const cuuint64_t dp[3] = {(cuuint64_t)w, (cuuint64_t)H, (cuuint64_t)nplanes};
        const cuuint64_t sp[2] = {(cuuint64_t)w, (cuuint64_t)H * w};
        const cuuint32_t bp[3] = {(cuuint32_t)(4 * lay.RW), (cuuint32_t)lay.R, (cuuint32_t)nplanes};
        int e = tensor_map(&map_cur, cur, 2, dc, sc, bc);
        if (e == 0) e = tensor_map(&map_planes, planes, 3, dp, sp, bp);
        if (e != 0) return e;
    }
    rowscan_pass_kernel<NC, A><<<S, kThreads, smem, stream>>>(map_cur, map_planes, tma, (const uint8_t*)cur,
                                                              (const uint8_t*)planes, (const int32_t*)seeds, nref, w,
                                                              n, fme, g_row0, H, (int32_t*)mvs);
    return (int)cudaGetLastError();
}

}  // namespace

// shared memory of one segment's block, in bytes: the ring of column buffers, two columns ahead where that
// fits, else one; 0 where neither fits a block
extern "C" int so_rowscan_pass_smem(int nref, int n, int fme) {
    // neither fits where the block or the planes' supersets alone exceed a block (and the sizes below stay in int)
    if (n > 512 || (long long)nref * (fme ? 4 : 1) * Layout(n, 1, 1).plane_words * 4 > kSmemLimit) return 0;
    const int two = ring_bytes(nref, n, fme, 2), one = ring_bytes(nref, n, fme, 1);
    return two <= kSmemLimit ? two : one <= kSmemLimit ? one : 0;
}

extern "C" int so_rowscan_pass(const void* cur, const void* planes, const void* seeds, int nref, int h, int w,
                               int n, int fme, int g_row0, int H, void* mvs, void* stream) {
    const int S = h / n;
    if (S == 0 || w / n == 0) return 0;
    const int smem = so_rowscan_pass_smem(nref, n, fme);  // the wrapper refuses what does not fit
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const bool two = smem == ring_bytes(nref, n, fme, 2);
    auto go = n == 16 ? (two ? launch<16, 2> : launch<16, 1>) : (two ? launch<0, 2> : launch<0, 1>);
    return go(cur, planes, seeds, nref, S, w, n, fme, g_row0, H, mvs, smem, (cudaStream_t)stream);
}
