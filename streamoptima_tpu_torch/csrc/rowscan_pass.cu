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
// reads its regions through the window_fetch kernel.  The speculative
// lookahead (kl columns per scan step from one wide window, column masks
// for the padded tail, one-hot candidate selects), the lane-interleaved
// int16 planes, the aligned DMA origins and the barrel shifts were devices
// against the TPU's per-step cost and layout and have no counterpart: any
// lookahead gives the same MVs, and a thread addresses any byte.  The TPU
// grid runs in sequence and carries the seeds across grid steps; CUDA blocks
// do not, so the sequential dimension is a loop inside the block.
//
// What bounds it on this card: neither bytes nor operations (a pass at 720p
// reads under 5 MB and does 8.3 M abs-diff-accumulates, microseconds of
// either), but the L dependent steps of each segment: every step waits for
// its region's loads from L2, the warp sums and two block barriers before
// the next MVP is known.  Only S blocks run, so most SMs idle.
//
// Design: one CUDA block per segment, nine warps.  Per column the block
// stages the current block and the (n+2)^2 region of each plane around the
// running MVP in shared memory (zero outside the plane), warp c sums the
// candidate of scan index c = 3 * dxi + dyi for each reference, and thread 0
// scans the 9 * nref sums in order, so the winner does not depend on thread
// order; it advances the MVP in shared memory.  Coordinates that involve an
// MV are 64-bit: MVs are not bounded by the search range.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 9;
constexpr int kThreads = kWarps * 32;

// floor(v / 2) for either sign (C++ division truncates)
__device__ __forceinline__ long long floor_half(long long v) { return (v - (v & 1)) / 2; }

__device__ __forceinline__ bool k7_valid(long long p, long long D, int n) {
    return p >= 0 && p < D - n && p + 2 * n >= 0 && p + 2 * n < D - n;
}

__global__ void rowscan_pass_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ planes,
                                    const int32_t* __restrict__ seeds, int nref, int w, int n, int fme,
                                    int g_row0, int H, int32_t* __restrict__ mvs) {
    extern __shared__ unsigned char smem[];
    const int R = n + 2;               // region extent
    const int P = fme ? 4 : 1;         // planes per reference
    const int nplanes = nref * P;
    int* sads = reinterpret_cast<int*>(smem);  // 9 * nref sums
    int* g_s = sads + 9 * nref;                // the running MVP
    uint8_t* cur_s = reinterpret_cast<uint8_t*>(g_s + 4);
    uint8_t* reg_s = cur_s + n * n;            // nplanes regions of R * R

    const int s = blockIdx.x;
    const int L = w / n;
    const int yl = s * n;         // the segment's row in cur
    const int y = g_row0 + yl;    // and in the frame
    const int scale = fme ? 2 : 1;
    const long long DH = fme ? 2LL * H - 1 : H, DW = fme ? 2LL * w - 1 : w;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int dxi = warp / 3, dyi = warp - 3 * dxi;

    if (tid < 3) g_s[tid] = seeds[3 * s + tid];
    __syncthreads();

    for (int j = 0; j < L; ++j) {
        const int x = j * n;
        const long long gx = g_s[0], gy = g_s[1];
        const long long by0 = fme ? y + floor_half(gy - 1) : y + gy - 1;
        const long long bx0 = fme ? x + floor_half(gx - 1) : x + gx - 1;
        for (int e = tid; e < n * n; e += kThreads) {
            const int i = e / n;
            cur_s[e] = cur[(size_t)(yl + i) * w + (size_t)(x + e - i * n)];
        }
        for (int e = tid; e < nplanes * R * R; e += kThreads) {
            const int p = e / (R * R);
            const int rem = e - p * R * R;
            const int i = rem / R;
            const long long yy = by0 + i, xx = bx0 + (rem - i * R);
            uint8_t v = 0;
            if (yy >= 0 && yy < H && xx >= 0 && xx < w) v = planes[((size_t)p * H + (size_t)yy) * w + (size_t)xx];
            reg_s[e] = v;
        }
        __syncthreads();

        // this warp's candidate: which plane of a reference, and where in its region
        int q = 0, oy = dyi, ox = dxi;
        if (fme) {
            const long long ty = gy + dyi - 1, tx = gx + dxi - 1;  // grid offset from the block
            q = (int)(ty & 1) * 2 + (int)(tx & 1);
            oy = (int)(floor_half(ty) - floor_half(gy - 1));
            ox = (int)(floor_half(tx) - floor_half(gx - 1));
        }
        for (int r = 0; r < nref; ++r) {
            const uint8_t* reg = reg_s + (r * P + q) * R * R + oy * R + ox;
            int acc = 0;
            for (int e = lane; e < n * n; e += 32) {
                const int i = e / n;
                acc += abs((int)reg[i * R + (e - i * n)] - (int)cur_s[e]);
            }
            for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
            if (lane == 0) sads[r * 9 + warp] = acc;
        }
        __syncthreads();

        if (tid == 0) {
            int best = INT_MAX, best_k = -1;
            for (int k = 0; k < 9 * nref; ++k) {
                const int c = k % 9, cdx = c / 3, cdy = c - 3 * cdx;
                const bool ok = k7_valid((long long)scale * x + gx + cdx - 1, DW, n) &&
                                k7_valid((long long)scale * y + gy + cdy - 1, DH, n);
                if (ok && sads[k] < best) {
                    best = sads[k];
                    best_k = k;
                }
            }
            if (best_k >= 0) {
                const int c = best_k % 9, cdx = c / 3, cdy = c - 3 * cdx;
                g_s[0] = (int)(gx + cdx - 1);
                g_s[1] = (int)(gy + cdy - 1);
                g_s[2] = best_k / 9;
            }  // else K8: the MVP carries on unchanged
            int32_t* o = mvs + ((size_t)s * L + j) * 3;
            o[0] = g_s[0];
            o[1] = g_s[1];
            o[2] = g_s[2];
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int so_rowscan_pass(const void* cur, const void* planes, const void* seeds, int nref, int h, int w,
                               int n, int fme, int g_row0, int H, void* mvs, void* stream) {
    const int S = h / n;
    if (S == 0 || w / n == 0) return 0;
    // the sums and the MVP, the current block, the regions (the wrapper holds this below 48 KB)
    const int smem = (9 * nref + 4) * (int)sizeof(int) + n * n + nref * (fme ? 4 : 1) * (n + 2) * (n + 2);
    rowscan_pass_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)planes, (const int32_t*)seeds, nref, w, n, fme, g_row0, H,
        (int32_t*)mvs);
    return (int)cudaGetLastError();
}
