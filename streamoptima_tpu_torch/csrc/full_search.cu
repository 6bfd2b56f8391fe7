// Whole-pel full-search motion estimation for Hopper (sm_90a).
//
// Replaces: streamoptima_tpu/core/me_pallas.py, _plane_search as reached
// through full_search_pallas (whole-pel, want_pred=True, no VBS).  For every
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
    for (int off = 16; off > 0; off >>= 1) {
        unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
        v = o < v ? o : v;
    }
    return v;
}

__global__ void full_search_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ refs,
                                   int nref, int h, int w, int sr, int bs,
                                   int32_t* __restrict__ mv_out, int32_t* __restrict__ sad_out,
                                   uint8_t* __restrict__ ok_out, int16_t* __restrict__ pred_out) {
    extern __shared__ int32_t smem[];
    __shared__ unsigned long long s_red[32];
    const int nd = 2 * sr + 1;
    const int ncand = nd * nd;
    const int ww = bs + 2 * sr;
    int32_t* s_cur = smem;                                        // bs * bs
    uint8_t* s_win = reinterpret_cast<uint8_t*>(smem + bs * bs);  // ww * ww
    const int bj = blockIdx.x, bi = blockIdx.y;
    const int bx = bj * bs, by = bi * bs;
    const int tid = threadIdx.x;

    for (int t = tid; t < bs * bs; t += blockDim.x) {
        s_cur[t] = cur[(size_t)(by + t / bs) * w + bx + t % bs];
    }
    unsigned long long best = kNone;
    for (int r = 0; r < nref; ++r) {
        const uint8_t* ref = refs + (size_t)r * h * w;
        __syncthreads();  // the previous reference's window is no longer read
        for (int t = tid; t < ww * ww; t += blockDim.x) {
            const int y = by - sr + t / ww, x = bx - sr + t % ww;
            s_win[t] = (y >= 0 && y < h && x >= 0 && x < w) ? ref[(size_t)y * w + x] : 0;
        }
        __syncthreads();
        for (int c = tid; c < ncand; c += blockDim.x) {
            const int dyi = c / nd, dxi = c % nd;
            const int dx = dxi - sr, dy = dyi - sr;
            const int px = bx + dx, py = by + dy;
            // the reference's strict bounds (x + dx == W - bs is invalid)
            if (px < 0 || px >= w - bs || py < 0 || py >= h - bs) continue;
            const uint8_t* wp = s_win + dyi * ww + dxi;
            int sad = 0;
            for (int i = 0; i < bs; ++i) {
                const int32_t* cr = s_cur + i * bs;
                const uint8_t* rr = wp + i * ww;
                for (int j = 0; j < bs; ++j) sad += abs(cr[j] - (int)rr[j]);
            }
            const unsigned l1 = (unsigned)(abs(dx) + abs(dy));
            const unsigned sec = ((((l1 << 3) | (unsigned)r) << 8 | (unsigned)dxi) << 8) | (unsigned)dyi;
            const unsigned long long key = ((unsigned long long)(unsigned)sad << 32) | sec;
            best = key < best ? key : best;
        }
    }
    best = warp_min(best);
    const int warp = tid >> 5, lane = tid & 31;
    if (lane == 0) s_red[warp] = best;
    __syncthreads();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        best = warp_min(lane < nw ? s_red[lane] : kNone);
        if (lane == 0) s_red[0] = best;
    }
    __syncthreads();
    best = s_red[0];

    const bool ok = best != kNone;
    const unsigned sec = (unsigned)(best & 0xffffffffull);
    const int wdy = ok ? (int)(sec & 0xff) - sr : 0;
    const int wdx = ok ? (int)((sec >> 8) & 0xff) - sr : 0;
    const int wref = ok ? (int)((sec >> 16) & 0x7) : 0;
    const int b = bi * gridDim.x + bj;
    if (tid == 0) {
        mv_out[3 * b] = wdx;
        mv_out[3 * b + 1] = wdy;
        mv_out[3 * b + 2] = wref;
        sad_out[b] = ok ? (int32_t)(best >> 32) : 0x7fffffff;
        ok_out[b] = ok ? 1 : 0;
    }
    // a valid winner's window lies inside the frame, so read it directly
    const uint8_t* ref = refs + (size_t)wref * h * w;
    for (int t = tid; t < bs * bs; t += blockDim.x) {
        const int i = t / bs, j = t % bs;
        pred_out[(size_t)(by + i) * w + bx + j] =
            ok ? (int16_t)ref[(size_t)(by + wdy + i) * w + bx + wdx + j] : (int16_t)0;
    }
}

}  // namespace

extern "C" int so_full_search(const void* cur, const void* refs, int nref, int h, int w, int sr, int bs,
                              void* mv, void* sad, void* ok, void* pred, void* stream) {
    const int nd = 2 * sr + 1;
    int threads = ((nd * nd + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    const int ww = bs + 2 * sr;
    const size_t smem = (size_t)bs * bs * sizeof(int32_t) + (size_t)ww * ww;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(full_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(w / bs, h / bs);
    full_search_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)refs, nref, h, w, sr, bs, (int32_t*)mv, (int32_t*)sad,
        (uint8_t*)ok, (int16_t*)pred);
    return (int)cudaGetLastError();
}
