// Mode-0 intra reconstruction for Hopper (sm_90a): one launch a frame.
//
// Replaces: no TPU kernel.  The JAX package runs this scan as one
// jax.lax.scan over block columns inside the engine's jit
// (streamoptima_tpu/core/intra.py:343-383, _intra_reconstruct_jax_select;
// for sr < bs the bounded-depth wavefront, :386).  The port's plain version
// is core/intra.py intra_reconstruct_mode0 followed by pred.wrap_uint8.
//
// The function.  Block rows are independent; along a row the blocks are
// reconstructed in column order.  Pixel (i, j) of the block at pixel column
// x takes m = the block's MV, or, where the block is split (VBS), the MV of
// its quad q = 2 (i >= s) + (j >= s) (Z order, s = bs / 2).  It reads the
// already reconstructed pixel (i, x + j + m) when -sr <= m <= 0, j + m < 0
// and x + j + m >= 0, and 128 otherwise: the columns at and right of x are
// still the fill, the block's own quads included, and an MV out of range
// (a damaged stream) reads nothing.  It adds its residual, the block's
// rf[i][j] or the quad's rq[q][i % s][j % s].  The result is stored mod
// 256.  Addition commutes with the wrap mod 256, so the kernel keeps the
// reconstructed columns as bytes; the plain version keeps int32 and wraps
// once at the end, and both give the same bytes.
//
// transpose (intra mode 1: mode 0 on the transposed frame): the blocks are
// numbered in raster order of the transposed frame, but every residual is
// given as it lies in the frame (rf[b] is the transposed frame's block
// transposed; each quad likewise, its Z index in the transposed frame), and
// the output is the frame itself.  Thread t then takes pixel (i, j) =
// (t % bs, t / bs), so that neighbouring threads still read neighbouring
// residual words and write neighbouring output bytes.
//
// What bounds it on this card.  The bytes are few (at 720p with VBS about
// 8.4 MB: the two residual planes as int32, the MVs, the flags, the frame
// out), 2.5 us at 3.35 TB/s; the work is a chain of nbc dependent column
// steps per block row, and only nbr CTAs (45 at 720p) run at all.  The time
// is the chain: per step one shared-memory read, an add, one shared-memory
// write, one byte to global memory and one barrier.  The design keeps the
// global loads off the chain: each thread loads its pixel's residuals,
// MVs and split flag kPrefetch columns ahead into registers (both the
// block's and the quad's values, so no load waits on the flag), and the
// reconstructed columns live in shared memory.
//
// Design: one CTA per block row, one thread per pixel of the bs x bs block
// (bs <= 32).  The reconstructed pixels of the row sit in a ring of kRing
// byte columns per pixel row: column X at slot X % kRing.
//
// Shared-memory ordering (no race detector runs on the card's machine, so
// the argument is written here).  Step c reads slots of columns [x - sr, x)
// and writes the slots of columns [x, x + bs), x = c * bs.
//   1. Within a step, no thread writes a slot another thread reads: the
//      read columns and the written ones span sr + bs <= kRing consecutive
//      columns, so their slots differ (the wrapper checks sr + bs <= kRing).
//   2. A column read in step c was written in an earlier step (it lies left
//      of x and at or right of 0), and the __syncthreads() that ends every
//      step orders that write before this read.
//   3. It still holds that column: its slot is written again only by column
//      X + kRing >= x - sr + kRing >= x + bs, in a later step, after the
//      barrier that ends step c, so after every read of step c.
// Hence one barrier per column, and every read sees the value the
// sequential order gives it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRing = 256;        // byte columns of the ring, a power of two
constexpr int kPitch = kRing + 4; // one bank between pixel rows
constexpr int kMaxBs = 32;        // bs * bs threads
constexpr int kPrefetch = 4;      // columns loaded ahead of the chain

struct Px {  // one pixel's inputs for one column
    int m_full, m_quad, r_full, r_quad;
    uint8_t split;
};

__global__ void __launch_bounds__(kMaxBs * kMaxBs)
intra_recon_kernel(const int32_t* __restrict__ rf, const int32_t* __restrict__ rq, const uint8_t* __restrict__ split,
                   const int32_t* __restrict__ mv, const int32_t* __restrict__ smv, int nbc, int bs, int sr,
                   int transpose, uint8_t* __restrict__ out) {
    __shared__ uint8_t ring[kMaxBs * kPitch];
    const int row = blockIdx.x;
    const int nbr = gridDim.x;
    const int t = threadIdx.x;
    const int i = transpose ? t % bs : t / bs;  // the pixel's row and column in the block
    const int j = transpose ? t / bs : t % bs;
    const int s = bs >> 1;
    const bool vbs = rq != nullptr;
    const int q = vbs ? 2 * (i >= s) + (j >= s) : 0;
    // residual offsets within a block (rf: t in both layouts) and within its quad
    const int qoff = vbs ? (transpose ? (j % s) * s + i % s : (i % s) * s + j % s) : 0;
    const int64_t blk0 = (int64_t)row * nbc;
    uint8_t* my_ring = ring + i * kPitch;

    auto load = [&](int c) {
        const int64_t b = blk0 + c;
        Px p;
        p.m_full = mv[b];
        p.r_full = rf[b * bs * bs + t];
        if (vbs) {
            p.split = split[b];
            p.m_quad = smv[b * 4 + q];
            p.r_quad = rq[(b * 4 + q) * s * s + qoff];
        } else {
            p.split = 0;
            p.m_quad = p.r_quad = 0;
        }
        return p;
    };

    Px pre[kPrefetch];
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k)
        if (k < nbc) pre[k] = load(k);

    for (int c0 = 0; c0 < nbc; c0 += kPrefetch) {
#pragma unroll
        for (int k = 0; k < kPrefetch; ++k) {
            const int c = c0 + k;
            if (c < nbc) {  // the same for every thread of the CTA
                const Px p = pre[k];
                if (c + kPrefetch < nbc) pre[k] = load(c + kPrefetch);
                const int m = p.split ? p.m_quad : p.m_full;
                const int x = c * bs;
                int v = 128;
                if (m >= -sr && m <= 0) {  // then x + j + m cannot overflow
                    const int src = x + j + m;
                    if (src < x && src >= 0) v = my_ring[src & (kRing - 1)];
                }
                v += p.split ? p.r_quad : p.r_full;
                const uint8_t byte = (uint8_t)v;
                my_ring[(x + j) & (kRing - 1)] = byte;
                const int64_t o = transpose ? (int64_t)(x + j) * nbr * bs + row * bs + i
                                            : ((int64_t)row * bs + i) * nbc * bs + x + j;
                out[o] = byte;
            }
            __syncthreads();  // ends the step: orders its ring writes before the next step's reads
        }
    }
}

}  // namespace

// rf: (nbr * nbc, bs, bs) int32; rq: (nb, 4, s, s) int32 or null (no VBS),
// then split: (nb,) bytes (0 or 1) and smv: (nb, 4) int32, else unread;
// mv: (nb,) int32.  nbr x nbc blocks of the (transposed, if transpose)
// frame; out: the (nbr * bs, nbc * bs) frame, or with transpose its
// (nbc * bs, nbr * bs) transpose, uint8.  Returns a CUDA error code
// (cudaErrorInvalidValue for bs outside [1, 32], sr < 0 or sr + bs > 256, or
// VBS with an odd bs).
extern "C" int so_intra_recon(const void* rf, const void* rq, const void* split, const void* mv, const void* smv,
                              int nbr, int nbc, int bs, int sr, int transpose, void* out, void* stream) {
    if (bs < 1 || bs > kMaxBs || sr < 0 || sr + bs > kRing || (rq != nullptr && bs % 2))
        return (int)cudaErrorInvalidValue;
    if (nbr <= 0 || nbc <= 0) return 0;
    intra_recon_kernel<<<nbr, bs * bs, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rf, (const int32_t*)rq, (const uint8_t*)split, (const int32_t*)mv, (const int32_t*)smv, nbc,
        bs, sr, transpose != 0, (uint8_t*)out);
    return (int)cudaGetLastError();
}
