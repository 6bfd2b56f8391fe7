// Prediction fetch for Hopper (sm_90a): whole-pel or half-pel (FME), each
// with or without the VBS quad plane.
//
// Replaces: streamoptima_tpu/core/me_pallas.py, pred_fetch_compact, in its
// four modes (whole-pel or FME parity planes, with or without the quad
// plane: `fme` picks the planes, a null `pred_q` drops the quads), together
// with the FME case-B mask the JAX decoder applies after it
// (fme_caseB_valid2) and the XLA gather step it sends case-C FME frames to.
// Each output pixel takes its (sub)block's prediction for the block's MV
// (dx, dy, ref), exactly core/pred.gather_predictions:
//   whole-pel: refs[ref][y + dy][x + dx], zero outside the frame;
//   FME, on the (2h-1, 2w-1) half-pel grid at (px, py) = (2x0 + dx, 2y0 + dy)
//   for the (sub)block at (x0, y0) of size n:
//     A. primary bounds and margin hold: grid pixel (py + 2i, px + 2j);
//     B. primary bounds hold, margin fails: 128;
//   the margin is 0 <= p + 2n < D - m on each axis (D the grid's extent),
//   with m = n for full blocks and m = quad_margin for quads: n (the native
//   engine's N10 fix) or the parent block's size (quirk K18, the compat
//   engine's reconstruction and decode);
//     C. primary bounds fail: grid pixel (py + i, px + j), zero off the grid.
// Grid pixel (Y, X) is parity plane (Y & 1, X & 1) at (Y >> 1, X >> 1); the
// zero row and column the planes are padded with are not grid pixels.  The
// TPU kernel's host-built table of distinct MVs, its 8 row-shifted planes
// and its 128-lane barrel shifter were TPU DMA alignment devices and are not
// carried over: each segment reads its own (sub)block's MV, so every MV a
// stream can hold is served in every case (no dispatch split, no fallback).
// Encode calls it on the search winners, decode on transmitted MVs.
//
// What bounds it on this card: device-memory traffic, one plane byte read
// and two bytes written per output pixel (per plane: full block, quads),
// plus the MV reads, which hit L1/L2: at 720p ~2.7 MB per frame whole-pel
// and ~5.4 MB with FME + quads, under 2 us at HBM rates.  At this size the
// launch and the grid's ramp take much of the time.  So the design cuts the
// work per pixel, not the bytes: a thread per pixel that decided the MV,
// the reference check and the FME case for itself, with two divisions and
// 64-bit index arithmetic, spent more instructions on that than on the copy.
//
// Design: one thread per row segment of a (sub)block, up to 8 output pixels
// (16 bytes of int16).  Threads along x take consecutive segments of one
// frame row, so a warp stores 512 contiguous bytes at bs = 16; blockIdx.z
// picks the plane (full blocks, or the quads with their own MVs).  A
// segment's (sub)block comes from its indices with one division a segment
// (shifts at bs = 16, the codec's default and a template constant), and its
// MV, reference check and FME case are decided once.  A segment that reads
// one contiguous run of one plane row inside the frame (whole-pel, and case
// A, whose stride-2 grid pixels are one parity plane's consecutive bytes)
// takes it with two or three aligned word loads and funnel shifts where the
// planes' rows are word-aligned; case C alternates between two parity
// planes, and edge segments test each pixel.  Full 8-pixel segments store 16
// bytes at once where the row allows, others pixel by pixel.  Bounds are
// tested in 64-bit arithmetic once a segment (an MV may be any int32); the
// indices then fit 32 bits and only the final offsets are size_t.  A
// reference index outside [0, nref) writes zeros, keeping the kernel
// memory-safe; the host rejects such streams before launch.
//
// Band inputs (pred_fetch_compact's read_row0, with the frame-coordinate
// case-B margin of fme_caseB_valid2): the output may be a mesh tile, frame
// rows [g_row0, g_row0 + h), and refs a band of bandh frame rows whose row
// band_row0 holds the tile's row 0; H is the frame's height.  Every case and
// bound is decided at frame rows; a read that lies in the frame but outside
// the band takes the band's nearest row (core/pred.gather_predictions' band
// form), so any MV is served memory-safely.  The defaults (bandh = H = h,
// band_row0 = g_row0 = 0) are the whole frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegs = 32, kRows = 8;  // a CTA: 32 segments of each of 8 frame rows

// the band row that frame row y (in the frame, so 32-bit) reads: the
// nearest of the band's nrows rows, which start at frame row org (half-pel
// grid rows under FME)
__device__ __forceinline__ int band_row(int y, int org, int nrows) {
    return min(max(y - org, 0), nrows - 1);
}

// pixel t of a segment into its int16 slot: two pixels a word
__device__ __forceinline__ void put(uint32_t (&v)[4], int t, uint32_t px) { v[t >> 1] |= px << (16 * (t & 1)); }

// the 8 bytes at p, one run of a plane row, as eight int16 pixels.  words:
// the row starts on a word, so the words holding the run lie inside it
__device__ __forceinline__ void run8(const uint8_t* __restrict__ p, bool words, uint32_t (&v)[4]) {
    uint32_t lo, hi;
    if (words) {
        const int o = (int)((uintptr_t)p & 3);
        const uint32_t* q = reinterpret_cast<const uint32_t*>(p - o);
        const uint32_t w0 = __ldg(q), w1 = __ldg(q + 1), w2 = o ? __ldg(q + 2) : 0u;
        lo = __funnelshift_r(w0, w1, 8 * o);
        hi = __funnelshift_r(w1, w2, 8 * o);
    } else {
        lo = hi = 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            lo |= (uint32_t)__ldg(p + t) << (8 * t);
            hi |= (uint32_t)__ldg(p + 4 + t) << (8 * t);
        }
    }
    v[0] = __byte_perm(lo, 0u, 0x4140);
    v[1] = __byte_perm(lo, 0u, 0x4342);
    v[2] = __byte_perm(hi, 0u, 0x4140);
    v[3] = __byte_perm(hi, 0u, 0x4342);
}

// the segment's len pixels from one run of a plane row (row: the row's first
// byte; x: the run's first column, the run inside the row)
__device__ __forceinline__ void run(const uint8_t* __restrict__ row, int x, int len, bool words, uint32_t (&v)[4]) {
    if (len == 8) {
        run8(row + x, words, v);
        return;
    }
    for (int t = 0; t < len; ++t) put(v, t, __ldg(row + x + t));
}

// blockIdx.z: 0 the full blocks' plane, 1 the quads'.  BSC: the block size when it is known at compile time
// (16), else 0
template <int BSC>
__global__ void __launch_bounds__(kSegs * kRows)
    pred_fetch_kernel(const int32_t* __restrict__ mv, const int32_t* __restrict__ smv,
                      const uint8_t* __restrict__ refs, int nref, int h, int w, int bs_arg, int fme, int bandh,
                      int band_row0, int g_row0, int H, int quad_margin, int16_t* __restrict__ pred,
                      int16_t* __restrict__ pred_q) {
    const int bs = BSC ? BSC : bs_arg;
    const bool quad = blockIdx.z != 0;
    const int n = quad ? bs / 2 : bs;  // the (sub)block's size
    const int margin = quad ? quad_margin : n;  // the FME margin's subtrahend
    const int nseg = (n + 7) >> 3;     // segments of one of its rows
    const int per = quad ? 2 * nseg : nseg;  // segments across a block row
    const int nbc = w / bs;
    const int y = blockIdx.y * kRows + threadIdx.y;
    const int sg = blockIdx.x * kSegs + threadIdx.x;
    if (y >= h || sg >= nbc * per) return;
    const int bj = sg / per, c = (sg - bj * per) / nseg, g = sg - bj * per - c * nseg;  // block, column half, seg
    const int bi = y / bs, i = y - bi * bs;
    const int rh = quad && i >= n;  // the quad's row half
    const int ii = i - rh * n;      // the row inside the (sub)block
    const int b = bi * nbc + bj;
    const int32_t* m = quad ? smv + 3 * (4 * b + 2 * rh + c) : mv + 3 * b;  // quads in Z order: TL, TR, BL, BR
    const int x0 = bj * bs + c * n, gy0 = g_row0 + bi * bs + rh * n;  // the (sub)block's column and frame row
    const int j0 = 8 * g, len = min(8, n - j0);  // the segment: columns [j0, j0 + len) of the (sub)block
    const int org = g_row0 - band_row0;          // the frame row of the band's row 0
    const bool words = ((uintptr_t)refs & 3) == 0 && (w & 3) == 0;
    const int dx = m[0], dy = m[1], r = m[2];

    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (r >= 0 && r < nref) {
        if (!fme) {
            const long long sy = (long long)gy0 + dy + ii, sx = (long long)x0 + dx + j0;
            if (sy >= 0 && sy < H && sx + len > 0 && sx < w) {
                const uint8_t* row = refs + ((size_t)r * bandh + band_row((int)sy, org, bandh)) * w;
                const int x = (int)sx;
                if (x >= 0 && x + len <= w) {
                    run(row, x, len, words, v);
                } else {
                    for (int t = 0; t < len; ++t) {
                        if (x + t >= 0 && x + t < w) put(v, t, __ldg(row + x + t));
                    }
                }
            }
        } else {
            const int H2 = 2 * H - 1, W2 = 2 * w - 1;
            const long long px = 2LL * x0 + dx, py = 2LL * gy0 + dy;
            const uint8_t* planes = refs + (size_t)r * 4 * bandh * w;
            if (px >= 0 && px < W2 - n && py >= 0 && py < H2 - n) {
                if (px + 2 * n < W2 - margin && py + 2 * n < H2 - margin) {
                    // case A: grid row py + 2ii, columns px + 2j: one parity plane's consecutive bytes
                    const int Yb = band_row((int)py + 2 * ii, 2 * org, 2 * bandh - 1);
                    const uint8_t* row = planes + ((size_t)((Yb & 1) * 2 + ((int)px & 1)) * bandh + (Yb >> 1)) * w;
                    run(row, ((int)px >> 1) + j0, len, words, v);
                } else {
                    v[0] = v[1] = v[2] = v[3] = 0x00800080u;  // case B: 128
                }
            } else {
                // case C: grid row py + ii, columns px + j, zero off the grid: the two parity planes alternate
                const long long Y = py + ii, X = px + j0;
                if (Y >= 0 && Y < H2 && X + len > 0 && X < W2) {
                    const int Yb = band_row((int)Y, 2 * org, 2 * bandh - 1);
                    const uint8_t* row = planes + ((size_t)(Yb & 1) * 2 * bandh + (Yb >> 1)) * w;  // X even
                    const int x = (int)X;
                    for (int t = 0; t < len; ++t) {
                        const int xt = x + t;
                        if (xt >= 0 && xt < W2) put(v, t, __ldg(row + (size_t)(xt & 1) * bandh * w + (xt >> 1)));
                    }
                }
            }
        }
    }
    int16_t* out = (quad ? pred_q : pred) + (size_t)y * w + x0 + j0;
    if (len == 8 && ((uintptr_t)out & 15) == 0) {
        *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
        for (int t = 0; t < len; ++t) out[t] = (int16_t)(v[t >> 1] >> (16 * (t & 1)));
    }
}

}  // namespace

extern "C" int so_pred_fetch(const void* mv, const void* smv, const void* refs, int nref, int h, int w, int bs,
                             int fme, int bandh, int band_row0, int g_row0, int H, int quad_margin, void* pred,
                             void* pred_q, void* stream) {
    // segments across a frame row: per block, ceil(bs / 8) of the full plane, 2 ceil(bs / 16) of the quads'
    const int segs = (w / bs) * ((bs + 7) / 8 > 2 * ((bs / 2 + 7) / 8) ? (bs + 7) / 8 : 2 * ((bs / 2 + 7) / 8));
    dim3 block(kSegs, kRows);
    dim3 grid((segs + kSegs - 1) / kSegs, (h + kRows - 1) / kRows, pred_q == nullptr ? 1 : 2);
    auto kernel = bs == 16 ? pred_fetch_kernel<16> : pred_fetch_kernel<0>;
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const int32_t*)mv, (const int32_t*)smv, (const uint8_t*)refs,
                                                     nref, h, w, bs, fme, bandh, band_row0, g_row0, H,
                                                     quad_margin, (int16_t*)pred, (int16_t*)pred_q);
    return (int)cudaGetLastError();
}
