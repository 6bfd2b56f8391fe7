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
//     C. primary bounds fail: grid pixel (py + i, px + j), zero off the grid.
// Grid pixel (Y, X) is parity plane (Y & 1, X & 1) at (Y >> 1, X >> 1); the
// zero row and column the planes are padded with are not grid pixels.  The
// TPU kernel's host-built table of distinct MVs, its 8 row-shifted planes
// and its 128-lane barrel shifter were TPU DMA alignment devices and are not
// carried over: each thread reads its own (sub)block's MV, so every MV a
// stream can hold is served in every case (no dispatch split, no fallback).
// Encode calls it on the search winners, decode on transmitted MVs.
//
// What bounds it on this card: device-memory traffic: one plane byte read
// and two bytes written per output pixel (per plane: full block, quads),
// plus the MV reads, which hit L1/L2.  At 720p that is ~2.8 MB per frame
// whole-pel and ~5.5 MB with FME + quads, a few microseconds at HBM rates;
// launch overhead dominates at this size.
//
// Band inputs (pred_fetch_compact's read_row0, with the frame-coordinate
// case-B margin of fme_caseB_valid2): the output may be a mesh tile, frame
// rows [g_row0, g_row0 + h), and refs a band of bandh frame rows whose row
// band_row0 holds the tile's row 0; H is the frame's height.  Every case and
// bound is decided at frame rows; a read that lies in the frame but outside
// the band takes the band's nearest row (core/pred.gather_predictions' band
// form), so any MV is served memory-safely.  The defaults (bandh = H = h,
// band_row0 = g_row0 = 0) are the whole frame.
//
// Design: one thread per output pixel in a 2D grid of 32x8 tiles, so a warp
// writes 32 consecutive pixels of a row.  A thread produces the full-block
// pixel and, when quads are asked for, the quad pixel at the same place.  A
// reference index outside [0, nref) writes zeros, keeping the kernel
// memory-safe; the host rejects such streams before launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the band row that frame row y (in the frame, so 32-bit) reads: the
// nearest of the band's nrows rows, which start at frame row org (half-pel
// grid rows under FME)
__device__ __forceinline__ int band_row(int y, int org, int nrows) {
    return min(max(y - org, 0), nrows - 1);
}

// one predicted pixel of the n x n (sub)block at frame position (x0, y0)
// with MV (dx, dy, r), at offset (i, j) inside it; the band's row 0 is
// frame row org
__device__ __forceinline__ int16_t fetch(const uint8_t* __restrict__ refs, int nref, int bandh, int org, int H,
                                         int w, bool fme, const int32_t* __restrict__ mv, int x0, int y0, int n,
                                         int i, int j) {
    const int r = mv[2];
    if (r < 0 || r >= nref) return 0;
    if (!fme) {
        const long long sx = (long long)x0 + mv[0] + j, sy = (long long)y0 + mv[1] + i;
        if (sx < 0 || sx >= w || sy < 0 || sy >= H) return 0;
        return refs[((size_t)r * bandh + (size_t)band_row((int)sy, org, bandh)) * w + (size_t)sx];
    }
    const long long H2 = 2LL * H - 1, W2 = 2LL * w - 1;
    const long long px = 2LL * x0 + mv[0], py = 2LL * y0 + mv[1];
    long long Y, X;
    if (px >= 0 && px < W2 - n && py >= 0 && py < H2 - n) {
        if (!(px + 2 * n >= 0 && px + 2 * n < W2 - n && py + 2 * n >= 0 && py + 2 * n < H2 - n)) return 128;
        Y = py + 2 * i;  // case A: in the grid by the bounds above
        X = px + 2 * j;
    } else {
        Y = py + i;  // case C
        X = px + j;
        if (Y < 0 || Y >= H2 || X < 0 || X >= W2) return 0;
    }
    const int Yb = band_row((int)Y, 2 * org, 2 * bandh - 1);  // the band's half-pel grid row
    const size_t p = (size_t)r * 4 + (size_t)((Yb & 1) * 2 + (X & 1));
    return refs[(p * bandh + (size_t)(Yb >> 1)) * w + (size_t)(X >> 1)];
}

// nbc = w / bs, the blocks per row, comes from the host: a pixel's block
// index then takes two integer divisions (x / bs, y / bs), not three, and a
// quad's none
__global__ void pred_fetch_kernel(const int32_t* __restrict__ mv, const int32_t* __restrict__ smv,
                                  const uint8_t* __restrict__ refs, int nref, int h, int w, int bs, int nbc, int fme,
                                  int bandh, int band_row0, int g_row0, int H, int16_t* __restrict__ pred,
                                  int16_t* __restrict__ pred_q) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || y >= h) return;
    const int bj = x / bs, bi = y / bs;
    const int b = bi * nbc + bj;
    const int x0 = bj * bs, y0 = bi * bs;
    const int gy0 = g_row0 + y0, org = g_row0 - band_row0;  // frame rows of the block and of the band's row 0
    pred[(size_t)y * w + x] = fetch(refs, nref, bandh, org, H, w, fme, mv + 3 * b, x0, gy0, bs, y - y0, x - x0);
    if (pred_q == nullptr) return;
    const int s = bs / 2;  // bs is even under VBS, so a quad's row and column are comparisons
    const int dr = y - y0 >= s, dc = x - x0 >= s;
    const int q = 4 * b + 2 * dr + dc;  // Z order: TL, TR, BL, BR
    pred_q[(size_t)y * w + x] = fetch(refs, nref, bandh, org, H, w, fme, smv + 3 * q, x0 + dc * s, gy0 + dr * s, s,
                                      y - y0 - dr * s, x - x0 - dc * s);
}

}  // namespace

extern "C" int so_pred_fetch(const void* mv, const void* smv, const void* refs, int nref, int h, int w, int bs,
                             int fme, int bandh, int band_row0, int g_row0, int H, void* pred, void* pred_q,
                             void* stream) {
    dim3 block(32, 8);
    dim3 grid((w + 31) / 32, (h + 7) / 8);
    pred_fetch_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const int32_t*)mv, (const int32_t*)smv,
                                                                (const uint8_t*)refs, nref, h, w, bs, w / bs, fme,
                                                                bandh, band_row0, g_row0, H, (int16_t*)pred,
                                                                (int16_t*)pred_q);
    return (int)cudaGetLastError();
}
