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
// Design: one thread per output pixel in a 2D grid of 32x8 tiles, so a warp
// writes 32 consecutive pixels of a row.  A thread produces the full-block
// pixel and, when quads are asked for, the quad pixel at the same place.  A
// reference index outside [0, nref) writes zeros, keeping the kernel
// memory-safe; the host rejects such streams before launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// one predicted pixel of the n x n (sub)block at (x0, y0) with MV (dx, dy,
// r), at offset (i, j) inside it
__device__ __forceinline__ int16_t fetch(const uint8_t* __restrict__ refs, int nref, int h, int w, bool fme,
                                         const int32_t* __restrict__ mv, int x0, int y0, int n, int i, int j) {
    const int r = mv[2];
    if (r < 0 || r >= nref) return 0;
    if (!fme) {
        const long long sx = (long long)x0 + mv[0] + j, sy = (long long)y0 + mv[1] + i;
        if (sx < 0 || sx >= w || sy < 0 || sy >= h) return 0;
        return refs[((size_t)r * h + (size_t)sy) * w + (size_t)sx];
    }
    const long long H2 = 2LL * h - 1, W2 = 2LL * w - 1;
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
    const size_t p = (size_t)r * 4 + (size_t)((Y & 1) * 2 + (X & 1));
    return refs[(p * h + (size_t)(Y >> 1)) * w + (size_t)(X >> 1)];
}

__global__ void pred_fetch_kernel(const int32_t* __restrict__ mv, const int32_t* __restrict__ smv,
                                  const uint8_t* __restrict__ refs, int nref, int h, int w, int bs, int fme,
                                  int16_t* __restrict__ pred, int16_t* __restrict__ pred_q) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || y >= h) return;
    const int b = (y / bs) * (w / bs) + x / bs;
    const int x0 = x - x % bs, y0 = y - y % bs;
    pred[(size_t)y * w + x] = fetch(refs, nref, h, w, fme, mv + 3 * b, x0, y0, bs, y - y0, x - x0);
    if (pred_q == nullptr) return;
    const int s = bs / 2;
    const int dr = (y - y0) / s, dc = (x - x0) / s;
    const int q = 4 * b + 2 * dr + dc;  // Z order: TL, TR, BL, BR
    pred_q[(size_t)y * w + x] =
        fetch(refs, nref, h, w, fme, smv + 3 * q, x0 + dc * s, y0 + dr * s, s, y - y0 - dr * s, x - x0 - dc * s);
}

}  // namespace

extern "C" int so_pred_fetch(const void* mv, const void* smv, const void* refs, int nref, int h, int w, int bs,
                             int fme, void* pred, void* pred_q, void* stream) {
    dim3 block(32, 8);
    dim3 grid((w + 31) / 32, (h + 7) / 8);
    pred_fetch_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const int32_t*)mv, (const int32_t*)smv,
                                                                (const uint8_t*)refs, nref, h, w, bs, fme,
                                                                (int16_t*)pred, (int16_t*)pred_q);
    return (int)cudaGetLastError();
}
