// Whole-pel decode prediction fetch for Hopper (sm_90a).
//
// Replaces: streamoptima_tpu/core/me_pallas.py, pred_fetch_compact
// (whole-pel, no VBS).  Each output pixel takes refs[ref][y + dy][x + dx]
// for its block's transmitted MV (dx, dy, ref), zero outside the frame —
// exactly core/pred.gather_predictions, which the TPU kernel reproduced from
// a zero-padded plane.  The TPU kernel's host-built table of distinct MVs,
// its 8 row-shifted planes and its 128-lane barrel shifter were TPU DMA
// alignment devices and are not carried over: each thread reads its own
// block's MV, so every whole-pel MV is served (no dispatch split, no
// fallback).
//
// What bounds it on this card: device-memory traffic (one byte read and two
// bytes written per pixel, plus the MV reads, which hit L1/L2).  At 720p
// that is ~2.8 MB per frame, a few microseconds at HBM rates; launch
// overhead dominates at this size.
//
// Design: one thread per output pixel in a 2D grid of 32x8 tiles, so a warp
// reads one block row's 32 consecutive pixels (coalesced whenever the MV
// keeps them in one reference row).  A reference index outside [0, nref)
// writes zeros, keeping the kernel memory-safe; the host rejects such
// streams before launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pred_fetch_kernel(const int32_t* __restrict__ mv, const uint8_t* __restrict__ refs, int nref,
                                  int h, int w, int bs, int16_t* __restrict__ pred) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || y >= h) return;
    const int b = (y / bs) * (w / bs) + x / bs;
    const long long sx = (long long)x + mv[3 * b];
    const long long sy = (long long)y + mv[3 * b + 1];
    const int r = mv[3 * b + 2];
    int16_t v = 0;
    if (r >= 0 && r < nref && sx >= 0 && sx < w && sy >= 0 && sy < h) {
        v = refs[(size_t)r * h * w + (size_t)sy * w + (size_t)sx];
    }
    pred[(size_t)y * w + x] = v;
}

}  // namespace

extern "C" int so_pred_fetch(const void* mv, const void* refs, int nref, int h, int w, int bs, void* pred,
                             void* stream) {
    dim3 block(32, 8);
    dim3 grid((w + 31) / 32, (h + 7) / 8);
    pred_fetch_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const int32_t*)mv, (const uint8_t*)refs, nref, h,
                                                                w, bs, (int16_t*)pred);
    return (int)cudaGetLastError();
}
