// Window fetch for Hopper (sm_90a): the fast-ME region gather.
//
// Replaces: streamoptima_tpu/core/me_pallas.py, window_fetch with its
// window_prep.  out[b][p][i][j] = planes[p][by0[b] + i][bx0[b] + j], zero
// outside the plane, for any int32 origin (the fast-ME MVP chain drifts one
// step per block across the whole frame, so origins are not bounded by the
// search range; a window partly outside the plane is partly zero).  The
// confirm pass reads every block's (n+2)^2 candidate region of each plane
// through it, at the origins core/fastme.region_base gives.
//
// The TPU kernel's padded int16 copy of the planes (window_prep), its
// 8-row / 128-lane aligned (32, 256) DMA per block, the two barrel shifts
// that undo the alignment and its ring of DMA slots were TPU devices and are
// not carried over: a thread addresses any byte, so the kernel reads the
// unpadded uint8 planes directly and tests the bounds per element.  Output
// is uint8 (every plane value is a pixel or a ceil-average of pixels).
//
// What bounds it on this card: device-memory traffic: each output byte is
// written once and read once from a plane (neighbouring windows overlap, so
// the distinct plane bytes are fewer than the output's).  The confirm pass
// at 720p with FME writes 3600 * 4 * 18 * 18 = 4.7 MB, a few microseconds at
// HBM rates; launch overhead dominates at this size.
//
// Design: one CUDA block per window, threads striding over its P * rows *
// cols elements with the column fastest, so a warp's stores are contiguous
// and its loads run along plane rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void window_fetch_kernel(const uint8_t* __restrict__ planes, const int32_t* __restrict__ by0,
                                    const int32_t* __restrict__ bx0, int P, int H, int W, int rows, int cols,
                                    uint8_t* __restrict__ out) {
    const int b = blockIdx.x;
    const long long y0 = by0[b], x0 = bx0[b];
    const int per_plane = rows * cols;
    const int total = P * per_plane;
    uint8_t* dst = out + (size_t)b * total;
    for (int e = threadIdx.x; e < total; e += kThreads) {
        const int p = e / per_plane;
        const int rem = e - p * per_plane;
        const int i = rem / cols;
        const long long y = y0 + i, x = x0 + (rem - i * cols);
        uint8_t v = 0;
        if (y >= 0 && y < H && x >= 0 && x < W) v = planes[((size_t)p * H + (size_t)y) * W + (size_t)x];
        dst[e] = v;
    }
}

}  // namespace

extern "C" int so_window_fetch(const void* planes, const void* by0, const void* bx0, int nb, int P, int H, int W,
                               int rows, int cols, void* out, void* stream) {
    if (nb == 0) return 0;
    window_fetch_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)planes, (const int32_t*)by0,
                                                                   (const int32_t*)bx0, P, H, W, rows, cols,
                                                                   (uint8_t*)out);
    return (int)cudaGetLastError();
}
