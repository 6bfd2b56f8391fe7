// Run-length decoding of a binary container's coefficient lists for Hopper
// (sm_90a): one launch a decoded stream, straight into the decoders'
// merged payload.
//
// Replaces: no TPU kernel.  The JAX package decodes the container's lists
// on the host (streamoptima_tpu/native/entropy.cpp rle_decode_blocks into
// int64 blocks, called by binstream.read_binary), and its decoders copy the
// dense coefficients in.  This kernel moves that decoding onto the card:
// the container's symbols are copied in as they lie in the file, and the
// payload is written here.  The port's plain version is core/kernels.py
// rle_unpack_plain.
//
// The input, one byte buffer (F frames of nb blocks of n x n, s = n / 2):
//   [0, 32F)         per frame four int64: the byte positions in the buffer
//                    of its offs_f (u32, one more than its unsplit blocks),
//                    vals_f (int16), offs_q (u32, four a split block, and
//                    one more) and vals_q (int16): the container's fields
//   [32F, 32F + 4F nb) int32 (F, nb): each block's unit index, r >= 0 the
//                    r-th unsplit block of its frame, r < 0 the ~r-th split
//   the rest         the frames' fields, copied from the file.
// offs_q may lie only 2-byte aligned (vals_f holds any count of int16), so
// offsets are read as two halves; the host has checked them (they start at
// 0, never fall, and end at the field's value count).
//
// The function, per unit (an unsplit block, or one quad of a split block,
// Z order): rle_decode_blocks's walk over the unit's list of `len` symbols
// into m = n^2 or s^2 positions of the diagonal scan (core/zigzag.py), every
// other position 0.  A header c < 0 copies the next min(-c, len - i - 1,
// m - s) symbols and skips -c (clamped to the list); c > 0 skips c
// positions; 0 ends the unit, as do the list's end and position m.  The
// output, (F, nb, n, n) int16, is the payload the decoders read: an
// unsplit block's slot its coefficients, a split block's its four quads
// laid out as its 2 x 2 tiles (qq.reshape(2, 2, s, s).swapaxes).
//
// What bounds it on this card.  Bytes: the symbols read once and the
// payload written once, 2.6 MB a 720p frame (0.8 MB of symbols, 1.8 MB of
// payload), 0.8 us at 3.35 TB/s.  The walk is serial in a unit's runs.
//
// Design.  A warp a block.  The warp's slot is staged in shared memory in
// raster order, zeroed with 16-byte stores; the unit's first 2m symbols
// (all a walk can read: each header but the last moves the scan position on
// by at least one, as does each value) are staged with coalesced loads.
// Every lane then walks the headers in step (one broadcast read a header),
// and a run's values are scattered by the lanes in parallel through the
// scan table staged in shared memory.  The slot is written once, with
// 16-byte stores: no memset, no payload byte written twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 16;
constexpr int kMaxM = kMaxN * kMaxN;
constexpr int kSym = 2 * kMaxM;  // the symbols a unit's walk can read

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {  // 2-byte aligned
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
    return (uint32_t)h[0] | ((uint32_t)h[1] << 16);
}

// One unit: its list `list` of `len` symbols into the m scan positions whose
// slot elements `dst` names, in the warp's zeroed `stage`.  `sym`: the warp's
// symbol stage.
__device__ __forceinline__ void decode_unit(const int16_t* __restrict__ list, long long len, int m,
                                            const int16_t* dst, int16_t* stage, int16_t* sym) {
    const int lane = threadIdx.x & 31;
    // A walk ends within 2m + 32769 symbols, so a longer list reads as one of 2^30: 32-bit arithmetic is exact.
    const int n = (int)(len < (1LL << 30) ? len : (1LL << 30));
    const int staged = min(n, 2 * m);
    for (int k = lane; k < staged; k += 32) sym[k] = list[k];
    __syncwarp();
    int i = 0, s = 0;
    while (i < n && s < m) {
        const int c = i < staged ? sym[i] : list[i];
        if (c < 0) {
            const int run = min(-c, n - i);
            const int cnt = min(min(run, n - i - 1), m - s);
            for (int k = lane; k < cnt; k += 32) {
                const int j = i + 1 + k;
                stage[dst[s + k]] = j < staged ? sym[j] : list[j];
            }
            s += cnt;
            i += run;
        } else {
            if (c == 0) break;
            s += min(c, m);
        }
        ++i;
    }
    __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
rle_unpack_kernel(const uint8_t* __restrict__ buf, int F, int nb, int n, const int32_t* __restrict__ scan_full,
                  const int32_t* __restrict__ scan_quad, int16_t* __restrict__ out) {
    // [0, nn): the full block's scan position -> slot element; [nn + q ss, nn + (q + 1) ss): quad q's
    __shared__ int16_t s_dst[2 * kMaxM];
    __shared__ __align__(16) int16_t s_stage[kWarps][kMaxM];
    __shared__ int16_t s_sym[kWarps][kSym];
    const int nn = n * n, hs = n / 2, ss = hs * hs;
    for (int t = threadIdx.x; t < nn; t += kThreads) {
        s_dst[t] = (int16_t)scan_full[t];
        const int q = t / ss, r = scan_quad[t % ss];
        s_dst[nn + t] = (int16_t)(((q >> 1) * hs + r / hs) * n + (q & 1) * hs + r % hs);
    }
    __syncthreads();
    const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (gw >= (long long)F * nb) return;  // warp-uniform, after the only barrier
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long* tab = reinterpret_cast<const long long*>(buf) + 4LL * (gw / nb);
    const int u = reinterpret_cast<const int32_t*>(buf + 32LL * F)[gw];
    int16_t* stage = s_stage[warp];
    uint4* stage4 = reinterpret_cast<uint4*>(stage);
    const int words = nn / 8;  // 16-byte words of a slot
    for (int k = lane; k < words; k += 32) stage4[k] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    if (u >= 0) {
        const uint8_t* offs = buf + tab[0] + 4LL * u;
        const uint32_t o0 = load_u32(offs), o1 = load_u32(offs + 4);
        decode_unit(reinterpret_cast<const int16_t*>(buf + tab[1]) + o0, (long long)o1 - (long long)o0, nn, s_dst,
                    stage, s_sym[warp]);
    } else {
        const uint8_t* offs = buf + tab[2] + 16LL * ~u;
        const int16_t* vals = reinterpret_cast<const int16_t*>(buf + tab[3]);
        for (int q = 0; q < 4; ++q) {
            const uint32_t o0 = load_u32(offs + 4 * q), o1 = load_u32(offs + 4 * q + 4);
            decode_unit(vals + o0, (long long)o1 - (long long)o0, ss, s_dst + nn + q * ss, stage, s_sym[warp]);
        }
    }
    uint4* slot = reinterpret_cast<uint4*>(out + gw * nn);
    for (int k = lane; k < words; k += 32) slot[k] = stage4[k];
}

}  // namespace

// buf: the device byte buffer above, 16-byte aligned; F frames of nb blocks
// of n x n; scan_full / scan_quad: the diagonal scan's flat indices of n and
// n / 2 (int32); out: (F, nb, n, n) int16, 16-byte aligned, every element
// written.  Returns a CUDA error code (cudaErrorInvalidValue for n outside
// {4, 8, 16}).
extern "C" int so_rle_unpack(const void* buf, int F, int nb, int n, const void* scan_full, const void* scan_quad,
                             void* out, void* stream) {
    if (n != 4 && n != 8 && n != 16) return (int)cudaErrorInvalidValue;
    if (F <= 0 || nb <= 0) return 0;
    const long long warps = (long long)F * nb;
    rle_unpack_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)buf, F, nb, n, (const int32_t*)scan_full, (const int32_t*)scan_quad, (int16_t*)out);
    return (int)cudaGetLastError();
}
