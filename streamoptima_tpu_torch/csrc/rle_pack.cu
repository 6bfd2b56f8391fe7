// Run-length coding of a segment's chosen coefficients for Hopper (sm_90a):
// two launches a segment (the binary container's write of an encode).
//
// Replaces: no TPU kernel.  The JAX package codes the container's
// coefficient lists on the host (streamoptima_tpu/native/entropy.cpp
// rle_encode_blocks over int64 blocks, called by binstream.write_binary).
// This kernel moves that coding onto the card for the tensors a
// package=False encode leaves there; host arrays keep the C++ runtime.  The
// port's plain version is core/kernels.py rle_pack_plain.
//
// The function.  Frame f's inputs (one row of the pointer table): split
// (nb,) bytes, mv (nb,) or (nb, 3) int32 (an intra frame's scalars, or
// triples), sub_mv (nb, 4) or (nb, 4, 3) int32, qf (nb, n, n) and qq (nb,
// 4, s, s) int16, s = n / 2.  A block codes one variant: unsplit, one unit,
// its full block; split, four units, its quads in Z order.  A unit's m
// coefficients are read in the anti-diagonal scan (core/zigzag.py) and
// coded as the reference codes them: a run of L nonzeros as -L and the L
// values, a run of zeros as its count, a trailing zero run as 0.  Its
// length is nnz + the number of runs (transform_select.cu's lens).
//
// The output, one int16 buffer (element offsets; nb blocks, F frames):
//   [0, 4F)          per frame two int32: the symbols of its unsplit
//                    blocks (TF) and of its split blocks (TQ)
//   [4F, 4F + 4)     int32 error bits (1: an MV or a split block's sub-MV
//                    outside int16; 2: a symbol past the buffer), 0 pad
//   A = 4F + 4, then per frame 20 nb: split (nb, 0 / 1), mv (nb, 3: a
//                    split block's zero, an intra frame's in component 0),
//                    sub_mv (nb, 4, 3: an unsplit block's zero), the unit
//                    lengths (nb, 4: unsplit (L, 0, 0, 0), split the quads')
//   S0 = A + 20 nb F, the symbols: frame after frame, each frame's unsplit
//                    blocks' lists in raster order, then its split blocks'
//                    quad lists, as the container stores them.
// Symbols past `limit` (the buffer's length) are dropped and flagged: the
// host sizes the buffer from the frames' coded lengths, which it already
// holds, and checks the totals against them.
//
// What bounds it on this card.  Bytes: the variant each block uses is read
// (512 bytes a 16x16 block, its full block or its four quads), twice (once
// to count, once to write), plus the header and the symbols written once;
// at 720p about 3.7 MB a frame read and 0.9 MB written, 1.4 us a frame at
// 3.35 TB/s.  The work per coefficient is a few integer operations.
//
// Design.  A warp codes a unit from bit masks: each lane reads the
// coefficients at scan positions lane, lane + 32, ...; __ballot_sync gives
// the nonzero mask of each 32 positions, a run starts where the mask
// changes (and at position 0), and a lane's symbol slot is the count of
// nonzeros before it plus the count of run starts up to it (popc of the
// masks below its bit).  A run's header takes the slot before its first
// position; its length is the distance to the next start.  The masks are
// registers (template W, the unit's 32-position words), so nothing spills.
// The scan tables are staged from device memory into shared memory: the
// lanes read distinct entries, which the constant cache would serialize.
//   Launch 1 (count): a warp per block writes the block's header row and its
//   unit lengths, and adds them into the frame's TF or TQ (one atomic a
//   block).  Launch 2 (write): a CTA per 64 blocks of a frame sums the
//   lengths of the frames and blocks before it (from launch 1's header,
//   in L2), scans its 64 blocks' lengths, and its warps code 8 blocks each
//   into their slots.  The two counts of a unit come from the same code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;  // blocks a CTA of the write launch codes
constexpr int kMaxN = 16;
constexpr int kHdr = 20;  // int16 a block in a frame's header

struct FramePtrs {  // one row of the wrapper's int64 table
    const uint8_t* split;
    const int32_t* mv;
    const int32_t* sub_mv;
    const int16_t* qf;
    const int16_t* qq;
    int64_t ncomp;  // 1: scalar MVs (nb,), (nb, 4); 3: triples
};

// One unit: m coefficients at src, read in the scan order `scan` (shared
// memory), m <= 32 W.  Returns its coded length (every lane); with kWrite
// also writes its symbols at out[pos...], each one below `limit`.
template <int W, bool kWrite>
__device__ __forceinline__ int code_unit(const int16_t* __restrict__ src, const int16_t* scan, int m,
                                         int16_t* __restrict__ out, int64_t pos, int64_t limit, int* flag) {
    const int lane = threadIdx.x & 31;
    int16_t v[W];
    uint32_t nz[W], st[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const int u = 32 * k + lane;
        v[k] = u < m ? src[scan[u]] : (int16_t)0;
        nz[k] = __ballot_sync(0xffffffffu, v[k] != 0);
    }
    int total = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const int left = m - 32 * k;
        const uint32_t valid = left >= 32 ? 0xffffffffu : (left <= 0 ? 0u : (1u << left) - 1u);
        const uint32_t prev = (nz[k] << 1) | (k > 0 ? nz[k - 1] >> 31 : 0u);  // bit u: position u - 1 nonzero
        st[k] = ((nz[k] ^ prev) | (k == 0 ? 1u : 0u)) & valid;
        total += __popc(nz[k]) + __popc(st[k]);
    }
    if (!kWrite) return total;
    const uint32_t lt = (1u << lane) - 1u, le = lt | (1u << lane);
    int nz_below = 0, st_below = 0;  // over the words before k
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const int u = 32 * k + lane;
        const int64_t slot = pos + nz_below + __popc(nz[k] & lt) + st_below + __popc(st[k] & le);
        if ((nz[k] >> lane) & 1u) {
            if (slot < limit) out[slot] = v[k];
            else atomicOr(flag, 2);
        }
        if ((st[k] >> lane) & 1u) {
            int next = m;  // the next run's first position, or the unit's end
            const uint32_t above = st[k] & ~le;
            if (above) {
                next = 32 * k + __ffs(above) - 1;
            } else {
#pragma unroll
                for (int j = W - 1; j > k; --j)
                    if (st[j]) next = 32 * j + __ffs(st[j]) - 1;
            }
            const int len = next - u;
            const int16_t head = (nz[k] >> lane) & 1u ? (int16_t)-len : (int16_t)(next == m ? 0 : len);
            if (slot - 1 < limit) out[slot - 1] = head;
            else atomicOr(flag, 2);
        }
        nz_below += __popc(nz[k]);
        st_below += __popc(st[k]);
    }
    return total;
}

__device__ __forceinline__ void stage_scans(const int32_t* scan_full, const int32_t* scan_quad, int n,
                                            int16_t* s_scan, int16_t* s_scanq) {
    for (int t = threadIdx.x; t < n * n; t += kThreads) s_scan[t] = (int16_t)scan_full[t];
    for (int t = threadIdx.x; t < n * n / 4; t += kThreads) s_scanq[t] = (int16_t)scan_quad[t];
    __syncthreads();
}

__device__ __forceinline__ int16_t narrow(int v, int* flag) {
    if (v < -32768 || v > 32767) atomicOr(flag, 1);
    return (int16_t)v;
}

template <int WF, int WQ>
__global__ void __launch_bounds__(kThreads)
rle_count_kernel(const FramePtrs* __restrict__ tab, int F, int nb, int n, const int32_t* __restrict__ scan_full,
                 const int32_t* __restrict__ scan_quad, int16_t* __restrict__ out) {
    __shared__ int16_t s_scan[kMaxN * kMaxN], s_scanq[kMaxN * kMaxN / 4];
    stage_scans(scan_full, scan_quad, n, s_scan, s_scanq);
    const int64_t gw = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (gw >= (int64_t)F * nb) return;  // warp-uniform, after the only barrier
    const int lane = threadIdx.x & 31;
    const int f = (int)(gw / nb), b = (int)(gw % nb);
    const int nn = n * n, ss = nn / 4;
    const FramePtrs p = tab[f];
    int16_t* hdr = out + 4LL * F + 4 + (int64_t)kHdr * nb * f;
    int* flag = reinterpret_cast<int*>(out + 4LL * F);
    const bool split = p.split[b] != 0;
    if (lane == 0) hdr[b] = split ? 1 : 0;
    if (lane < 3) {
        int v = p.ncomp == 1 ? (lane == 0 ? p.mv[b] : 0) : p.mv[3 * b + lane];
        hdr[nb + 3 * b + lane] = narrow(split ? 0 : v, flag);
    }
    if (lane < 12) {
        const int q = lane / 3, c = lane % 3;
        int v = 0;
        if (split) v = p.ncomp == 1 ? (c == 0 ? p.sub_mv[4 * b + q] : 0) : p.sub_mv[12 * b + lane];
        hdr[4 * nb + 12 * b + lane] = narrow(v, flag);
    }
    int len[4] = {0, 0, 0, 0};
    if (!split) {
        len[0] = code_unit<WF, false>(p.qf + (int64_t)b * nn, s_scan, nn, nullptr, 0, 0, nullptr);
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            len[q] = code_unit<WQ, false>(p.qq + ((int64_t)b * 4 + q) * ss, s_scanq, ss, nullptr, 0, 0, nullptr);
    }
    if (lane == 0) {
        reinterpret_cast<short4*>(hdr + 16LL * nb)[b] =
            make_short4((short)len[0], (short)len[1], (short)len[2], (short)len[3]);
        atomicAdd(reinterpret_cast<int*>(out) + 2 * f + (split ? 1 : 0), len[0] + len[1] + len[2] + len[3]);
    }
}

template <int WF, int WQ>
__global__ void __launch_bounds__(kThreads)
rle_write_kernel(const FramePtrs* __restrict__ tab, int F, int nb, int n, const int32_t* __restrict__ scan_full,
                 const int32_t* __restrict__ scan_quad, int16_t* __restrict__ out, int64_t limit) {
    __shared__ int16_t s_scan[kMaxN * kMaxN], s_scanq[kMaxN * kMaxN / 4];
    __shared__ long long s_red[3][kWarps];
    __shared__ int s_tot[2][2];
    __shared__ int s_off[2][kChunk];  // the chunk's exclusive prefix: unsplit lengths, split lengths
    stage_scans(scan_full, scan_quad, n, s_scan, s_scanq);
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int f = blockIdx.y, c0 = blockIdx.x * kChunk, c1 = min(nb, c0 + kChunk);
    const int nn = n * n, ss = nn / 4;
    const int16_t* hdr = out + 4LL * F + 4 + (int64_t)kHdr * nb * f;
    const short4* lens = reinterpret_cast<const short4*>(hdr + 16LL * nb);
    const int* acc = reinterpret_cast<const int*>(out);
    int* flag = reinterpret_cast<int*>(out + 4LL * F);

    // the symbols of the frames before f, and of this frame's blocks before the chunk, by kind
    long long r[3] = {0, 0, 0};
    for (int g = t; g < f; g += kThreads) r[0] += acc[2 * g] + acc[2 * g + 1];
    for (int b = t; b < c0; b += kThreads) {
        const short4 l = lens[b];
        if (hdr[b]) r[2] += l.x + l.y + l.z + l.w;
        else r[1] += l.x;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        for (int o = 16; o > 0; o >>= 1) r[i] += __shfl_down_sync(0xffffffffu, r[i], o);
        if (lane == 0) s_red[i][warp] = r[i];
    }
    // the chunk's 64 blocks: an inclusive scan in each of the first two warps
    int kf = 0, kq = 0;
    if (warp < 2) {
        const int b = c0 + t;
        if (b < c1) {
            const short4 l = lens[b];
            if (hdr[b]) kq = l.x + l.y + l.z + l.w;
            else kf = l.x;
        }
        int sf = kf, sq = kq;
        for (int o = 1; o < 32; o <<= 1) {
            const int xf = __shfl_up_sync(0xffffffffu, sf, o), xq = __shfl_up_sync(0xffffffffu, sq, o);
            if (lane >= o) {
                sf += xf;
                sq += xq;
            }
        }
        if (lane == 31) {
            s_tot[warp][0] = sf;
            s_tot[warp][1] = sq;
        }
        kf = sf - kf;  // exclusive, within the warp
        kq = sq - kq;
    }
    __syncthreads();
    if (warp < 2) {
        s_off[0][t] = kf + (warp ? s_tot[0][0] : 0);
        s_off[1][t] = kq + (warp ? s_tot[0][1] : 0);
    }
    long long sum[3] = {0, 0, 0};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        sum[0] += s_red[0][w];
        sum[1] += s_red[1][w];
        sum[2] += s_red[2][w];
    }
    __syncthreads();

    const int64_t s0 = 4LL * F + 4 + (int64_t)kHdr * nb * F;
    const int64_t base_f = s0 + sum[0] + sum[1];           // this chunk's first unsplit list
    const int64_t base_q = s0 + sum[0] + acc[2 * f] + sum[2];  // its first split block's lists
    const FramePtrs p = tab[f];
    constexpr int kPerWarp = kChunk / kWarps;
    for (int j = 0; j < kPerWarp; ++j) {
        const int i = warp * kPerWarp + j, b = c0 + i;
        if (b >= c1) break;
        if (!hdr[b]) {
            code_unit<WF, true>(p.qf + (int64_t)b * nn, s_scan, nn, out, base_f + s_off[0][i], limit, flag);
        } else {
            int64_t pos = base_q + s_off[1][i];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                pos += code_unit<WQ, true>(p.qq + ((int64_t)b * 4 + q) * ss, s_scanq, ss, out, pos, limit, flag);
        }
    }
}

template <int WF, int WQ>
int launch(const FramePtrs* tab, int F, int nb, int n, const int32_t* scan_full, const int32_t* scan_quad,
           int16_t* out, int64_t limit, cudaStream_t stream) {
    const int64_t warps = (int64_t)F * nb;
    rle_count_kernel<WF, WQ><<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        tab, F, nb, n, scan_full, scan_quad, out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    rle_write_kernel<WF, WQ><<<dim3((nb + kChunk - 1) / kChunk, F), kThreads, 0, stream>>>(
        tab, F, nb, n, scan_full, scan_quad, out, limit);
    return (int)cudaGetLastError();
}

}  // namespace

// tab: (F, 6) int64 device table, a row per frame: the split, mv, sub_mv,
// qf and qq pointers and the MV components (1 or 3); nb blocks of n x n a
// frame; scan_full / scan_quad: the diagonal scan's flat indices of n and
// n / 2 (int32); out: the int16 buffer of `limit` elements (the layout
// above; limit >= S0).  Zeroes the per-frame totals and the error bits,
// then launches the count and the write.  Returns a CUDA error code
// (cudaErrorInvalidValue for n outside {4, 8, 16} or F > 65535).
extern "C" int so_rle_pack(const void* tab, int F, int nb, int n, const void* scan_full, const void* scan_quad,
                           void* out, long long limit, void* stream) {
    if ((n != 4 && n != 8 && n != 16) || F > 65535) return (int)cudaErrorInvalidValue;
    if (F <= 0 || nb <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(out, 0, (4LL * F + 4) * sizeof(int16_t), st);
    if (e != cudaSuccess) return (int)e;
    const FramePtrs* t = (const FramePtrs*)tab;
    const int32_t *sf = (const int32_t*)scan_full, *sq = (const int32_t*)scan_quad;
    int16_t* o = (int16_t*)out;
    switch (n) {
        case 16: return launch<8, 2>(t, F, nb, n, sf, sq, o, limit, st);
        case 8: return launch<2, 1>(t, F, nb, n, sf, sq, o, limit, st);
        default: return launch<1, 1>(t, F, nb, n, sf, sq, o, limit, st);
    }
}
