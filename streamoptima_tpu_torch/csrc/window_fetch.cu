// Window fetch for Hopper (sm_90a): the fast-ME region gather.
//
// Replaces: streamoptima_tpu/core/me_pallas.py, window_fetch with its
// window_prep.  out[b][p][i][j] = planes[p][by0[b] + i][bx0[b] + j], zero
// outside the plane, for any int32 origin (the fast-ME MVP chain drifts one
// step per block across the whole frame, so origins are not bounded by the
// search range; a window partly outside the plane is partly zero), any
// extents rows x cols and any plane count P.  The confirm pass reads every
// block's (n+2)^2 candidate region of each plane through it, at the origins
// core/fastme.region_base gives.
//
// The TPU kernel's padded int16 copy of the planes (window_prep), its
// 8-row / 128-lane aligned (32, 256) DMA per block, the two barrel shifts
// that undo the alignment and its ring of DMA slots were TPU devices and are
// not carried over: the kernel reads the unpadded uint8 planes in place.
// Output is uint8 (every plane value is a pixel or a ceil-average of pixels).
//
// What bounds it on this card: bytes.  Each output byte is written once and
// read once from a plane (neighbouring windows overlap, so the distinct plane
// bytes are fewer than the output's): at 720p the FME confirm pass writes
// 3600 * 4 * 18 * 18 = 4.7 MB, some 2.5 us at HBM rates, the whole-pel one a
// quarter of that.  What holds it back at these sizes is the launch and the
// grid's ramp (a bare write of the same output bytes already costs most of
// the kernel's time; chip_smoke.py times one beside it), then the latency of
// each CTA's chain of dependent steps, then the L1's rate for scattered
// 8-byte copies.  The first port's thread per output byte spent two
// divisions, 64-bit address arithmetic and a four-way bounds test on each
// byte, under a CTA per window whose last trip left most threads idle.
//
// Design: the work per 8 bytes and per row, not per byte.  The output is
// nb * P * rows rows of cols bytes; a CTA of 256 threads takes a run of up to
// 256 of them (fewer, down to 32, where that spreads the grid over every SM
// twice), across window boundaries.  Rows: a thread per row works out once
// where the row's window bytes start in the planes and which of its columns
// lie inside the plane, with the window's origin clamped to [-rows, H] x
// [-cols, W] as int32 (past either bound the window misses the plane, so the
// clamp is exact).  Copy: each row, and the run's next one, lands in the
// CTA's box in shared memory, a box row per row, from the 8-byte word holding
// its first window byte on: a group of (8 << lw) / 8 lanes copies a row's
// words, so one warp-wide copy serves eight plane rows at cols = 18.  The
// copies are cp.async, all issued before any is waited for.  A word with
// window bytes outside the plane (an edge window's) is copied whole and then
// masked to the plane's bytes; rows outside the plane and words with no
// plane byte are zeros, and only a word across the tensor's ends is read
// byte by byte.  Rows need not be word-aligned (any W, any base): words are
// aligned on the absolute address, and each row's record says where its
// window bytes start.  Write: each thread assembles 8-byte output words,
// aligned on the output's addresses, from at most two box rows (cols >= 8)
// with a funnel shift each, two words at a time, and stores them whole; only
// the run's first and last words, shared with the neighbouring CTAs, are
// written byte by byte.  Box rows are padded by a word so that the reads of
// neighbouring rows fall on different banks.
//
// Measured on the card and not kept: a warp per window (a window's copies
// and words in one warp, eight windows to a CTA) left each warp a long chain
// of dependent steps and was no faster; staging the CTA's output span to
// write it with 16-byte stores cost more in merging the staged rows' shared
// words (shared-memory ORs or shuffles) than the stores saved; the TMA (a 3D
// box per window, zero-filled by the hardware) takes boxes at 16-byte aligned
// columns only, so 18 columns need 48-byte wide boxes, and it was slower than
// these copies at every confirm shape.  Other shapes (cols < 8, or cols > 249,
// whose output words span more rows or whose box rows exceed 32 words) take a
// thread per output byte.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kCtas = 8;          // CTAs an SM holds (32 registers a thread)
constexpr int kRows = 256;        // output rows a CTA at most
constexpr int kSmem = 48 * 1024;  // a CTA's shared memory, in bytes
constexpr int kSlack = 16;        // bytes past the box's rows that its reads may touch

// n / d for 0 <= n < 2^31, d >= 1 and a quotient below 2^21: the float
// estimate is off by at most one, and one step corrects it
__device__ __forceinline__ int small_div(int n, int d, float inv) {
    int q = __float2int_rz(__int2float_rn(n) * inv);
    const int r = n - q * d;
    return q + (r >= d) - (r < 0);
}

// an asynchronous copy of the 8-byte word at q into shared memory
__device__ __forceinline__ void copy8(void* dst, uintptr_t q) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(q)
                 : "memory");
}

// the 8 bytes from byte x of a box row on (the row 4-aligned; x any)
__device__ __forceinline__ uint64_t bytes8(const uint8_t* row, int x) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (x & ~3));
    const unsigned sh = 8 * (x & 3);
    return (uint64_t)__funnelshift_r(w[1], w[2], sh) << 32 | __funnelshift_r(w[0], w[1], sh);
}

struct Shape {
    const uint8_t* planes;
    uintptr_t end;  // one past the planes tensor's last byte
    int P, H, W, rows, cols;
    int lw;        // a row's window bytes lie in its first 1 << lw words (8 << lw >= cols + 7 bytes)
    int crows;     // output rows a CTA writes; its box holds one more
    long long nr;  // output rows in all: nb * P * rows
};

// a box row's source: the plane address of its first window byte (that
// byte's word lands at the box row's start, the byte itself at rs & 7), and
// the window's columns [cmin, cmax) inside the plane (cmin = cmax: none)
struct Row {
    uintptr_t rs;
    int cmin, cmax;
};

// The output is nr rows of cols bytes (window b's plane p's row i is output row (b * P + p) * rows + i); CTA
// c writes rows [R0, R1) = [c * crows, (c + 1) * crows) of it.  Its threads work out each row's source once,
// then copy the rows, and row R1's, to the box, (8 << lw) + 8 bytes a row; then write the output words
// (8 bytes, aligned on the output's addresses) that start in their rows, each from at most two box rows
// (cols >= 8).  The CTA's first and last words are shared with its neighbours and are written byte by byte
__global__ void __launch_bounds__(kThreads, kCtas)
    window_fetch_kernel(Shape s, const int32_t* __restrict__ by0, const int32_t* __restrict__ bx0,
                        uint8_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int tid = threadIdx.x, pitch = (8 << s.lw) + 8, nrw = s.P * s.rows;  // nrw: output rows of a window
    const long long R0 = (long long)blockIdx.x * s.crows;
    const int nrows = (int)min((long long)s.crows, s.nr - R0), nload = (int)min(s.nr - R0, (long long)nrows + 1);
    uint8_t* const box = smem;
    Row* const src = reinterpret_cast<Row*>(smem + (s.crows + 1) * pitch + kSlack);
    const long long w0 = R0 < INT_MAX ? (long long)((unsigned)R0 / (unsigned)nrw) : R0 / nrw;  // the CTA's first window
    const int rr0 = (int)(R0 - w0 * nrw);
    const float inv_nrw = __frcp_rn((float)nrw), inv_rows = __frcp_rn((float)s.rows);
    for (int br = tid; br < nload; br += kThreads) {  // box row br: window w0 + w's plane p's row i
        const int rr = rr0 + br, w = small_div(rr, nrw, inv_nrw), r = rr - w * nrw;
        const int p = small_div(r, s.rows, inv_rows), i = r - p * s.rows;
        const int y0 = min(max(by0[w0 + w], -s.rows), s.H), x0 = min(max(bx0[w0 + w], -s.cols), s.W);  // clamped
        const int y = y0 + i;
        const bool row_in = (unsigned)y < (unsigned)s.H;
        src[br] = Row{(uintptr_t)s.planes + (uintptr_t)(((long long)p * s.H + y) * s.W + x0),
                      row_in ? max(-x0, 0) : 0, row_in ? min(s.cols, s.W - x0) : 0};
    }
    __syncthreads();

    // copy: box row br's word k, by lane k of a group of 1 << lw lanes
    const int g = tid >> s.lw, k = tid & ((1 << s.lw) - 1), rps = kThreads >> s.lw;
    const uintptr_t base = (uintptr_t)s.planes;
    bool masked = false;  // a word of this thread's holds window bytes outside the plane
    for (int br = g; br < nload; br += rps) {
        const Row row = src[br];
        const int rel = 8 * k - (int)(row.rs & 7);  // the word's first byte, counted from the row's first window byte
        const int na = max(-rel, 0), nz = min(s.cols - rel, 8);
        const int va = max(row.cmin - rel, 0), vz = min(row.cmax - rel, 8);
        const uintptr_t q = row.rs + rel;
        uint64_t* const dst = reinterpret_cast<uint64_t*>(box + br * pitch + 8 * k);
        if (na >= nz) continue;  // the word holds window bytes [na, nz), plane bytes [va, vz)
        if (va >= vz) {
            *dst = 0;
        } else if (q >= base && q + 8 <= s.end) {  // the whole word (bytes off the plane are masked below)
            copy8(dst, q);
            masked |= va != na || vz != nz;
        } else {  // across the tensor's ends: its plane bytes one by one
            uint64_t v = 0;
#pragma unroll
            for (int t = 0; t < 8; ++t)
                if (t >= va && t < vz) v |= (uint64_t)__ldg(reinterpret_cast<const uint8_t*>(q + t)) << (8 * t);
            *dst = v;
        }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    if (masked) {  // an edge window's words: only the plane's bytes
        for (int br = g; br < nload; br += rps) {
            const Row row = src[br];
            const int rel = 8 * k - (int)(row.rs & 7);
            const int na = max(-rel, 0), nz = min(s.cols - rel, 8);
            const int va = max(row.cmin - rel, 0), vz = min(row.cmax - rel, 8);
            const uintptr_t q = row.rs + rel;
            if (na < nz && va < vz && q >= base && q + 8 <= s.end && (va != na || vz != nz))
                *reinterpret_cast<uint64_t*>(box + br * pitch + 8 * k) &= (~0ull >> (64 - 8 * (vz - va))) << (8 * va);
        }
    }
    __syncthreads();

    uint8_t* const ob = out + R0 * s.cols;  // the CTA's output bytes [0, span), from word `first` on
    const int span = nrows * s.cols, lead = (int)((uintptr_t)ob & 7), nwords = (lead + span + 7) >> 3;
    uint8_t* const first = ob - lead;
    const float inv_cols = __frcp_rn((float)s.cols);
    // byte s0 of the CTA's output and on: its row's remaining n1 bytes, then the next row's
    const auto word = [&](int s0) {
        const int br = small_div(s0, s.cols, inv_cols), c = s0 - br * s.cols, n1 = s.cols - c;
        uint64_t v = bytes8(box + br * pitch, (int)(src[br].rs & 7) + c);
        if (n1 < 8 && br + 1 < nload)
            v = (v & (~0ull >> (64 - 8 * n1))) | bytes8(box + (br + 1) * pitch, (int)(src[br + 1].rs & 7)) << (8 * n1);
        return v;
    };
    const auto put = [&](int wi, uint64_t v) {
        const int o = 8 * wi - lead, a = max(-o, 0), e = min(span - o, 8);  // the word's bytes [a, e) are the CTA's
        uint8_t* const dst = first + 8 * wi;
        if (a == 0 && e == 8) {
            *reinterpret_cast<uint64_t*>(dst) = v;
        } else {
            v <<= 8 * a;
            for (int t = a; t < e; ++t) dst[t] = (uint8_t)(v >> (8 * t));
        }
    };
    int wi = tid;
    for (; wi + kThreads < nwords; wi += 2 * kThreads) {  // two words at a time, their shared loads overlapping
        const uint64_t v0 = word(max(8 * wi - lead, 0)), v1 = word(8 * (wi + kThreads) - lead);
        put(wi, v0);
        put(wi + kThreads, v1);
    }
    if (wi < nwords) put(wi, word(max(8 * wi - lead, 0)));
}

// any other shape: a CTA per window, a thread per output byte
__global__ void window_fetch_bytes_kernel(const uint8_t* __restrict__ planes, const int32_t* __restrict__ by0,
                                          const int32_t* __restrict__ bx0, int P, int H, int W, int rows, int cols,
                                          uint8_t* __restrict__ out) {
    const int b = blockIdx.x;
    const int y0 = min(max(by0[b], -rows), H), x0 = min(max(bx0[b], -cols), W);
    const int per_plane = rows * cols, total = P * per_plane;
    uint8_t* dst = out + (size_t)b * total;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int p = e / per_plane, rem = e - p * per_plane, i = rem / cols;
        const int y = y0 + i, x = x0 + rem - i * cols;
        dst[e] = (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W ? planes[((size_t)p * H + y) * W + x] : 0;
    }
}

}  // namespace

extern "C" int so_window_fetch(const void* planes, const void* by0, const void* bx0, int nb, int P, int H, int W,
                               int rows, int cols, void* out, void* stream) {
    if (nb == 0 || P == 0) return 0;
    if (cols < 8 || cols > 249) {
        window_fetch_bytes_kernel<<<nb, 256, 0, (cudaStream_t)stream>>>((const uint8_t*)planes, (const int32_t*)by0,
                                                                        (const int32_t*)bx0, P, H, W, rows, cols,
                                                                        (uint8_t*)out);
        return (int)cudaGetLastError();
    }
    Shape s;
    s.planes = (const uint8_t*)planes;
    s.end = (uintptr_t)planes + (size_t)P * H * W;
    s.P = P, s.H = H, s.W = W, s.rows = rows, s.cols = cols;
    for (s.lw = 0; (8 << s.lw) < cols + 7; ++s.lw) {
    }
    s.nr = (long long)nb * P * rows;
    // rows a CTA: at most kRows and what the box, its slack and the rows' sources leave of kSmem, and few
    // enough that the grid spans every SM twice (down to 32 rows)
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int pitch = (8 << s.lw) + 8;
    const long long even = (s.nr + 2LL * sms - 1) / (2LL * sms);
    s.crows = (int)std::min<long long>({kRows, (kSmem - kSlack) / (pitch + (long long)sizeof(Row)) - 1,
                                        std::max(32LL, even)});
    const int smem = (s.crows + 1) * (pitch + (int)sizeof(Row)) + kSlack;
    window_fetch_kernel<<<(unsigned)((s.nr + s.crows - 1) / s.crows), kThreads, smem, (cudaStream_t)stream>>>(
        s, (const int32_t*)by0, (const int32_t*)bx0, (uint8_t*)out);
    return (int)cudaGetLastError();
}
