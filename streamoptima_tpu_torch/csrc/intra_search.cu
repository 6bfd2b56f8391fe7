// Mode-0 intra search and residuals of one frame for Hopper (sm_90a): one
// launch an intra frame (a mesh tile's rows, or the frame).
//
// Replaces: no TPU kernel.  The JAX engine's intra_search_mode0 followed by
// intra_residuals_mode0 (streamoptima_tpu/core/intra.py:46-241) is fused by
// XLA into the jitted intra step.  The port's plain version is core/intra.py
// intra_search_mode0 then intra_residuals_mode0: per-shift segment sums,
// about 700 eager ops a frame at sr = 8 and 4200 at sr = 16 with VBS.
//
// The function.  The search frame is the original under a causal mask: the
// block at pixel column x (a quad: its parent block's x) at shift dx reads
// pixel (i, j) from the frame's column x + j + dx where j + dx < 0 (left of
// the frontier), as 128 where that column is left of the frame, and 128
// everywhere else.  So every shift dx >= 0 reads 128 alone, and one per-pixel
// rule serves the block and its quads.  SAD(dx) sums |cur - read| over the
// block or quad.  A shift is valid where x_u + dx >= 0 and x_u + dx + n_u
// <= canvas_w (x_u, n_u the block's or quad's column and size).  The winner
// is the minimum of (SAD, (|dx| << 8) | (sr - dx)) with invalid shifts at
// SAD = INT32_MAX: the least SAD, then the least |dx|, then the positive dx.
// Block column 0 takes mv = -1 and its SAD against 128; its quads search as
// the others.  The residuals are cur - read at the chosen MVs, reading 128
// for an MV outside [-sr, 0].
//
// transpose (intra mode 1: mode 0 on the transposed frame): the kernel reads
// the frame transposed, numbers the blocks in the transposed frame's raster
// order, and writes each residual block (and each quad, Z order of the
// transposed block) transposed, as the frame holds it: the layout the
// engine's transform and intra_recon take.  Thread work items then walk
// the pixels column-major, so neighbouring threads still touch neighbouring
// bytes of the frame and words of the residuals.
//
// What bounds it on this card.  Bytes: the frame read once and, at 720p
// with VBS, two int32 residual planes written (7.4 MB, 2.2 us at 3.35
// TB/s).  Operations: (sr + 1) abs-diffs a pixel (the shifts dx >= 0 share
// one), 15.7 M at sr = 16, 0.9 us at 132 SMs x 64 lanes x 1980 MHz.  A
// first, simple design: one CTA per block.  The block and the sr columns
// left of it are staged in shared memory; per (shift, row) the two
// half-row SADs, then per (shift, block or quad) the sums, then one thread
// per block or quad takes the minimum over the 2 sr + 1 shifts, and the
// CTA writes the residuals.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBs = 32;
constexpr int kMaxSr = 127;  // sr - dx must fit the tie-break's 8 bits
constexpr int kUnits = 5;    // the block and its four quads (Z order)

__global__ void __launch_bounds__(kThreads)
intra_search_kernel(const uint8_t* __restrict__ frame, int fw, int transpose, int nbc, int bs, int sr, int canvas_w,
                    int vbs, int32_t* __restrict__ mv, int32_t* __restrict__ sad, int32_t* __restrict__ sub_mv,
                    int32_t* __restrict__ sub_sad, int32_t* __restrict__ res_full, int32_t* __restrict__ res_quads) {
    extern __shared__ int32_t smem[];
    const int nd = sr + 1;                       // shifts dx = -sr .. 0; the rest read as dx = 0
    int32_t* s_part = smem;                      // [nd][bs][2] half-row SADs
    int32_t* s_sad = s_part + nd * bs * 2;       // [nd][kUnits]
    int32_t* s_mv = s_sad + nd * kUnits;         // [kUnits] the winners
    uint8_t* s_cur = (uint8_t*)(s_mv + kUnits);  // [bs][bs]
    uint8_t* s_ctx = s_cur + bs * bs;            // [bs][sr] the columns x - sr .. x - 1

    const int64_t b = blockIdx.x;
    const int t = threadIdx.x;
    const int s = bs >> 1;
    const int64_t y0 = (b / nbc) * bs;
    const int x0 = (int)(b % nbc) * bs;
    // pixel (yy, xx) of the searched frame, as the original frame holds it
    auto px = [&](int64_t yy, int64_t xx) { return transpose ? frame[xx * fw + yy] : frame[yy * fw + xx]; };

    for (int k = t; k < bs * bs; k += kThreads) {
        const int i = transpose ? k % bs : k / bs, j = transpose ? k / bs : k % bs;
        s_cur[i * bs + j] = px(y0 + i, x0 + j);
    }
    for (int k = t; k < bs * sr; k += kThreads) {
        const int i = transpose ? k % bs : k / sr, m = transpose ? k / bs : k % sr;
        const int col = x0 - sr + m;
        s_ctx[i * sr + m] = col >= 0 ? px(y0 + i, col) : (uint8_t)128;
    }
    __syncthreads();

    // (shift, row) items: the row's SAD over its left and right halves
    for (int k = t; k < nd * bs; k += kThreads) {
        const int d = k / bs, i = k % bs, dx = d - sr;
        int half[2] = {0, 0};
        for (int j = 0; j < bs; ++j) {
            const int ref = j + dx < 0 ? s_ctx[i * sr + sr + j + dx] : 128;
            half[j >= s] += abs((int)s_cur[i * bs + j] - ref);
        }
        s_part[(d * bs + i) * 2] = half[0];
        s_part[(d * bs + i) * 2 + 1] = half[1];
    }
    __syncthreads();

    // (shift, unit) items: unit 0 the block, 1 + q the quad q = 2 dr + dc
    const int units = vbs ? kUnits : 1;
    for (int k = t; k < nd * units; k += kThreads) {
        const int d = k / units, unit = k % units;
        int acc = 0;
        if (unit == 0) {
            for (int i = 0; i < bs; ++i) acc += s_part[(d * bs + i) * 2] + s_part[(d * bs + i) * 2 + 1];
        } else {
            const int dr = (unit - 1) >> 1, dc = (unit - 1) & 1;
            for (int i = dr * s; i < dr * s + s; ++i) acc += s_part[(d * bs + i) * 2 + dc];
        }
        s_sad[d * kUnits + unit] = acc;
    }
    __syncthreads();

    if (t < units) {
        const int n = t == 0 ? bs : s;
        const int xu = x0 + (t == 0 ? 0 : ((t - 1) & 1) * s);
        unsigned long long best = ~0ull;
        for (int dx = -sr; dx <= sr; ++dx) {
            const int d = dx < 0 ? dx + sr : sr;
            const bool valid = xu + dx >= 0 && xu + dx + n <= canvas_w;
            const unsigned sd = valid ? (unsigned)s_sad[d * kUnits + t] : 0x7fffffffu;
            const unsigned sec = ((unsigned)abs(dx) << 8) | (unsigned)(sr - dx);
            const unsigned long long key = ((unsigned long long)sd << 32) | sec;
            best = key < best ? key : best;
        }
        int m = sr - (int)(best & 0xff);
        int sv = (int)(best >> 32);
        if (t == 0 && x0 == 0) {  // border column: mv = -1 against 128 (the dx = 0 read)
            m = -1;
            sv = s_sad[sr * kUnits];
        }
        s_mv[t] = m;
        if (t == 0) {
            mv[b] = m;
            sad[b] = sv;
        } else {
            sub_mv[b * 4 + t - 1] = m;
            sub_sad[b * 4 + t - 1] = sv;
        }
    }
    __syncthreads();

    const int64_t bb = (int64_t)bs * bs;
    for (int k = t; k < bs * bs; k += kThreads) {
        const int i = transpose ? k % bs : k / bs, j = transpose ? k / bs : k % bs;
        const int cv = s_cur[i * bs + j];
        int m = s_mv[0];
        int ref = (m >= -sr && m <= 0 && j + m < 0) ? s_ctx[i * sr + sr + j + m] : 128;
        res_full[b * bb + k] = cv - ref;  // k is (j, i) of the block under transpose: the frame's layout
        if (vbs) {
            const int q = 2 * (i >= s) + (j >= s);
            m = s_mv[1 + q];
            ref = (m >= -sr && m <= 0 && j + m < 0) ? s_ctx[i * sr + sr + j + m] : 128;
            const int li = i % s, lj = j % s;
            res_quads[b * bb + q * s * s + (transpose ? lj * s + li : li * s + lj)] = cv - ref;
        }
    }
}

}  // namespace

// The dynamic shared memory a CTA takes for (bs, sr), in bytes.
static size_t intra_search_smem(int bs, int sr) {
    return sizeof(int32_t) * ((size_t)(sr + 1) * bs * 2 + (size_t)(sr + 1) * kUnits + kUnits) + (size_t)bs * bs +
           (size_t)bs * sr;
}

// frame: the (h, w) uint8 frame; transpose: search its transpose (intra
// mode 1).  The searched frame ((w, h) under transpose) has nbr x nbc blocks
// of bs; canvas_w bounds the shifts.  Outputs: mv, sad (nbr * nbc,) int32;
// with vbs sub_mv, sub_sad (nbr * nbc, 4) int32; res_full (nb, bs, bs) and
// with vbs res_quads (nb, 4, bs/2, bs/2) int32, transposed per block (and
// quad) under transpose.  Returns a CUDA error code (cudaErrorInvalidValue
// for bs outside [1, 32], an odd bs with vbs, or sr outside [0, 127]).
extern "C" int so_intra_search(const void* frame, int h, int w, int transpose, int bs, int sr, int canvas_w, int vbs,
                               void* mv, void* sad, void* sub_mv, void* sub_sad, void* res_full, void* res_quads,
                               void* stream) {
    if (bs < 1 || bs > kMaxBs || (vbs && bs % 2) || sr < 0 || sr > kMaxSr) return (int)cudaErrorInvalidValue;
    const int hh = transpose ? w : h, ww = transpose ? h : w;
    const int nbr = hh / bs, nbc = ww / bs;
    if (nbr <= 0 || nbc <= 0) return 0;
    intra_search_kernel<<<nbr * nbc, kThreads, intra_search_smem(bs, sr), (cudaStream_t)stream>>>(
        (const uint8_t*)frame, w, transpose != 0, nbc, bs, sr, canvas_w, vbs != 0, (int32_t*)mv, (int32_t*)sad,
        (int32_t*)sub_mv, (int32_t*)sub_sad, (int32_t*)res_full, (int32_t*)res_quads);
    return (int)cudaGetLastError();
}
