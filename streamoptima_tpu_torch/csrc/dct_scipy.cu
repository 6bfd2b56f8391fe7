// The compat engine's scipy-exact 2D DCT-II and its inverse for Hopper (sm_90a).
//
// Replaces: no TPU kernel.  The JAX package's compat engine calls
// scipy.fftpack.dct / idct(norm="ortho") on the host, along axis -2 and then
// axis -1, and rounds half to even (streamoptima_tpu/core/transform.py,
// dct2_scipy / idct2_scipy).  A float64 matmul does not reproduce that: where
// a coefficient's exact value is a half-integer, scipy's rounding direction
// depends on pocketfft's order of operations.  So this kernel replays
// pocketfft's float64 arithmetic operation for operation, as the plain
// version does (core/transform.py: dct2_scipy_f64 / idct2_scipy_f64, whose
// names it follows): T_dcst23 (the DCT-II / DCT-III as a pre- and
// post-twiddled length-n real FFT) over rfftp's radix-4 and radix-2 passes.
//
// Exactness: every add, subtract and multiply is __dadd_rn / __dsub_rn /
// __dmul_rn, so nvcc cannot contract a product and a sum into an FMA (the
// build does not pass -fmad=false).  Negation and the int64 <-> float64
// conversions of integers below 2^53 are exact; rint rounds half to even.
// The twiddles are pocketfft's float64 values (sincos_2pibyn's products of
// two table entries, not correctly rounded cosines), written as hex
// literals; tests/test_torch_compat.py holds them to scipy_plan(n).
//
// Design: one thread per line of a pass, its n samples in registers (every
// loop is unrolled with compile-time indices).  A CTA takes 128 / n blocks;
// thread (t, b) transforms column t of block b, stores it to shared memory,
// then row t, and the result leaves through shared memory again so that
// both the loads and the stores are coalesced.  Rows are padded by one
// double against bank conflicts.  The work per block is a few hundred
// float64 operations a line, so a launch at CIF (396 blocks of 16 x 16 or
// 1584 of 8 x 8) is bound by its launch, not by bytes or FP64 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

constexpr double kSqrt2 = 0x1.6a09e667f3bcdp+0;  // pocketfft's sqrt2 and hsqt2, correctly rounded
constexpr double kHsqt2 = 0x1.6a09e667f3bcdp-1;

// pocketfft's plan for length N (core/transform.py scipy_plan): the rfft's
// factors (a radix 2 first, then radix 4s), the first pass's twiddles (the
// last pass has ido = 1 and needs none), the DCT twiddles (the real parts of
// the 4N-th roots 1..N) and the ortho scale 1 / sqrt(2N).
template <int N> struct Plan;

template <> struct Plan<8> {
    static constexpr int kFirst = 2;  // factors (2, 4)
    static constexpr double kFct = 0x1.0000000000000p-2;
    __device__ static double tw(int i) {  // the pair (re, im), and one unread entry as in rfftp's table
        constexpr double v[3] = {0x1.6a09e667f3bccp-1, 0x1.6a09e667f3bcdp-1, 0x0.0p+0};
        return v[i];
    }
    __device__ static double dct(int i) {
        constexpr double v[8] = {0x1.f6297cff75cb0p-1, 0x1.d906bcf328d46p-1, 0x1.a9b66290ea1a3p-1,
                                 0x1.6a09e667f3bccp-1, 0x1.1c73b39ae68c8p-1, 0x1.87de2a6aea963p-2,
                                 0x1.8f8b83c69a60ap-3, -0x0.0p+0};
        return v[i];
    }
};

template <> struct Plan<16> {
    static constexpr int kFirst = 4;  // factors (4, 4)
    static constexpr double kFct = 0x1.6a09e667f3bcdp-3;
    __device__ static double tw(int i) {  // per j = 1..3 the pair (re, im) at [3 (j - 1)], [3 (j - 1) + 1]
        constexpr double v[9] = {0x1.d906bcf328d46p-1, 0x1.87de2a6aea963p-2, 0x0.0p+0,
                                 0x1.6a09e667f3bccp-1, 0x1.6a09e667f3bcdp-1, 0x0.0p+0,
                                 0x1.87de2a6aea963p-2, 0x1.d906bcf328d46p-1, 0x0.0p+0};
        return v[i];
    }
    __device__ static double dct(int i) {
        constexpr double v[16] = {0x1.fd88da3d12526p-1, 0x1.f6297cff75cb0p-1, 0x1.e9f4156c62ddap-1,
                                  0x1.d906bcf328d46p-1, 0x1.c38b2f180bdb1p-1, 0x1.a9b66290ea1a3p-1,
                                  0x1.8bc806b151741p-1, 0x1.6a09e667f3bccp-1, 0x1.44cf325091dd6p-1,
                                  0x1.1c73b39ae68c8p-1, 0x1.e2b5d3806f639p-2, 0x1.87de2a6aea961p-2,
                                  0x1.294062ed59f04p-2, 0x1.8f8b83c69a60ap-3, 0x1.917a6bc29b424p-4,
                                  -0x0.0p+0};
        return v[i];
    }
};

// rfftp's passes on cc -> ch.  WA(x, i) = wa[i + x (ido - 1)]: the first
// pass's twiddles, Plan<N>::tw; the ido = 1 passes read none.
template <int N, int IDO, int L1>
__device__ __forceinline__ void radf2(const double* cc, double* ch) {
#define CC(a, b, c) cc[(a) + IDO * ((b) + L1 * (c))]
#define CH(a, b, c) ch[(a) + IDO * ((b) + 2 * (c))]
#pragma unroll
    for (int k = 0; k < L1; ++k) {
        CH(0, 0, k) = add(CC(0, k, 0), CC(0, k, 1));
        CH(IDO - 1, 1, k) = sub(CC(0, k, 0), CC(0, k, 1));
    }
    if (IDO % 2 == 0) {
#pragma unroll
        for (int k = 0; k < L1; ++k) {
            CH(0, 1, k) = -CC(IDO - 1, k, 1);
            CH(IDO - 1, 0, k) = CC(IDO - 1, k, 0);
        }
    }
#pragma unroll
    for (int k = 0; k < L1; ++k) {
#pragma unroll
        for (int i = 2; i < IDO; i += 2) {
            const int ic = IDO - i;
            const double wr = Plan<N>::tw(i - 2), wi = Plan<N>::tw(i - 1);
            const double tr2 = add(mul(wr, CC(i - 1, k, 1)), mul(wi, CC(i, k, 1)));
            const double ti2 = sub(mul(wr, CC(i, k, 1)), mul(wi, CC(i - 1, k, 1)));
            CH(i - 1, 0, k) = add(CC(i - 1, k, 0), tr2);
            CH(ic - 1, 1, k) = sub(CC(i - 1, k, 0), tr2);
            CH(i, 0, k) = add(ti2, CC(i, k, 0));
            CH(ic, 1, k) = sub(ti2, CC(i, k, 0));
        }
    }
#undef CC
#undef CH
}

template <int N, int IDO, int L1>
__device__ __forceinline__ void radf4(const double* cc, double* ch) {
#define CC(a, b, c) cc[(a) + IDO * ((b) + L1 * (c))]
#define CH(a, b, c) ch[(a) + IDO * ((b) + 4 * (c))]
#pragma unroll
    for (int k = 0; k < L1; ++k) {
        const double tr1 = add(CC(0, k, 3), CC(0, k, 1));
        CH(0, 2, k) = sub(CC(0, k, 3), CC(0, k, 1));
        const double tr2 = add(CC(0, k, 0), CC(0, k, 2));
        CH(IDO - 1, 1, k) = sub(CC(0, k, 0), CC(0, k, 2));
        CH(0, 0, k) = add(tr2, tr1);
        CH(IDO - 1, 3, k) = sub(tr2, tr1);
    }
    if (IDO % 2 == 0) {
#pragma unroll
        for (int k = 0; k < L1; ++k) {
            const double ti1 = mul(-kHsqt2, add(CC(IDO - 1, k, 1), CC(IDO - 1, k, 3)));
            const double tr1 = mul(kHsqt2, sub(CC(IDO - 1, k, 1), CC(IDO - 1, k, 3)));
            CH(IDO - 1, 0, k) = add(CC(IDO - 1, k, 0), tr1);
            CH(IDO - 1, 2, k) = sub(CC(IDO - 1, k, 0), tr1);
            CH(0, 3, k) = add(ti1, CC(IDO - 1, k, 2));
            CH(0, 1, k) = sub(ti1, CC(IDO - 1, k, 2));
        }
    }
#pragma unroll
    for (int k = 0; k < L1; ++k) {
#pragma unroll
        for (int i = 2; i < IDO; i += 2) {
            const int ic = IDO - i;
            double cr[3], ci[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {  // MULPM: conj(w) * (re + i im)
                const double wr = Plan<N>::tw(i - 2 + j * (IDO - 1)), wi = Plan<N>::tw(i - 1 + j * (IDO - 1));
                const double re = CC(i - 1, k, j + 1), im = CC(i, k, j + 1);
                cr[j] = add(mul(wr, re), mul(wi, im));
                ci[j] = sub(mul(wr, im), mul(wi, re));
            }
            const double tr1 = add(cr[2], cr[0]), tr4 = sub(cr[2], cr[0]);
            const double ti1 = add(ci[0], ci[2]), ti4 = sub(ci[0], ci[2]);
            const double tr2 = add(CC(i - 1, k, 0), cr[1]), tr3 = sub(CC(i - 1, k, 0), cr[1]);
            const double ti2 = add(CC(i, k, 0), ci[1]), ti3 = sub(CC(i, k, 0), ci[1]);
            CH(i - 1, 0, k) = add(tr2, tr1);
            CH(ic - 1, 3, k) = sub(tr2, tr1);
            CH(i, 0, k) = add(ti1, ti2);
            CH(ic, 3, k) = sub(ti1, ti2);
            CH(i - 1, 2, k) = add(tr3, ti4);
            CH(ic - 1, 1, k) = sub(tr3, ti4);
            CH(i, 2, k) = add(tr4, ti3);
            CH(ic, 1, k) = sub(tr4, ti3);
        }
    }
#undef CC
#undef CH
}

template <int N, int IDO, int L1>
__device__ __forceinline__ void radb2(const double* cc, double* ch) {
#define CC(a, b, c) cc[(a) + IDO * ((b) + 2 * (c))]
#define CH(a, b, c) ch[(a) + IDO * ((b) + L1 * (c))]
#pragma unroll
    for (int k = 0; k < L1; ++k) {
        CH(0, k, 0) = add(CC(0, 0, k), CC(IDO - 1, 1, k));
        CH(0, k, 1) = sub(CC(0, 0, k), CC(IDO - 1, 1, k));
    }
    if (IDO % 2 == 0) {
#pragma unroll
        for (int k = 0; k < L1; ++k) {
            CH(IDO - 1, k, 0) = mul(2.0, CC(IDO - 1, 0, k));
            CH(IDO - 1, k, 1) = mul(-2.0, CC(0, 1, k));
        }
    }
#pragma unroll
    for (int k = 0; k < L1; ++k) {
#pragma unroll
        for (int i = 2; i < IDO; i += 2) {
            const int ic = IDO - i;
            CH(i - 1, k, 0) = add(CC(i - 1, 0, k), CC(ic - 1, 1, k));
            const double tr2 = sub(CC(i - 1, 0, k), CC(ic - 1, 1, k));
            const double ti2 = add(CC(i, 0, k), CC(ic, 1, k));
            CH(i, k, 0) = sub(CC(i, 0, k), CC(ic, 1, k));
            const double wr = Plan<N>::tw(i - 2), wi = Plan<N>::tw(i - 1);
            CH(i, k, 1) = add(mul(wr, ti2), mul(wi, tr2));
            CH(i - 1, k, 1) = sub(mul(wr, tr2), mul(wi, ti2));
        }
    }
#undef CC
#undef CH
}

template <int N, int IDO, int L1>
__device__ __forceinline__ void radb4(const double* cc, double* ch) {
#define CC(a, b, c) cc[(a) + IDO * ((b) + 4 * (c))]
#define CH(a, b, c) ch[(a) + IDO * ((b) + L1 * (c))]
#pragma unroll
    for (int k = 0; k < L1; ++k) {
        const double tr2 = add(CC(0, 0, k), CC(IDO - 1, 3, k));
        const double tr1 = sub(CC(0, 0, k), CC(IDO - 1, 3, k));
        const double tr3 = mul(2.0, CC(IDO - 1, 1, k));
        const double tr4 = mul(2.0, CC(0, 2, k));
        CH(0, k, 0) = add(tr2, tr3);
        CH(0, k, 2) = sub(tr2, tr3);
        CH(0, k, 3) = add(tr1, tr4);
        CH(0, k, 1) = sub(tr1, tr4);
    }
    if (IDO % 2 == 0) {
#pragma unroll
        for (int k = 0; k < L1; ++k) {
            const double ti1 = add(CC(0, 3, k), CC(0, 1, k)), ti2 = sub(CC(0, 3, k), CC(0, 1, k));
            const double tr2 = add(CC(IDO - 1, 0, k), CC(IDO - 1, 2, k));
            const double tr1 = sub(CC(IDO - 1, 0, k), CC(IDO - 1, 2, k));
            CH(IDO - 1, k, 0) = add(tr2, tr2);
            CH(IDO - 1, k, 1) = mul(kSqrt2, sub(tr1, ti1));
            CH(IDO - 1, k, 2) = add(ti2, ti2);
            CH(IDO - 1, k, 3) = mul(-kSqrt2, add(tr1, ti1));
        }
    }
#pragma unroll
    for (int k = 0; k < L1; ++k) {
#pragma unroll
        for (int i = 2; i < IDO; i += 2) {
            const int ic = IDO - i;
            const double tr2 = add(CC(i - 1, 0, k), CC(ic - 1, 3, k)), tr1 = sub(CC(i - 1, 0, k), CC(ic - 1, 3, k));
            const double ti1 = add(CC(i, 0, k), CC(ic, 3, k)), ti2 = sub(CC(i, 0, k), CC(ic, 3, k));
            const double tr4 = add(CC(i, 2, k), CC(ic, 1, k)), ti3 = sub(CC(i, 2, k), CC(ic, 1, k));
            const double tr3 = add(CC(i - 1, 2, k), CC(ic - 1, 1, k)), ti4 = sub(CC(i - 1, 2, k), CC(ic - 1, 1, k));
            CH(i - 1, k, 0) = add(tr2, tr3);
            const double cr3 = sub(tr2, tr3);
            CH(i, k, 0) = add(ti2, ti3);
            const double ci3 = sub(ti2, ti3);
            const double cr4 = add(tr1, tr4), cr2 = sub(tr1, tr4);
            const double ci2 = add(ti1, ti4), ci4 = sub(ti1, ti4);
            const double cis[3] = {ci2, ci3, ci4}, crs[3] = {cr2, cr3, cr4};
#pragma unroll
            for (int j = 0; j < 3; ++j) {  // MULPM
                const double wr = Plan<N>::tw(i - 2 + j * (IDO - 1)), wi = Plan<N>::tw(i - 1 + j * (IDO - 1));
                CH(i, k, j + 1) = add(mul(wr, cis[j]), mul(wi, crs[j]));
                CH(i - 1, k, j + 1) = sub(mul(wr, crs[j]), mul(wi, cis[j]));
            }
        }
    }
#undef CC
#undef CH
}

// rfftp::exec on c (N samples), with ch as scratch, then copy_and_norm's
// scale.  Factors (2, 4) for N = 8 and (4, 4) for N = 16; the forward
// transform runs the last factor first.
template <int N>
__device__ __forceinline__ void rfft(double (&c)[N], bool forward) {
    double ch[N];
    constexpr int F = Plan<N>::kFirst, IDO = N / F;  // the first factor and its ido; the other is 4, ido 1
    if (forward) {
        radf4<N, 1, N / 4>(c, ch);
        if constexpr (F == 4) {
            radf4<N, IDO, 1>(ch, c);
        } else {
            radf2<N, IDO, 1>(ch, c);
        }
    } else {
        if constexpr (F == 4) {
            radb4<N, IDO, 1>(c, ch);
        } else {
            radb2<N, IDO, 1>(c, ch);
        }
        radb4<N, 1, F>(ch, c);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = mul(Plan<N>::kFct, c[k]);
}

// T_dcst23::exec, type 2 (cosine, ortho)
template <int N>
__device__ __forceinline__ void dct2_line(double (&c)[N]) {
    constexpr int NS2 = (N + 1) / 2;
    c[0] = mul(c[0], 2.0);
    c[N - 1] = mul(c[N - 1], 2.0);
#pragma unroll
    for (int k = 1; k < N - 1; k += 2) {  // MPINPLACE(c[k + 1], c[k])
        const double t = c[k + 1];
        c[k + 1] = sub(t, c[k]);
        c[k] = add(t, c[k]);
    }
    rfft<N>(c, false);
#pragma unroll
    for (int k = 1; k < NS2; ++k) {
        const int kc = N - k;
        const double t1 = add(mul(Plan<N>::dct(k - 1), c[kc]), mul(Plan<N>::dct(kc - 1), c[k]));
        const double t2 = sub(mul(Plan<N>::dct(k - 1), c[k]), mul(Plan<N>::dct(kc - 1), c[kc]));
        c[k] = mul(0.5, add(t1, t2));
        c[kc] = mul(0.5, sub(t1, t2));
    }
    c[NS2] = mul(c[NS2], Plan<N>::dct(NS2 - 1));
    c[0] = mul(c[0], mul(kSqrt2, 0.5));
}

// T_dcst23::exec, type 3 (cosine, ortho): the inverse of type 2
template <int N>
__device__ __forceinline__ void dct3_line(double (&c)[N]) {
    constexpr int NS2 = (N + 1) / 2;
    c[0] = mul(c[0], kSqrt2);
#pragma unroll
    for (int k = 1; k < NS2; ++k) {
        const int kc = N - k;
        const double t1 = add(c[k], c[kc]), t2 = sub(c[k], c[kc]);
        c[k] = add(mul(Plan<N>::dct(k - 1), t2), mul(Plan<N>::dct(kc - 1), t1));
        c[kc] = sub(mul(Plan<N>::dct(k - 1), t1), mul(Plan<N>::dct(kc - 1), t2));
    }
    c[NS2] = mul(c[NS2], mul(2.0, Plan<N>::dct(NS2 - 1)));
    rfft<N>(c, true);
#pragma unroll
    for (int k = 1; k < N - 1; k += 2) {  // MPINPLACE(c[k], c[k + 1])
        const double t = c[k];
        c[k] = sub(t, c[k + 1]);
        c[k + 1] = add(t, c[k + 1]);
    }
}

template <int N>
__device__ __forceinline__ void line(double (&c)[N], bool inverse) {
    if (inverse) {
        dct3_line<N>(c);
    } else {
        dct2_line<N>(c);
    }
}

constexpr int kThreads = 128;

// blockDim (N, 128 / N): thread (t, b) owns column t, then row t, of block
// blockIdx.x * (128 / N) + b
template <int N>
__global__ void __launch_bounds__(kThreads) dct_scipy_kernel(const int64_t* __restrict__ in,
                                                             int64_t* __restrict__ out, int nb, bool inverse) {
    constexpr int kPer = kThreads / N;
    __shared__ double s[kPer][N][N + 1];
    const int t = threadIdx.x, lb = threadIdx.y;
    const int b = blockIdx.x * kPer + lb;
    const bool live = b < nb;
    const int64_t* x = in + (size_t)b * N * N;
    double c[N];
    // axis -2: column t
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = live ? (double)x[k * N + t] : 0.0;
    line<N>(c, inverse);
#pragma unroll
    for (int k = 0; k < N; ++k) s[lb][k][t] = c[k];
    __syncthreads();
    // axis -1: row t
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = s[lb][t][k];
    line<N>(c, inverse);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) s[lb][t][k] = rint(c[k]);
    __syncthreads();
    if (!live) return;
    int64_t* y = out + (size_t)b * N * N;
#pragma unroll
    for (int k = 0; k < N; ++k) y[k * N + t] = (int64_t)s[lb][k][t];
}

template <int N>
int launch(const void* in, void* out, int nb, int inverse, void* stream) {
    constexpr int kPer = kThreads / N;
    dim3 block(N, kPer);
    dct_scipy_kernel<N><<<(nb + kPer - 1) / kPer, block, 0, (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, nb, inverse != 0);
    return (int)cudaGetLastError();
}

}  // namespace

// in, out: (nb, n, n) int64, n in {8, 16}; inverse: 0 for the DCT-II, 1 for
// its inverse.  Returns a CUDA error code (cudaErrorInvalidValue for another n).
extern "C" int so_dct_scipy(const void* in, void* out, int nb, int n, int inverse, void* stream) {
    if (nb <= 0) return 0;
    if (n == 8) return launch<8>(in, out, nb, inverse, stream);
    if (n == 16) return launch<16>(in, out, nb, inverse, stream);
    return (int)cudaErrorInvalidValue;
}
