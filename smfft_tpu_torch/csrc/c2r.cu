// Batched fp32 complex-to-real transforms (C2R), n = 64..16384, one
// shared-memory kernel for Hopper (sm_90a) in an fp32 and an "exact" (fp64
// arithmetic) instantiation: the inverse of real.cu's R2C kernel.
//
// It replaces the TPU kernels
//   smfft_tpu/ops/pallas_real.py::_build_irfft     (fused C2R, revblock or
//                                                   natural packed input)
//   smfft_tpu/ops/pencil.py::_build_real           (inverse: n <= 1024)
//   smfft_tpu/ops/real_direct.py::_build_irfft_pair, _build_irfft_pair2
//                                                  (natural C2R, n >= 2048)
//   smfft_tpu/ops/real_direct.py::_build_irfft_direct (single-row C2R).
// Those TPU kernels differ only in how the TPU routes the data (pencil
// planes, pair rows); they compute one function:
//
//   C2R: packed X (B, L), L = n/2, in one of the four layouts of real.cu
//        -> scale * L * irfft(X) (B, n), the reference's raw contract at
//        scale 1 (SMFFT_Stockham_R2C_C2R/FFT.c:170-171).
//
// The half-size trick run backwards (real_pair.cuh): with W = W_n = exp(-2
// pi i / n), the merge of the pair (k, L-k), the scale folded in,
//   E = s (X[k] + conj X[L-k]) / 2,  O = s (X[k] - conj X[L-k]) W^-k / 2,
//   Z[k] = E + i O,  Z[L-k] = conj(E - i O),
//   Z[0] = s ((DC + Nyq) / 2, (DC - Nyq) / 2),
// then an inverse L-point transform whose output z[m] is (x[2m], x[2m+1]):
// the real row written as L float2.
//
// What bounds it on the H100: 8 bytes per real sample (4 in, 4 out; the
// numpy layout reads one extra complex bin a row), against about
// 2.5 n log2 n flops a row, so it is bound by device memory bandwidth:
// 2^27 real samples move 1.07 GB, 0.32 ms at 3.35 TB/s.  One read and one
// write of device memory per call.
//
// Design:
//   * On the Hopper core of hcore.cuh and the R2C kernel's block (RowGeometry
//     at M = L; 16 warps an SM, 128 registers a thread: 24 and 32 spilled),
//     the merge before the inverse ladder, in the registers the first stage
//     takes: no pass through shared memory and no barrier before the ladder
//     for the natural layouts (planar, packed, numpy).  Thread t needs Z[p]
//     for its points p = t + s*TPF; it reads X[p] and the mirror X[L-p]
//     straight from device memory (p ascends across a warp and L-p descends:
//     both reads are coalesced segments, and each bin is read twice, by the
//     threads of p and of L-p, the second read served by L2), forms Z[p] with
//     W_n^p (an __ldg a point; a block's rows share the entries in L1) and the
//     scale folded in (real_pair.cuh; p = 0 from (DC, Nyquist): slot 0, or the
//     numpy layout's real parts of bins 0 and L) and runs the inverse core
//     from the registers (Core::run_regs), which leaves natural z there:
//     float2 stores into the real row, the even/odd re-interleave, coalesced
//     and free.  One thread a pair (k, L-k) merging into the row, one barrier
//     and the inverse from the row measured 2 % faster at n = 1024 planar but
//     3-13 % slower elsewhere on the main path (H100). The stage table is made
//     from the inverse W_L table the wrapper passes. planar_rev alone stages:
//     the block loads its rows coalesced by position into the revblock staging
//     (RowGeometry::stage, the R2C kernel's; the second buffer where the row
//     has two), one barrier, each thread reads X[p] and X[L-p] from there (the
//     mirror runs one bin off a warp's aligned run, one wavefront over the
//     minimum) and, with one buffer, all reads finish before the first stage
//     writes it.  The ragged tail of the batch is masked; offsets are 64-bit.
//   * Tables from the host, computed in float64 and rounded once: the
//     inverse L-point stage twiddles W_L^-m (params.twiddle_table; the
//     block table keeps W^k and the anchors W^(4k) as c2c.cu's does) and
//     W_n^k, k < L (params.real_split_table), whose conjugate is W^-k.
//   * "exact": fp64 arithmetic, tables and shared memory (139 KB padded
//     at L = 8192); the output's rounding to fp32 is the only one.
//   * The launcher returns cudaGetLastError() right after the launch.

#include "hcore.cuh"
#include "real_pair.cuh"

namespace {

using namespace smfft;

// 16 warps an SM (128 registers a thread, no fp32 spills; models/hcore.py
// ROW_WARPS)
template <int L, bool EXACT>
using C2rGeometry = hc::RowGeometry<L, EXACT, 16>;

template <int L, bool EXACT>
__global__ void __launch_bounds__(C2rGeometry<L, EXACT>::THREADS,
                                  C2rGeometry<L, EXACT>::MINB)
c2r_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
           int layout, float2* __restrict__ y, int64_t batch, float scale,
           const typename C2rGeometry<L, EXACT>::C* __restrict__ tw,
           const typename C2rGeometry<L, EXACT>::C* __restrict__ wn) {
    using G = C2rGeometry<L, EXACT>;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, THREADS = G::THREADS, CB = G::CB;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + G::F * G::BUF);
    // read from the second stage on, after the first stage's barrier
    Core::fill(tab, tw, threadIdx.x, THREADS);
    const int64_t first = (int64_t)blockIdx.x * G::F;  // first row
    const int64_t rows_left = batch - first;
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = f < rows_left;
    const int64_t row = (first + f) * L;  // this row's first output float2
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;
    if (CB == 1 && layout == PLANAR_REV) layout = PLANAR;

    // Z[m] from X[m] and X[L-m] (real_pair.cuh), the scale folded in; m =
    // 0 from (DC, Nyquist): slot 0, or the numpy layout's real parts of
    // bins 0 and L
    const T h = T(0.5) * T(scale);
    const auto merge = [&](int m, C xa, C xb) {
        if (m == 0)
            return merge_dc(layout == NUMPY ? cmake(xa.x, xb.x) : xa, h);
        C zk, zm;
        merge_pair_w(xa, xb, __ldg(wn + m), h, zk, zm);
        return zk;
    };
    // the mirror bin of point m (bin L for the numpy layout's Nyquist)
    const auto mirror = [&](int m) {
        return m ? L - m : (layout == NUMPY ? L : 0);
    };

    // u[s] = Z[t + s*TPF], the points the first stage takes
    C u[E];
    if (layout == PLANAR_REV) {
        // coalesced by position into the staging (the second buffer, or
        // the only one); rows past the batch are zeros
        constexpr int OFF = G::PP ? G::SLOT : 0;
        const int64_t valid = rows_left * L;
        float2 v[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            v[j] = e < valid ? make_float2(__ldg(in_re + first * L + e),
                                           __ldg(in_im + first * L + e))
                             : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            put(smem[(e / L) * G::BUF + OFF + G::stage(e % L)], v[j]);
        }
        __syncthreads();
        const S* st = a + OFF;
#pragma unroll
        for (int s = 0; s < E; ++s) {
            const int m = t + s * TPF;
            u[s] = merge(m, as<C>(st[G::stage(revblock_pos(m, CB))]),
                         as<C>(st[G::stage(revblock_pos(mirror(m), CB))]));
        }
        // the first stage writes the staging's buffer
        if (!G::PP) __syncthreads();
    } else {
        // X[m] ascends across a warp and X[L-m] descends: both reads are
        // coalesced, and each bin's second read comes from L2
        const float2* const pk = reinterpret_cast<const float2*>(in_re);
        const float2* const ny = pk + (first + f) * (L + 1);
        const auto load = [&](int k) {
            if (!live) return make_float2(0.0f, 0.0f);
            if (layout == NUMPY) return __ldg(ny + k);
            if (layout == PACKED) return __ldg(pk + row + k);
            return make_float2(__ldg(in_re + row + k), __ldg(in_im + row + k));
        };
        float2 xa[E], xb[E];
#pragma unroll
        for (int s = 0; s < E; ++s) {
            xa[s] = load(t + s * TPF);
            xb[s] = load(mirror(t + s * TPF));
        }
#pragma unroll
        for (int s = 0; s < E; ++s)
            u[s] = merge(t + s * TPF, as<C>(xa[s]), as<C>(xb[s]));
    }

    // the inverse L-point transform, natural z into the registers: z[m] =
    // (x[2m], x[2m+1]), float2 stores into the real row
    Core::template run_regs<false, false>(u, a, b, t, tab, false, T(1),
                                          [&](int, C v) { return v; });
    if (live) {
#pragma unroll
        for (int s = 0; s < E; ++s) y[row + t + s * TPF] = as<float2>(u[s]);
    }
}

template <int L, bool EXACT>
cudaError_t launch_c2r(const float* in_re, const float* in_im, int layout,
                       float* y, int64_t batch, float scale, const void* tw,
                       const void* wn, cudaStream_t stream) {
    using G = C2rGeometry<L, EXACT>;
    using C = typename G::C;
    auto kernel = c2r_kernel<L, EXACT>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        in_re, in_im, layout, reinterpret_cast<float2*>(y), batch, scale,
        static_cast<const C*>(tw), static_cast<const C*>(wn));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Packed half spectrum in `layout` (as smfft_r2c's output; layout 3 reads
// only the real parts of DC and Nyquist) -> real rows y (batch, n) fp32,
// 8-byte aligned, equal to scale * (n/2) * irfft.  twiddles: the inverse
// W_L^{-m}, m < L; split: W_n^k, k < L (the kernel conjugates it).
int smfft_c2r(const void* in_re, const void* in_im, int layout, void* y,
              int64_t batch, int64_t n, float scale, const void* twiddles,
              const void* split, int exact, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (layout < PLANAR || layout > NUMPY) return (int)cudaErrorInvalidValue;
    const float* i_re = static_cast<const float*>(in_re);
    const float* i_im = static_cast<const float*>(in_im);
    float* yf = static_cast<float*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(LL)                                                       \
    case 2 * LL:                                                             \
        return (int)(exact ? launch_c2r<LL, true>(i_re, i_im, layout, yf,     \
                                                  batch, scale, twiddles,     \
                                                  split, st)                  \
                           : launch_c2r<LL, false>(i_re, i_im, layout, yf,    \
                                                   batch, scale, twiddles,    \
                                                   split, st));
    switch (n) {
        SMFFT_REAL_SIZES(SMFFT_CASE)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef SMFFT_CASE
}

}  // extern "C"
