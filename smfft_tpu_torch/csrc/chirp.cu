// The DFT of any length n <= 8192 in one pass (Bluestein's chirp-z
// algorithm): one kernel for Hopper (sm_90a), in an fp32 and an "exact"
// (fp64 arithmetic) instantiation.
//
// bluestein_kernel replaces the TPU kernel
//   smfft_tpu/ops/chirp.py::_build_bluestein
// and computes, for complex rows x of n points (complex64 or planar fp32,
// row stride ld >= n),
//     X[k] = s * w[k] * sum_j (x[j] w[j]) b[k - j],   k < n,
// the DFT of each row (scale s), with w[j] = exp(-i pi j^2 / n) and b =
// conj(w) extended symmetrically to the circular length m, the supported
// power of two >= 2n - 1 (m = 32..16384).  The convolution with b runs as
// an m-point forward transform, a product with H = DFT_m(b) / m, and an
// m-point inverse transform.  The inverse DFT is the same function with w
// and H conjugated (the host passes the conjugated tables): it equals the
// JAX package's conj(fft_any(conj x)).  Lanes n..ld-1 of each output row
// are written as zeros (the planar rows of ops/chirp.py are n_pad wide).
//
// What bounds it on the H100: 16 n bytes a row (8 in, 8 out) against two
// m-point transforms, 2 * 5 m log2 m flops, with m >= 2n: at n = 1000 (m =
// 2048) 131072 rows move 2.1 GB, 0.63 ms at 3.35 TB/s, against 0.44 ms of
// fp32 operations at 67 TFLOP/s; at n = 4097 (m = 16384) 32768 rows take
// 1.12 ms of operations against 0.64 of bytes.  The zero-extended signal
// and the convolution exist only in shared memory and registers.
//
// Design: conv_kernel (conv.cu) at one filter, with a row width that is
// not the transform length:
//   * the load reads the n points of a row through stockham.cuh's Io
//     (interleaved or planar, stride ld) and multiplies the pre-chirp in;
//     points n..m-1 are zeros that exist only in the first stage's
//     registers;
//   * the forward m-point core leaves the spectrum in registers in natural
//     order, so H is read in natural order (no revblock re-index, unlike
//     the TPU kernel), multiplied, and handed to the inverse core through
//     shared memory (stockham.cuh::handoff);
//   * the inverse core's last stage gives natural points; the first n are
//     multiplied by the post-chirp and the scale and stored, the rest of
//     the row (lanes n..ld-1) is stored as zeros.  Both last stages hand
//     their butterflies' outputs to the product unrounded
//     (stockham.cuh::last_stage_then), which keeps the "exact" tier at m = 16384, whose
//     shared memory is fp32, two roundings closer to float64.
//   * The spectrum is held in registers across the product as in
//     conv_kernel, so the kernel takes ConvBudget's register budget.
//   * "exact": fp64 arithmetic, chirps, response and twiddles, fp64 shared
//     memory up to m = 8192 and fp32 at 16384 (Geometry), as conv.cu.
//   * 64-bit offsets; the ragged tail of the batch is masked; the launcher
//     returns cudaGetLastError() right after the launch.

#include "stockham.cuh"

namespace {

using namespace smfft;

template <int M, int TPF, int F, int MINB, typename C, typename S>
__global__ void __launch_bounds__(TPF * F, MINB)
bluestein_kernel(Io io, int64_t batch, int n, int64_t ld,
                 const C* __restrict__ chirp, const C* __restrict__ h,
                 const C* __restrict__ tw_f, const C* __restrict__ tw_i,
                 double scale) {
    using T = real_t<C>;
    S* smem = shared_buffer<S>();
    constexpr int E = M / TPF;  // points per thread
    constexpr int RL = Ladder<M>::RL;
    const int64_t first = (int64_t)blockIdx.x * F;  // first row
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = first + f < batch;
    const int64_t row = (first + f) * ld;  // this row's first point
    S* buf = smem + f * M;

    // x[j] w[j] for j < n, zeros up to m
    constexpr int Q0 = E / 8;
    S u[Q0][8];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int j = t + q * TPF + r * (M / 8);
            C v = cmake(T(0), T(0));
            if (live && j < n)
                v = cmul(as<C>(io.load(row + j)), __ldg(&chirp[j]));
            put(u[q][r], v);
        }
    first_stage<M, TPF>(u, buf, t, tw_f, T(-1), T(1));
    middle_stages<M, TPF>(buf, t, tw_f, T(-1));
    // the spectrum times H, bin t + q*TPF + r*M/RL, natural order
    constexpr int QL = E / RL;
    S g[QL][RL];
    last_stage_then<M, TPF>(buf, t, tw_f, T(-1), [&](int q, int r, C v) {
        put(g[q][r], cmul(v, __ldg(&h[t + q * TPF + r * (M / RL)])));
    });
    handoff<M, TPF>(buf, t, g, false, u);
    first_stage<M, TPF>(u, buf, t, tw_i, T(1), T(1));
    middle_stages<M, TPF>(buf, t, tw_i, T(1));
    if (!live) return;  // no barrier follows

    // point k of the convolution, k < n, times the post-chirp and the scale
    const T s = T(scale);
    last_stage_then<M, TPF>(buf, t, tw_i, T(1), [&](int q, int r, C v) {
        const int k = t + q * TPF + r * (M / RL);
        if (k < n) {
            v = cmul(v, __ldg(&chirp[k]));
            io.store(row + k, as<float2>(cmake(s * v.x, s * v.y)));
        }
    });
    for (int64_t k = n + t; k < ld; k += TPF)
        io.store(row + k, make_float2(0.0f, 0.0f));
}

template <int M, bool EXACT>
cudaError_t launch_bluestein(const Io& io, int64_t batch, int n, int64_t ld,
                             const void* chirp, const void* h,
                             const void* tw_f, const void* tw_i, double scale,
                             cudaStream_t stream) {
    using G = Geometry<M, EXACT>;
    using C = typename G::C;
    auto kernel = bluestein_kernel<M, G::TPF, G::F, ConvBudget<M, EXACT>::MINB,
                                   C, typename G::S>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, n, ld, static_cast<const C*>(chirp),
        static_cast<const C*>(h), static_cast<const C*>(tw_f),
        static_cast<const C*>(tw_i), scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows (batch, ld) of n <= ld points, interleaved complex64 or fp32 planes,
// -> out, the same layout and shape: the n-point DFT of each row times
// scale in lanes 0..n-1, zeros in lanes n..ld-1.  m: the circular length,
// a power of two in 32..16384 with m >= 2n - 1.  chirp (n,): w[j] (its
// conjugate for the inverse); h (m,): DFT_m(b) / m in natural order (its
// conjugate for the inverse); tw_f, tw_i = W_m^{-+j}, j < m; all complex
// (re, im) pairs, float32, or float64 when exact != 0.  Returns a
// cudaError_t (0 on success).
int smfft_bluestein(const void* in_re, const void* in_im, void* out_re,
                    void* out_im, int interleaved, int64_t batch, int64_t n,
                    int64_t ld, int64_t m, const void* chirp, const void* h,
                    double scale, const void* tw_f, const void* tw_i,
                    int exact, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (n < 1 || ld < n || 2 * n - 1 > m) return (int)cudaErrorInvalidValue;
    Io io;
    io.in_re = static_cast<const float*>(in_re);
    io.in_im = static_cast<const float*>(in_im);
    io.out_re = static_cast<float*>(out_re);
    io.out_im = static_cast<float*>(out_im);
    io.interleaved = interleaved != 0;
    const int nn = (int)n;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(MM)                                                      \
    case MM:                                                                \
        return (int)(exact ? launch_bluestein<MM, true>(io, batch, nn, ld,  \
                                                        chirp, h, tw_f,     \
                                                        tw_i, scale, st)    \
                           : launch_bluestein<MM, false>(io, batch, nn, ld, \
                                                         chirp, h, tw_f,    \
                                                         tw_i, scale, st));
    switch (m) {
        SMFFT_CASE(32)
        SMFFT_CASE(64)
        SMFFT_CASE(128)
        SMFFT_CASE(256)
        SMFFT_CASE(512)
        SMFFT_CASE(1024)
        SMFFT_CASE(2048)
        SMFFT_CASE(4096)
        SMFFT_CASE(8192)
        SMFFT_CASE(16384)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef SMFFT_CASE
}

}  // extern "C"
