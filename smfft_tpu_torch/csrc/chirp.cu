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
// and the convolution exist only in shared memory and registers, so the
// kernel follows its in-block core.
//
// Design, on the Hopper core of hcore.cuh:
//   * one row a block from m = 512 up (F rows below, 128 threads), so a
//     barrier waits for one row's warps only; E = 16 points a thread (32 at
//     m >= 8192), two row buffers (one barrier a stage) where they take at
//     most 72 KB, else one in place; the blocks an SM and the register cap
//     follow from the shared memory (BlueGeometry::MINB);
//   * the load reads the n points of a row through stockham.cuh's Io
//     (interleaved or planar, stride ld) straight into the registers of the
//     first stage and multiplies the pre-chirp in.  The points j >= m/2 are
//     zeros (m >= 2n - 1), so the first forward stage reads and transforms
//     only its operands r < 8;
//   * thread t holds the points t + s*TPF both after the forward core's
//     last stage and before the inverse core's first, so the product with
//     H (natural order, coalesced __ldg) happens in registers and the
//     inverse core starts at once: no hand-off through shared memory, and
//     with two buffers not even a barrier between the two cores;
//   * the inverse core's last stage computes only the points k < m/2 (n <=
//     m/2 are stored): the first n times the post-chirp and the scale, the
//     rest of the row (lanes n..ld-1) as zeros;
//   * both products (H, the post-chirp) take the last stages' outputs
//     unrounded; the registers between the stages hold the storage type
//     (fp32 for "exact" at m = 16384, whose registers could not hold 32
//     fp64 points a thread at 512 threads without spilling);
//   * the stage twiddles are read from the block's table in shared memory
//     (filled from the forward W_m table; the inverse core conjugates);
//   * "exact": fp64 arithmetic, chirps, response and twiddles, fp64 shared
//     memory up to m = 8192 and fp32 at 16384 (as Geometry);
//   * 64-bit offsets; rows past the batch compute on zeros and store
//     nothing; the launcher returns cudaGetLastError() right after the
//     launch.

#include "hcore.cuh"

namespace {

using namespace smfft;

// The block layout of an m-point Bluestein row.
template <int M, bool EXACT>
struct BlueGeometry {
    using C = typename std::conditional<EXACT, double2, float2>::type;
    using S = typename std::conditional<EXACT && M <= 8192, double2,
                                        float2>::type;
    static constexpr int E = M >= 8192 ? 32 : 16;
    static constexpr int TPF = M / E;
    static constexpr int F = TPF >= 128 ? 1 : 128 / TPF;  // rows a block
    static constexpr int THREADS = TPF * F;
    static constexpr int SLOT = M + M / 16;                // padded row
    static constexpr bool PP = 2 * SLOT * sizeof(S) <= 72 * 1024;
    using Core = hc::Core<M, TPF, true, PP>;
    static constexpr size_t SMEM =
        (PP ? 2 : 1) * F * SLOT * sizeof(S) + Core::TAB * sizeof(C);
    // blocks an SM: what the shared memory allows (1 KB of it reserved a
    // block), at most 20 warps for fp32 (102 registers a thread), 8 for
    // "exact" (255); __launch_bounds__ derives the register cap from it
    static constexpr int BY_SMEM = (int)(233472 / (SMEM + 1024));
    static constexpr int BY_WARPS = (EXACT ? 256 : 640) / THREADS;
    static constexpr int MINB =
        BY_SMEM < BY_WARPS ? (BY_SMEM > 0 ? BY_SMEM : 1)
                           : (BY_WARPS > 0 ? BY_WARPS : 1);
    static unsigned blocks(int64_t batch) {
        return (unsigned)((batch + F - 1) / F);
    }
};

template <int M, bool EXACT>
__global__ void __launch_bounds__(BlueGeometry<M, EXACT>::THREADS,
                                  BlueGeometry<M, EXACT>::MINB)
bluestein_kernel(Io io, int64_t batch, int n, int64_t ld,
                 const typename BlueGeometry<M, EXACT>::C* __restrict__ chirp,
                 const typename BlueGeometry<M, EXACT>::C* __restrict__ h,
                 const typename BlueGeometry<M, EXACT>::C* __restrict__ tw,
                 double scale) {
    using G = BlueGeometry<M, EXACT>;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + (G::PP ? 2 : 1) * G::F * G::SLOT);
    Core::fill(tab, tw, threadIdx.x, G::THREADS);
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const int64_t first = (int64_t)blockIdx.x * G::F + f;  // this row
    const bool live = first < batch;
    const int64_t row = first * ld;  // this row's first point
    S* a = smem + f * (G::PP ? 2 : 1) * G::SLOT;
    S* b = G::PP ? a + G::SLOT : a;

    // x[j] w[j] for j = t + s*TPF < n, held in the storage type; the
    // points j >= M/2 (s >= E/2) are zeros that the first stage never reads
    S u[E];
#pragma unroll
    for (int s = 0; s < E / 2; ++s) {
        const int j = t + s * TPF;
        C v = cmake(T(0), T(0));
        if (live && j < n) v = cmul(as<C>(io.load(row + j)), __ldg(&chirp[j]));
        put(u[s], v);
    }
    __syncthreads();  // the twiddle table
    // the forward core; each spectrum point t + s*TPF times H, unrounded,
    // into the registers that the inverse core's first stage takes
    Core::template run_regs<true, false>(
        u, a, b, t, tab, false, T(-1),
        [&](int s, C v) { return cmul(v, __ldg(&h[t + s * TPF])); });
    if (!Core::LAST_READS_B) __syncthreads();
    // the inverse core; point k = t + s*TPF < n times the post-chirp and
    // the scale, unrounded (the lower half, s < E/2, holds every k < M/2)
    const T sc = T(scale);
    Core::template run_regs<false, true>(
        u, a, b, t, tab, true, T(1), [&](int s, C v) {
            const int k = t + s * TPF;
            if (k >= n) return v;
            v = cmul(v, __ldg(&chirp[k]));
            return cmake(sc * v.x, sc * v.y);
        });
    if (!live) return;  // no barrier follows
#pragma unroll
    for (int s = 0; s < E / 2; ++s) {
        const int k = t + s * TPF;
        if (k < n) io.store(row + k, as<float2>(u[s]));
    }
    for (int64_t k = n + t; k < ld; k += TPF)
        io.store(row + k, make_float2(0.0f, 0.0f));
}

template <int M, bool EXACT>
cudaError_t launch_bluestein(const Io& io, int64_t batch, int n, int64_t ld,
                             const void* chirp, const void* h,
                             const void* tw_f, double scale,
                             cudaStream_t stream) {
    using G = BlueGeometry<M, EXACT>;
    using C = typename G::C;
    auto kernel = bluestein_kernel<M, EXACT>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, n, ld, static_cast<const C*>(chirp),
        static_cast<const C*>(h), static_cast<const C*>(tw_f), scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows (batch, ld) of n <= ld points, interleaved complex64 or fp32 planes,
// -> out, the same layout and shape: the n-point DFT of each row times
// scale in lanes 0..n-1, zeros in lanes n..ld-1.  m: the circular length,
// a power of two in 32..16384 with m >= 2n - 1.  chirp (n,): w[j] (its
// conjugate for the inverse); h (m,): DFT_m(b) / m in natural order (its
// conjugate for the inverse); tw_f = W_m^{-j}, j < m (the inverse core
// conjugates it); all complex (re, im) pairs, float32, or float64 when
// exact != 0.  Returns a cudaError_t (0 on success).
int smfft_bluestein(const void* in_re, const void* in_im, void* out_re,
                    void* out_im, int interleaved, int64_t batch, int64_t n,
                    int64_t ld, int64_t m, const void* chirp, const void* h,
                    double scale, const void* tw_f, int exact,
                    void* stream) {
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
                                                        scale, st)          \
                           : launch_bluestein<MM, false>(io, batch, nn, ld, \
                                                         chirp, h, tw_f,    \
                                                         scale, st));
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
