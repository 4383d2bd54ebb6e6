// Fused spectral convolution: forward transform, filter product and
// inverse transform of every row in one kernel, with one read and one
// write of device memory.  Two kernels for Hopper (sm_90a), each in an
// fp32 and an "exact" (fp64 arithmetic) instantiation.
//
// conv_kernel replaces the TPU kernels
//   smfft_tpu/ops/convolve.py::_build_conv       (m = 1)
//   smfft_tpu/ops/convolve.py::_build_conv_bank  (m >= 1)
// and computes, for N = 32..16384, complex64 or planar fp32 rows,
//     y[j, b] = ifft(fft(x[b]) * H[j])          (numpy normalization),
// with H[j] natural-order responses (m, N) whose 1/N the host has folded
// in (a power of two: exact).  The output is (m, B, N).
//
// conv_real_kernel replaces the TPU kernels
//   smfft_tpu/ops/convolve.py::_build_conv_real      (m = 1)
//   smfft_tpu/ops/convolve.py::_build_conv_real_bank (m >= 1)
// and computes, for n = 256..16384, real fp32 rows in and out,
//     y[j, b] = irfft(rfft(x[b]) * H[j]),
// with H[j] the packed half response (m, L), L = n/2: slot 0 = (Re H[0],
// Re H[L]), bins 1..L-1 as given, 1/L folded in.  Slot 0 of the packed
// spectrum is (DC, Nyquist), two real numbers, each multiplied by its own
// real response.
//
// What bounds them on the H100: device memory.  A call reads each input
// point once and writes each output once: 8 + 8m bytes a complex point,
// 4 + 4m a real sample; against about 5 N log2 N (1 + m) flops a complex
// row, so at m <= 4 the bytes dominate (2^27 points at N = 1024, m = 1:
// 0.64 ms of bytes against 0.20 ms of fp32 operations at the published
// peaks).  The filters (m N complex) are read from L2 by every block.
//
// Design (stockham.cuh's core and Geometry, as c2c.cu and real.cu):
//   * The TPU kernels keep the spectrum in revblock order and re-index H to
//     match (convolve.py::freq_to_revblock); here the last forward stage
//     leaves the spectrum in registers in natural order (w[q][r] = bin
//     t + q*TPF + r*N/RL), so H stays in natural order and each thread
//     reads the bins it holds.  The product is handed to the inverse
//     ladder through shared memory (stockham.cuh::handoff) and the inverse
//     writes natural rows straight to device memory.
//   * Bank: the forward transform runs once per row and its spectrum must
//     survive m inverses, each of which overwrites the shared buffer.  A
//     second buffer does not fit at N = 16384 (128 KB each against the
//     227 KB a block may use), so every size keeps each thread's spectrum
//     points in registers (E = 16 complex, 32 at N = 16384) across the m
//     loop.  That costs registers, so these kernels take their own
//     __launch_bounds__ minimum (stockham.cuh's ConvBudget) instead of
//     Geometry's, which would force spills.
//   * conv_real_kernel: the R2C half-size trick of real.cu.  After the
//     forward L-point transform Z sits in shared memory; one thread per
//     pair (k, L-k) splits it (real_pair.cuh) into registers, and for each
//     filter multiplies and merges the pair and writes Z' back in place: the
//     split, the product and the merge act on the same pair, so no barrier
//     separates them.  The inverse ladder's last stage writes float2 into
//     the real output row.
//   * "exact": fp64 arithmetic, twiddles, responses and (N <= 8192)
//     shared memory; fp32 shared memory at N = 16384.
//   * 64-bit offsets; the ragged tail of the batch is masked; the
//     launchers return cudaGetLastError() right after the launch.

#include "real_pair.cuh"
#include "stockham.cuh"

namespace {

using namespace smfft;

template <int N, int TPF, int F, int MINB, typename C, typename S>
__global__ void __launch_bounds__(TPF * F, MINB)
conv_kernel(Io io, int64_t batch, int m, const C* __restrict__ h,
            const C* __restrict__ tw_f, const C* __restrict__ tw_i) {
    using T = real_t<C>;
    S* smem = shared_buffer<S>();
    constexpr int E = N / TPF;  // points per thread
    constexpr int RL = Ladder<N>::RL;
    const int64_t first = (int64_t)blockIdx.x * F;  // first transform
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = first + f < batch;
    const int64_t row = (first + f) * N;  // this transform's first point
    S* buf = smem + f * N;

    constexpr int Q0 = E / 8;
    S u[Q0][8];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r)
            put(u[q][r], live ? io.load(row + t + q * TPF + r * (N / 8))
                              : make_float2(0.0f, 0.0f));
    first_stage<N, TPF>(u, buf, t, tw_f, T(-1), T(1));
    middle_stages<N, TPF>(buf, t, tw_f, T(-1));
    constexpr int QL = E / RL;
    S spec[QL][RL];  // bin t + q*TPF + r*N/RL, natural order
    last_stage<N, TPF>(buf, t, tw_f, T(-1), spec);

    for (int j = 0; j < m; ++j) {
        const C* hj = h + (int64_t)j * N;
        S g[QL][RL];
#pragma unroll
        for (int q = 0; q < QL; ++q)
#pragma unroll
            for (int r = 0; r < RL; ++r)
                put(g[q][r], cmul(as<C>(spec[q][r]),
                                  __ldg(&hj[t + q * TPF + r * (N / RL)])));
        handoff<N, TPF>(buf, t, g, false, u);
        first_stage<N, TPF>(u, buf, t, tw_i, T(1), T(1));
        middle_stages<N, TPF>(buf, t, tw_i, T(1));
        float2 w[QL][RL];
        last_stage<N, TPF>(buf, t, tw_i, T(1), w);
        if (live) {
            const int64_t out = (int64_t)j * batch * N + row;
#pragma unroll
            for (int q = 0; q < QL; ++q)
#pragma unroll
                for (int r = 0; r < RL; ++r)
                    io.store(out + t + q * TPF + r * (N / RL), w[q][r]);
        }
    }
}

template <int L, int TPF, int F, int MINB, typename C, typename S>
__global__ void __launch_bounds__(TPF * F, MINB)
conv_real_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                 int64_t batch, int m, const C* __restrict__ h,
                 const C* __restrict__ tw_f, const C* __restrict__ tw_i,
                 const C* __restrict__ wn) {
    using T = real_t<C>;
    S* smem = shared_buffer<S>();
    constexpr int E = L / TPF;  // points per thread
    constexpr int RL = Ladder<L>::RL;
    const int64_t first = (int64_t)blockIdx.x * F;  // first row
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = first + f < batch;
    const int64_t row = (first + f) * L;  // this row's first float2
    S* buf = smem + f * L;

    // R2C: z[m] = x[2m] + i x[2m+1] read as float2, forward L-point
    // transform, Z natural in buf
    constexpr int Q0 = E / 8;
    S u[Q0][8];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r)
            put(u[q][r], live ? __ldg(x + row + t + q * TPF + r * (L / 8))
                              : make_float2(0.0f, 0.0f));
    first_stage<L, TPF>(u, buf, t, tw_f, T(-1), T(1));
    middle_stages<L, TPF>(buf, t, tw_f, T(-1));
    constexpr int QL = E / RL;
    {
        S z[QL][RL];
        last_stage<L, TPF>(buf, t, tw_f, T(-1), z);
        __syncthreads();  // every read of the last stage is done
#pragma unroll
        for (int q = 0; q < QL; ++q)
#pragma unroll
            for (int r = 0; r < RL; ++r) buf[t + q * TPF + r * (L / RL)] = z[q][r];
        __syncthreads();
    }

    // split: thread t holds pairs k = t + p*TPF, k <= L/2, in registers
    // (xs[p][0] = X[k], xs[p][1] = X[L-k]; p = E/2 exists for t = 0 only)
    constexpr int P = E / 2 + 1;
    S xs[P][2];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int k = t + p * TPF;
        if (k > L / 2) break;
        const C a = as<C>(buf[k]);
        if (k == 0) {
            put(xs[p][0], split_dc(a));  // (DC, Nyquist)
            continue;
        }
        C xk, xm;
        split_pair(a, as<C>(buf[L - k]), wn, k, xk, xm);
        put(xs[p][0], xk);
        put(xs[p][1], 2 * k == L ? xk : xm);
    }

    const T hh = T(0.5);  // the merge at scale 1: 1/L is in H
    for (int j = 0; j < m; ++j) {
        const C* hj = h + (int64_t)j * L;
        // each thread writes only its own pairs' bins, which it read
        // itself above: a barrier is needed only after an inverse ladder
        if (j > 0) __syncthreads();
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int k = t + p * TPF;
            if (k > L / 2) break;
            const C a = as<C>(xs[p][0]);
            if (k == 0) {
                const C h0 = __ldg(&hj[0]);
                put(buf[0], merge_dc(cmake(a.x * h0.x, a.y * h0.y), hh));
                continue;
            }
            const C gk = cmul(a, __ldg(&hj[k]));
            const C gm = cmul(as<C>(xs[p][1]), __ldg(&hj[L - k]));
            C zk, zm;
            merge_pair(gk, 2 * k == L ? gk : gm, wn, k, hh, zk, zm);
            put(buf[k], zk);
            if (2 * k != L) put(buf[L - k], zm);
        }
        __syncthreads();

        // C2R: the inverse L-point transform into the real row
        load_first<L, TPF>(buf, t, u);
        __syncthreads();
        first_stage<L, TPF>(u, buf, t, tw_i, T(1), T(1));
        middle_stages<L, TPF>(buf, t, tw_i, T(1));
        float2 w[QL][RL];
        last_stage<L, TPF>(buf, t, tw_i, T(1), w);
        if (live) {
            const int64_t out = (int64_t)j * batch * L + row;
#pragma unroll
            for (int q = 0; q < QL; ++q)
#pragma unroll
                for (int r = 0; r < RL; ++r)
                    y[out + t + q * TPF + r * (L / RL)] = w[q][r];
        }
    }
}

template <int N, bool EXACT>
cudaError_t launch_conv(const Io& io, int64_t batch, int m, const void* h,
                        const void* tw_f, const void* tw_i,
                        cudaStream_t stream) {
    using G = Geometry<N, EXACT>;
    using C = typename G::C;
    auto kernel = conv_kernel<N, G::TPF, G::F, ConvBudget<N, EXACT>::MINB,
                              C, typename G::S>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, m, static_cast<const C*>(h), static_cast<const C*>(tw_f),
        static_cast<const C*>(tw_i));
    return cudaGetLastError();
}

template <int L, bool EXACT>
cudaError_t launch_conv_real(const float* x, float* y, int64_t batch, int m,
                             const void* h, const void* tw_f,
                             const void* tw_i, const void* wn,
                             cudaStream_t stream) {
    using G = Geometry<L, EXACT>;
    using C = typename G::C;
    auto kernel =
        conv_real_kernel<L, G::TPF, G::F, ConvBudget<L, EXACT>::MINB, C,
                         typename G::S>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
        batch, m, static_cast<const C*>(h), static_cast<const C*>(tw_f),
        static_cast<const C*>(tw_i), static_cast<const C*>(wn));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows (batch, n) as smfft_c2c's (interleaved complex64 or fp32 planes)
// against m >= 1 responses h (m, n) -> out (m, batch, n) in the same
// layout.  h: complex (re, im) pairs with 1/n folded in, float32, or
// float64 when exact != 0, like the twiddles: tw_f, tw_i = W_N^{-+m},
// m < N.  Returns a cudaError_t (0 on success).
int smfft_conv(const void* in_re, const void* in_im, void* out_re,
               void* out_im, int interleaved, int64_t batch, int64_t n,
               int m, const void* h, const void* tw_f, const void* tw_i,
               int exact, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (m < 1) return (int)cudaErrorInvalidValue;
    Io io;
    io.in_re = static_cast<const float*>(in_re);
    io.in_im = static_cast<const float*>(in_im);
    io.out_re = static_cast<float*>(out_re);
    io.out_im = static_cast<float*>(out_im);
    io.interleaved = interleaved != 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(NN)                                                     \
    case NN:                                                               \
        return (int)(exact ? launch_conv<NN, true>(io, batch, m, h, tw_f,  \
                                                   tw_i, st)               \
                           : launch_conv<NN, false>(io, batch, m, h, tw_f, \
                                                    tw_i, st));
    switch (n) {
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

// Real rows x (batch, n) fp32, n = 256..16384, 8-byte aligned, against
// m >= 1 packed half responses h (m, n/2) -> y (m, batch, n).  tw_f, tw_i:
// W_L^{-+m}, m < L (L = n/2); split: W_n^k, k < L; h, the tables: float32
// (re, im) pairs, or float64 when exact != 0.  Returns a cudaError_t.
int smfft_conv_real(const void* x, void* y, int64_t batch, int64_t n, int m,
                    const void* h, const void* tw_f, const void* tw_i,
                    const void* split, int exact, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (m < 1) return (int)cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(LL)                                                       \
    case 2 * LL:                                                             \
        return (int)(exact ? launch_conv_real<LL, true>(xf, yf, batch, m, h, \
                                                        tw_f, tw_i, split,   \
                                                        st)                  \
                           : launch_conv_real<LL, false>(xf, yf, batch, m,   \
                                                         h, tw_f, tw_i,      \
                                                         split, st));
    switch (n) {
        SMFFT_CASE(128)
        SMFFT_CASE(256)
        SMFFT_CASE(512)
        SMFFT_CASE(1024)
        SMFFT_CASE(2048)
        SMFFT_CASE(4096)
        SMFFT_CASE(8192)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef SMFFT_CASE
}

}  // extern "C"
