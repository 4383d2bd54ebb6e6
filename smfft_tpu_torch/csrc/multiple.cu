// The reuse loops: one load, many transforms in shared memory and
// registers, one store.  Two kernels for Hopper (sm_90a):
//
// c2c_multiple_kernel replaces the TPU kernels
//   smfft_tpu/ops/pallas_c2c.py::_build with multiple_iters = k > 0
//     (fft_planar(multiple_iters=k); fp32 and "exact" instantiations):
//       x_0 = scale * x,  x_{j+1} = A(x_j) / sqrt(N)  (j < k),
//       y = ordered ? DFT(x_k) : A(x_k)          (rev_in = False)
//       y = B(x_k) = DFT(x_{k-1}) / sqrt(N)      (rev_in = True),
//     where A is kernel A's natural -> revblock map (position k2*128 + k1
//     holds bin k1*C + k2, C = N/128; natural for N <= 128) and B its
//     revblock -> natural mirror: each re-application reads the revblock
//     row as if it were natural input;
//   smfft_tpu/ops/pencil.py::_build with iters > 1
//     (multiple_pencil_planar; fp32):  y = (DFT / sqrt(N))^iters x, natural
//     order throughout.
// Both are `loops + 1` transforms with the same direction; the kernel takes
// the scale of the first transform's input, the 1/sqrt(N) of every later
// one, the layout in which each hand-off stores its spectrum (revblock for
// the fft_planar form, natural for the pencil form and for the last
// hand-off before a revblock-in final transform), and the output layout.
//
// real_multiple_kernel replaces smfft_tpu/ops/pencil.py::_build_real_multiple
//   (multiple_real_pencil_planar; fp32, n = 256..4096): `pairs` round trips
//   R2C -> C2R, each C2R scaled by 1/L (L = n/2), so the output equals the
//   input up to rounding.  Between the two halves of a pair the packed
//   spectrum never leaves shared memory: one thread per pair (k, L-k) runs
//   the split and at once the merge (real_pair.cuh), with no barrier
//   between them.
//
// What bounds them on the H100: operations, not bytes.  The data is read
// and written once per call (16 bytes a complex point, 8 a real sample),
// while the work grows with the number of transforms: about 5 N log2 N
// flops per C2C transform and 2.5 n log2 n + 10 n per real pair half, so
// at 100 reuses a call does 100 transforms' work for one transform's
// traffic.  The design is the reference's (one FFT per block, resident in
// shared memory across NREUSES applications): the Stockham core of
// stockham.cuh, with its Geometry, between one load and one store; each
// re-application hands its last stage's registers to the next first stage
// through shared memory (stockham.cuh::handoff), and the 1/sqrt(N) is the
// next first stage's input scale (a multiply; the TPU kernels fold it into
// twiddles, so the two agree to rounding, not bit for bit).  Separate
// __global__s from c2c.cu and real.cu, so the single-pass kernels' code is
// untouched.  Offsets are 64-bit; the ragged tail of the batch is masked;
// the launchers return cudaGetLastError() right after the launch.

#include "real_pair.cuh"
#include "stockham.cuh"

namespace {

using namespace smfft;

template <int N, int TPF, int F, int MINB, typename C, typename S>
__global__ void __launch_bounds__(TPF * F, MINB)
c2c_multiple_kernel(Io io, int64_t batch, int inverse, int loops,
                    int fb_rev, int last_rev, int out_rev, float first_scale,
                    double loop_scale, const C* __restrict__ tw) {
    using T = real_t<C>;
    S* smem = shared_buffer<S>();
    constexpr int THREADS = TPF * F;
    constexpr int E = N / TPF;  // points per thread
    constexpr int CB = N >= 128 ? N / 128 : 1;
    constexpr int RL = Ladder<N>::RL;
    const T s = inverse ? T(1) : T(-1);
    const int64_t first = (int64_t)blockIdx.x * F;  // first transform
    const int64_t valid = (batch - first) * N;      // points left in batch
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

    constexpr int QL = E / RL;
    S w[QL][RL];
    T scale = T(first_scale);
    for (int it = 0;; ++it) {
        first_stage<N, TPF>(u, buf, t, tw, s, scale);
        middle_stages<N, TPF>(buf, t, tw, s);
        last_stage<N, TPF>(buf, t, tw, s, w);
        if (it == loops) break;
        handoff<N, TPF>(buf, t, w, (it + 1 == loops ? last_rev : fb_rev) != 0,
                        u);
        scale = T(loop_scale);
    }

    if (!out_rev) {
        if (live) {
#pragma unroll
            for (int q = 0; q < QL; ++q)
#pragma unroll
                for (int r = 0; r < RL; ++r)
                    io.store(row + t + q * TPF + r * (N / RL),
                             as<float2>(w[q][r]));
        }
        return;
    }
    __syncthreads();  // every read of the last stage is done
#pragma unroll
    for (int q = 0; q < QL; ++q)
#pragma unroll
        for (int r = 0; r < RL; ++r)
            buf[t + q * TPF + r * (N / RL)] = w[q][r];
    __syncthreads();
    float2 v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int e = threadIdx.x + j * THREADS;
        put(v[j], smem[(e / N) * N + revblock_index(e % N, CB)]);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int e = threadIdx.x + j * THREADS;
        if (e < valid) io.store(first * N + e, v[j]);
    }
}

template <int L, int TPF, int F, int MINB, typename C, typename S>
__global__ void __launch_bounds__(TPF * F, MINB)
real_multiple_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                     int64_t batch, int pairs, const C* __restrict__ tw_f,
                     const C* __restrict__ tw_i, const C* __restrict__ wn) {
    using T = real_t<C>;
    S* smem = shared_buffer<S>();
    constexpr int E = L / TPF;  // points per thread
    constexpr int RL = Ladder<L>::RL;
    const int64_t first = (int64_t)blockIdx.x * F;  // first row
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = first + f < batch;
    const int64_t row = (first + f) * L;  // this row's first float2
    S* buf = smem + f * L;
    const T h = T(0.5) / T(L);  // the merge's scale 1/L, halved

    // z[m] = x[2m] + i x[2m+1]: the real row read as float2
    constexpr int Q0 = E / 8;
    S u[Q0][8];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r)
            put(u[q][r], live ? __ldg(x + row + t + q * TPF + r * (L / 8))
                              : make_float2(0.0f, 0.0f));

    constexpr int QL = E / RL;
    S w[QL][RL];
    for (int p = 0;; ++p) {
        // R2C: the forward L-point transform, Z natural in buf
        first_stage<L, TPF>(u, buf, t, tw_f, T(-1), T(1));
        middle_stages<L, TPF>(buf, t, tw_f, T(-1));
        last_stage<L, TPF>(buf, t, tw_f, T(-1), w);
        __syncthreads();  // every read of the last stage is done
#pragma unroll
        for (int q = 0; q < QL; ++q)
#pragma unroll
            for (int r = 0; r < RL; ++r) buf[t + q * TPF + r * (L / RL)] = w[q][r];
        __syncthreads();

        // split and merge in place, one thread per pair (k, L-k)
        for (int k = t; k <= L / 2; k += TPF) {
            const C a = as<C>(buf[k]);
            if (k == 0) {
                put(buf[0], merge_dc(split_dc(a), h));
                continue;
            }
            C xk, xm, zk, zm;
            split_pair(a, as<C>(buf[L - k]), wn, k, xk, xm);
            merge_pair(xk, 2 * k == L ? xk : xm, wn, k, h, zk, zm);
            put(buf[k], zk);
            if (2 * k != L) put(buf[L - k], zm);
        }
        __syncthreads();

        // C2R: the inverse L-point transform
        load_first<L, TPF>(buf, t, u);
        __syncthreads();
        first_stage<L, TPF>(u, buf, t, tw_i, T(1), T(1));
        middle_stages<L, TPF>(buf, t, tw_i, T(1));
        last_stage<L, TPF>(buf, t, tw_i, T(1), w);
        if (p + 1 == pairs) break;
        handoff<L, TPF>(buf, t, w, false, u);
    }
    // z[m] = (x[2m], x[2m+1]): float2 stores into the real row
    if (live) {
#pragma unroll
        for (int q = 0; q < QL; ++q)
#pragma unroll
            for (int r = 0; r < RL; ++r)
                y[row + t + q * TPF + r * (L / RL)] = as<float2>(w[q][r]);
    }
}

template <int N, bool EXACT>
cudaError_t launch_c2c(const Io& io, int64_t batch, int inverse, int loops,
                       int fb_rev, int last_rev, int out_rev,
                       float first_scale, double loop_scale, const void* tw,
                       cudaStream_t stream) {
    using G = Geometry<N, EXACT>;
    using C = typename G::C;
    auto kernel =
        c2c_multiple_kernel<N, G::TPF, G::F, G::MINB, C, typename G::S>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, inverse, loops, fb_rev, last_rev, out_rev, first_scale,
        loop_scale, static_cast<const C*>(tw));
    return cudaGetLastError();
}

template <int L>
cudaError_t launch_real(const float* x, float* y, int64_t batch, int pairs,
                        const void* tw_f, const void* tw_i, const void* wn,
                        cudaStream_t stream) {
    using G = Geometry<L, false>;
    using C = typename G::C;
    auto kernel =
        real_multiple_kernel<L, G::TPF, G::F, G::MINB, C, typename G::S>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
        batch, pairs, static_cast<const C*>(tw_f),
        static_cast<const C*>(tw_i), static_cast<const C*>(wn));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// loops + 1 transforms of every row (see the top of this file): the first
// reads its input in natural order times first_scale; hand-off j (j = 1 ..
// loops) stores its spectrum in revblock order when fb_rev (last_rev for
// hand-off `loops`), each later transform's input times loop_scale; the
// output is natural or, with out_rev, revblock.  Data pointers and
// twiddles as smfft_c2c's (float64 twiddles when exact != 0).  Returns a
// cudaError_t (0 on success).
int smfft_c2c_multiple(const void* in_re, const void* in_im, void* out_re,
                       void* out_im, int interleaved, int64_t batch,
                       int64_t n, int inverse, int loops, int fb_rev,
                       int last_rev, int out_rev, float first_scale,
                       double loop_scale, const void* twiddles, int exact,
                       void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (loops < 0) return (int)cudaErrorInvalidValue;
    Io io;
    io.in_re = static_cast<const float*>(in_re);
    io.in_im = static_cast<const float*>(in_im);
    io.out_re = static_cast<float*>(out_re);
    io.out_im = static_cast<float*>(out_im);
    io.interleaved = interleaved != 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(NN)                                                      \
    case NN:                                                                \
        return (int)(exact ? launch_c2c<NN, true>(io, batch, inverse, loops, \
                                                  fb_rev, last_rev, out_rev, \
                                                  first_scale, loop_scale,   \
                                                  twiddles, st)              \
                           : launch_c2c<NN, false>(                          \
                                 io, batch, inverse, loops, fb_rev,          \
                                 last_rev, out_rev, first_scale,             \
                                 loop_scale, twiddles, st));
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

// `pairs` >= 1 round trips R2C -> C2R (scaled by 1/L) of real rows x
// (batch, n) fp32, n = 256..4096, 8-byte aligned, into y.  tw_f, tw_i: the
// forward and inverse W_L^{-+m}, m < L (L = n/2); split: W_n^k, k < L;
// all float32 (re, im) pairs.  Returns a cudaError_t (0 on success).
int smfft_real_multiple(const void* x, void* y, int64_t batch, int64_t n,
                        int pairs, const void* tw_f, const void* tw_i,
                        const void* split, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (pairs < 1) return (int)cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(LL)                                                   \
    case 2 * LL:                                                         \
        return (int)launch_real<LL>(xf, yf, batch, pairs, tw_f, tw_i,    \
                                    split, st);
    switch (n) {
        SMFFT_CASE(128)
        SMFFT_CASE(256)
        SMFFT_CASE(512)
        SMFFT_CASE(1024)
        SMFFT_CASE(2048)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef SMFFT_CASE
}

}  // extern "C"
