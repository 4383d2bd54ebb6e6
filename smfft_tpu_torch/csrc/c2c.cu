// Batched fp32 power-of-two C2C FFT, N = 32..16384, one shared-memory
// kernel for Hopper (sm_90a), in an fp32 and an "exact" (fp64 arithmetic)
// instantiation.
//
// Replaces the TPU kernels smfft_tpu/ops/pallas_c2c.py::_build (kernel A:
// natural -> revblock or natural; kernel B: revblock -> natural; the fused
// runtime scale) and smfft_tpu/ops/pencil.py::_build with iters = 1 (the
// ordered route at N = 256/512/1024).  Both compute
//
//     y = scale * DFT_N^{+-}(x)      batched over rows, unnormalized,
//
// with the input and the output each in natural order or in revblock order
// (position k2*128 + k1 holds element k1*C + k2, C = N/128; for N <= 128
// revblock is natural order).
//
// What bounds it on the H100: every complex point is read once and written
// once (8 bytes in, 8 bytes out; 16 bytes per point), against ~5 N log2 N
// flops per transform, so the kernel is bound by device memory bandwidth.
// The design goal is one read and one write of device memory per call: the
// whole transform stays in shared memory and registers between the load and
// the store, as in the reference's one-FFT-per-thread-block design.
//
// Design:
//   * One transform (F transforms for N <= 2048) per thread block, resident
//     in dynamic shared memory as float2.  TPF = N/E threads serve one
//     transform, E = 16 (32 at N = 16384) points per thread; blocks have
//     256 threads (512 at N >= 8192).  That layout, the register budget
//     and the shared-memory size per tier are stockham.cuh's Geometry,
//     which the real kernels share.
//   * Stockham auto-sort radix-8 stages, closed by one radix-4 or radix-2
//     stage when log2 N is not a multiple of 3.  Each stage reads all of
//     its butterfly inputs into registers, synchronises, and writes its
//     outputs back into the same buffer: the exchange runs in place through
//     registers.  That is what lets N = 16384 fit: the transform alone is
//     128 KB, and a ping-pong pair of buffers (256 KB) would exceed the
//     227 KB a block may use.
//   * Natural-order input feeds the first stage straight from device
//     memory, and the last stage writes natural-order output straight back
//     (both coalesced: butterfly i touches points i + r*N/R).  Revblock
//     layouts are index maps applied while staging through shared memory,
//     so global loads and stores stay coalesced there too.
//   * Every thread issues all E of its loads before it uses any: the
//     memory-level parallelism a streaming kernel needs (one load at a
//     time ran at half the copy rate).  __launch_bounds__ caps registers
//     at 64 a thread so that 4 blocks of 256 threads share an SM.
//   * Shared memory above 48 KB (N >= 8192) is dynamic only, after
//     cudaFuncSetAttribute(MaxDynamicSharedMemorySize); the launcher sets it.
//   * N = 32 / 64: F = 128 / 64 transforms share one block of 256 threads,
//     the analogue of the reference's 4x32 / 2x64 packing.  The API keeps
//     the reference's batch rule ("batch must be a multiple of 128/N"); the
//     kernel itself masks any ragged tail of the batch.
//   * Two data layouts, chosen by a runtime flag: interleaved complex64
//     (one float2 load or store per point; the complex API hands over its
//     tensor with no conversion pass) or two contiguous fp32 planes (the
//     planar API).
//   * Twiddles come from a table W_N^m, m = 0..N-1, computed in float64 and
//     rounded once to fp32 on the host (params.twiddle_table).  No
//     __sinf / fast math.  The radix-8 butterfly's constant sqrt(1/2) is the
//     same fp32 number as the table's W_8.
//   * Offsets into the batch are 64-bit: batch * N reaches past 2^31 floats
//     at the working sizes (2^27 points per plane).
//   * The launcher returns cudaGetLastError() right after the launch, so a
//     launch refused for its shared memory or block size is reported.
//   * The precision tier "exact" (<= 2 ulp of max|X|) has its own
//     instantiation: butterflies and twiddle products in fp64 registers
//     from an fp64 twiddle table, fp64 shared memory where the transform
//     fits (N <= 8192), fp32 shared memory at N = 16384 (128 KB; fp64 would
//     need 256 KB).  Its only fp32 rounding is the output's, plus the
//     stage outputs at N = 16384.  fp64 runs at about half the fp32 rate
//     outside the tensor cores, and the FFT's ~5 N log2 N flops stay below
//     the memory time, so the tier stays memory-bound.  Every other tier
//     runs the fp32 instantiation.
//
// The Stockham core (stockham.cuh) is shared with the real kernels
// (real.cu).  Templated on N and the tier (the reference's static size
// switch); layouts, direction and scale are runtime arguments.

#include "stockham.cuh"

namespace {

using namespace smfft;

// Stockham stages (stockham.cuh).  With natural input the first stage
// reads its butterflies straight from device memory (point i + r*N/8:
// consecutive threads, consecutive addresses), and with natural output
// the last stage writes straight to device memory (point i + r*N/RL);
// revblock layouts are staged through shared memory with the index map.
// Each thread first issues all E of its loads, then computes.
template <int N, int TPF, int F, int MINB, typename C, typename S>
__global__ void __launch_bounds__(TPF * F, MINB)
c2c_kernel(Io io, int64_t batch, int inverse, int in_rev, int out_rev,
           float scale, const C* __restrict__ tw) {
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

    // first stage: radix 8, p = 1, from the E input points a thread holds
    constexpr int Q0 = E / 8;
    float2 u[Q0][8];
    if (!in_rev) {
#pragma unroll
        for (int q = 0; q < Q0; ++q)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                u[q][r] = live ? io.load(row + t + q * TPF + r * (N / 8))
                               : make_float2(0.0f, 0.0f);
    } else {
        // coalesced loads of the block's F*N points, scattered into shared
        // memory at their logical index
        float2 v[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            v[j] = e < valid ? io.load(first * N + e)
                             : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            put(smem[(e / N) * N + revblock_index(e % N, CB)], v[j]);
        }
        __syncthreads();
        // fp32 input values: exact in either storage type
#pragma unroll
        for (int q = 0; q < Q0; ++q)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                put(u[q][r], buf[t + q * TPF + r * (N / 8)]);
        __syncthreads();
    }
    // one first stage for both layouts: an inlined copy per layout changed
    // ptxas's register allocation and cost 2-5 % at N = 1024 / 4096
    first_stage<N, TPF>(u, buf, t, tw, s, T(scale));

    middle_stages<N, TPF>(buf, t, tw, s);

    // last stage: radix RL, p = N / RL, so butterfly i writes point
    // i + r*p
    constexpr int QL = E / RL;
    float2 w[QL][RL];
    last_stage<N, TPF>(buf, t, tw, s, w);
    if (!out_rev) {
        if (live) {
#pragma unroll
            for (int q = 0; q < QL; ++q)
#pragma unroll
                for (int r = 0; r < RL; ++r)
                    io.store(row + t + q * TPF + r * (N / RL), w[q][r]);
        }
        return;
    }
    __syncthreads();  // every read of the last stage is done
#pragma unroll
    for (int q = 0; q < QL; ++q)
#pragma unroll
        for (int r = 0; r < RL; ++r)
            put(buf[t + q * TPF + r * (N / RL)], w[q][r]);
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

template <int N, bool EXACT>
cudaError_t launch(const Io& io, int64_t batch, int inverse, int in_rev,
                   int out_rev, float scale, const void* tw,
                   cudaStream_t stream) {
    using G = Geometry<N, EXACT>;
    using C = typename G::C;
    auto kernel = c2c_kernel<N, G::TPF, G::F, G::MINB, C, typename G::S>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, inverse, in_rev, out_rev, scale,
        static_cast<const C*>(tw));
    return cudaGetLastError();
}

template <int N>
cudaError_t launch_tier(int exact, const Io& io, int64_t batch, int inverse,
                        int in_rev, int out_rev, float scale, const void* tw,
                        cudaStream_t stream) {
    if (exact)
        return launch<N, true>(io, batch, inverse, in_rev, out_rev, scale,
                               tw, stream);
    return launch<N, false>(io, batch, inverse, in_rev, out_rev, scale, tw,
                            stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  interleaved != 0: in_re and
// out_re point at complex64 data (8-byte aligned) and in_im, out_im are
// unused; otherwise the four pointers are contiguous fp32 planes.  Rows are
// contiguous, so transform b starts at point b*n.  twiddles is W_N^m,
// m < N, as (re, im) float32 pairs, or float64 pairs when exact != 0.
int smfft_c2c(const void* in_re, const void* in_im, void* out_re,
              void* out_im, int interleaved, int64_t batch, int64_t n,
              int inverse, int in_rev, int out_rev, float scale,
              const void* twiddles, int exact, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    Io io;
    io.in_re = static_cast<const float*>(in_re);
    io.in_im = static_cast<const float*>(in_im);
    io.out_re = static_cast<float*>(out_re);
    io.out_im = static_cast<float*>(out_im);
    io.interleaved = interleaved != 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(NN)                                                      \
    case NN:                                                                \
        return (int)launch_tier<NN>(exact, io, batch, inverse, in_rev,      \
                                    out_rev, scale, twiddles, st);
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

const char* smfft_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
