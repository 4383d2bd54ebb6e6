// Batched fp32 power-of-two C2C FFT, N = 32..16384, one shared-memory
// kernel for Hopper (sm_90a).
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
//     256 threads (512 at N >= 8192).
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
//
// Templated on N only (the reference's static size switch); layouts,
// direction and scale are runtime arguments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// s * i * a, s = -1 forward, +1 inverse (exact).
__device__ __forceinline__ float2 mul_si(float2 a, float s) {
    return make_float2(-s * a.y, s * a.x);
}

// In-register DFT of R points, natural order in and out, sign s.
template <int R> struct Dft;

template <> struct Dft<2> {
    static __device__ __forceinline__ void run(float2* u, float) {
        const float2 a = u[0], b = u[1];
        u[0] = cadd(a, b);
        u[1] = csub(a, b);
    }
};

template <> struct Dft<4> {
    static __device__ __forceinline__ void run(float2* u, float s) {
        const float2 t0 = cadd(u[0], u[2]), t1 = csub(u[0], u[2]);
        const float2 t2 = cadd(u[1], u[3]);
        const float2 t3 = mul_si(csub(u[1], u[3]), s);
        u[0] = cadd(t0, t2);
        u[1] = cadd(t1, t3);
        u[2] = csub(t0, t2);
        u[3] = csub(t1, t3);
    }
};

template <> struct Dft<8> {
    static __device__ __forceinline__ void run(float2* u, float s) {
        float2 e[4] = {u[0], u[2], u[4], u[6]};
        float2 o[4] = {u[1], u[3], u[5], u[7]};
        Dft<4>::run(e, s);
        Dft<4>::run(o, s);
        const float c = 0.70710678118654752440f;  // fp32(cos(pi/4))
        o[1] = cmul(o[1], make_float2(c, s * c));   // W_8^1
        o[2] = mul_si(o[2], s);                     // W_8^2
        o[3] = cmul(o[3], make_float2(-c, s * c));  // W_8^3
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            u[k] = cadd(e[k], o[k]);
            u[k + 4] = csub(e[k], o[k]);
        }
    }
};

// Twiddle and DFT of one Stockham radix-RS butterfly, in registers.
// p is the length of the sub-transforms already done (1, RS, RS^2, ...);
// butterfly i twiddles its input r by W_N^{r*k*N/(p*RS)}, k = i mod p.
template <int N, int RS>
__device__ __forceinline__ void butterfly(float2 (&u)[RS], int i, int p,
                                          const float2* __restrict__ tw,
                                          float s) {
    if (p > 1) {
        const int k = i & (p - 1);
        const int step = N / (p * RS);
#pragma unroll
        for (int r = 1; r < RS; ++r)
            u[r] = cmul(u[r], __ldg(&tw[r * k * step]));
    }
    Dft<RS>::run(u, s);
}

// Where butterfly i of a stage with sub-length p writes its output r.
__device__ __forceinline__ int stockham_dst(int i, int p, int rs, int r) {
    const int k = i & (p - 1);
    return (i - k) * rs + k + r * p;
}

// One radix-RS stage in place in shared memory: butterfly i reads
// buf[i + r*N/RS], and all reads finish (barrier) before any write.
template <int N, int TPF, int RS>
__device__ __forceinline__ void smem_stage(float2* buf, int t, int p,
                                           const float2* __restrict__ tw,
                                           float s) {
    constexpr int Q = N / TPF / RS;  // butterflies per thread
    constexpr int STRIDE = N / RS;   // butterflies per stage
    float2 u[Q][RS];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int r = 0; r < RS; ++r)
            u[q][r] = buf[t + q * TPF + r * STRIDE];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int i = t + q * TPF;
        butterfly<N, RS>(u[q], i, p, tw, s);
#pragma unroll
        for (int r = 0; r < RS; ++r)
            buf[stockham_dst(i, p, RS, r)] = u[q][r];
    }
    __syncthreads();
}

__host__ __device__ constexpr int ilog2(int n) {
    return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// Logical element stored at position pos of a revblock row.
__device__ __forceinline__ int revblock_index(int pos, int c) {
    return (pos & 127) * c + (pos >> 7);
}

// The kernel's view of the data: point g (64-bit) of the batch, either
// interleaved complex64 (one float2 per point at in_re / out_re) or two
// contiguous fp32 planes.
struct Io {
    const float* __restrict__ in_re;
    const float* __restrict__ in_im;
    float* __restrict__ out_re;
    float* __restrict__ out_im;
    bool interleaved;

    __device__ __forceinline__ float2 load(int64_t g) const {
        if (interleaved)
            return __ldg(reinterpret_cast<const float2*>(in_re) + g);
        return make_float2(__ldg(in_re + g), __ldg(in_im + g));
    }
    __device__ __forceinline__ void store(int64_t g, float2 v) const {
        if (interleaved) {
            reinterpret_cast<float2*>(out_re)[g] = v;
        } else {
            out_re[g] = v.x;
            out_im[g] = v.y;
        }
    }
};

// Stockham stages: a radix-8 first stage (p = 1), radix-8 middle stages,
// and a last stage of radix RL = 8, 4 or 2 (p = N / RL).  With natural
// input the first stage reads its butterflies straight from device memory
// (point i + r*N/8: consecutive threads, consecutive addresses), and with
// natural output the last stage writes straight to device memory (point
// i + r*N/RL); revblock layouts are staged through shared memory with the
// index map.  Each thread first issues all E of its loads, then computes.
template <int N, int TPF, int F, int MINB>
__global__ void __launch_bounds__(TPF * F, MINB)
c2c_kernel(Io io, int64_t batch, int inverse, int in_rev, int out_rev,
           float scale, const float2* __restrict__ tw) {
    extern __shared__ float2 smem[];
    constexpr int THREADS = TPF * F;
    constexpr int E = N / TPF;  // points per thread
    constexpr int C = N >= 128 ? N / 128 : 1;
    constexpr int L = ilog2(N);
    constexpr int R8 = L / 3;
    constexpr int RL = L % 3 == 0 ? 8 : (L % 3 == 2 ? 4 : 2);
    constexpr int MID = L % 3 == 0 ? R8 - 2 : R8 - 1;  // middle stages
    const float s = inverse ? 1.0f : -1.0f;
    const int64_t first = (int64_t)blockIdx.x * F;  // first transform
    const int64_t valid = (batch - first) * N;      // points left in batch
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = first + f < batch;
    const int64_t row = (first + f) * N;  // this transform's first point
    float2* buf = smem + f * N;

    // first stage: radix 8, p = 1
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
            smem[(e / N) * N + revblock_index(e % N, C)] = v[j];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < Q0; ++q)
#pragma unroll
            for (int r = 0; r < 8; ++r)
                u[q][r] = buf[t + q * TPF + r * (N / 8)];
        __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < Q0; ++q) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
            u[q][r] = make_float2(u[q][r].x * scale, u[q][r].y * scale);
        const int i = t + q * TPF;
        butterfly<N, 8>(u[q], i, 1, tw, s);
#pragma unroll
        for (int r = 0; r < 8; ++r) buf[i * 8 + r] = u[q][r];
    }
    __syncthreads();

    int p = 8;
#pragma unroll
    for (int st = 0; st < MID; ++st) {
        smem_stage<N, TPF, 8>(buf, t, p, tw, s);
        p *= 8;
    }

    // last stage: radix RL, p = N / RL, so butterfly i writes point
    // i + r*p
    constexpr int QL = E / RL;
    float2 w[QL][RL];
#pragma unroll
    for (int q = 0; q < QL; ++q)
#pragma unroll
        for (int r = 0; r < RL; ++r)
            w[q][r] = buf[t + q * TPF + r * (N / RL)];
#pragma unroll
    for (int q = 0; q < QL; ++q)
        butterfly<N, RL>(w[q], t + q * TPF, p, tw, s);
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
            buf[t + q * TPF + r * (N / RL)] = w[q][r];
    __syncthreads();
    float2 v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int e = threadIdx.x + j * THREADS;
        v[j] = smem[(e / N) * N + revblock_index(e % N, C)];
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int e = threadIdx.x + j * THREADS;
        if (e < valid) io.store(first * N + e, v[j]);
    }
}

template <int N, int E, int F>
cudaError_t launch(const Io& io, int64_t batch, int inverse, int in_rev,
                   int out_rev, float scale, const float2* tw,
                   cudaStream_t stream) {
    constexpr int TPF = N / E;
    constexpr size_t SMEM = sizeof(float2) * N * F;
    // blocks per SM the register budget must allow: 64 registers a thread
    // (4 blocks of 256, 2 of 512); one block at N = 16384, whose shared
    // memory allows no second
    constexpr int MINB = TPF * F <= 256 ? 4 : (SMEM > 96 * 1024 ? 1 : 2);
    auto kernel = c2c_kernel<N, TPF, F, MINB>;
    if (SMEM > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
        if (err != cudaSuccess) return err;
    }
    const int64_t blocks = (batch + F - 1) / F;
    kernel<<<(unsigned)blocks, TPF * F, SMEM, stream>>>(
        io, batch, inverse, in_rev, out_rev, scale, tw);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  interleaved != 0: in_re and
// out_re point at complex64 data (8-byte aligned) and in_im, out_im are
// unused; otherwise the four pointers are contiguous fp32 planes.  Rows are
// contiguous, so transform b starts at point b*n.
int smfft_c2c(const void* in_re, const void* in_im, void* out_re,
              void* out_im, int interleaved, int64_t batch, int64_t n,
              int inverse, int in_rev, int out_rev, float scale,
              const void* twiddles, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    Io io;
    io.in_re = static_cast<const float*>(in_re);
    io.in_im = static_cast<const float*>(in_im);
    io.out_re = static_cast<float*>(out_re);
    io.out_im = static_cast<float*>(out_im);
    io.interleaved = interleaved != 0;
    const float2* tw = static_cast<const float2*>(twiddles);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(NN, EE, FF)                                              \
    case NN:                                                                \
        return (int)launch<NN, EE, FF>(io, batch, inverse, in_rev, out_rev, \
                                       scale, tw, st);
    switch (n) {
        SMFFT_CASE(32, 16, 128)
        SMFFT_CASE(64, 16, 64)
        SMFFT_CASE(128, 16, 32)
        SMFFT_CASE(256, 16, 16)
        SMFFT_CASE(512, 16, 8)
        SMFFT_CASE(1024, 16, 4)
        SMFFT_CASE(2048, 16, 2)
        SMFFT_CASE(4096, 16, 1)
        SMFFT_CASE(8192, 16, 1)
        SMFFT_CASE(16384, 32, 1)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef SMFFT_CASE
}

const char* smfft_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
