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
// flops per transform, so the kernel is bound by device memory bandwidth:
// 2^27 points move 2.1 GB, 0.64 ms at 3.35 TB/s.  The design goal is one
// read and one write of device memory per call: the whole transform stays
// in shared memory and registers between the load and the store, as in
// the reference's one-FFT-per-thread-block design, and the in-block work
// has to keep up with the memory.
//
// Design, on the Hopper core of hcore.cuh (RowGeometry gives the block):
//   * F rows a block of TPF = N/E threads each, E = 16 points a thread (32
//     at N = 16384): 256 threads up to N = 4096, F = 128 / 64 rows at N =
//     32 / 64 (the reference's 4x32 / 2x64 packing; the API keeps its batch
//     rule, the kernel masks any ragged tail), one row of 512 threads at
//     8192 and 16384;
//   * the radix-16 ladder of hcore.cuh: two exchanges through shared
//     memory at N = 1024 and 4096 (the radix-8 ladder of stockham.cuh took
//     three), three at 16384; padded slots (one element in 16) keep every
//     access at the minimum wavefronts;
//   * 24 warps an SM for fp32 (3 blocks of 256 threads, 80 registers, no
//     spills; at 32 warps the 64-register cap spilled 100-128 bytes), two
//     buffers a row (one barrier a stage) where those blocks still fit
//     (N = 64..8192), else one in place;
//   * natural input goes from device memory straight into the registers
//     the first stage takes (thread t holds points t + s*TPF: coalesced),
//     natural output from the last stage's registers straight back; the
//     scale multiplies the last stage's unrounded outputs;
//   * revblock layouts (N >= 256; natural order below) are staged through
//     the row's buffer with the index map: a warp stores or loads
//     consecutive positions (coalesced), a thread takes or gives its
//     logical points, and RowGeometry::stage's padding keeps both sides at
//     the minimum wavefronts.  Revblock output comes straight from the
//     last stage's epilogue into the staging (Core::run_regs_out);
//   * the stage twiddles come from the block's table in shared memory,
//     filled once a block from the direction's W_N table (computed in
//     float64 and rounded once on the host, params.twiddle_table; no
//     __sinf / fast math); the radix-16 and radix-8 stages keep W^(4k)
//     beside W^k, so every power W^(rk) is at most three products from
//     two table entries (on the H100, products four deep from one had 3x
//     the stockham kernel's fp32 error; each power read from the W_N table
//     in device memory matched it but took 1.20-1.26 ms for 2^27 points
//     at N = 4096 against 0.84);
//   * N = 8192 and 16384 run one block of 512 threads (16 warps) an SM:
//     at 16384 the padded row alone is 136 KB (139264 bytes), so a second
//     block cannot fit (a cluster of two blocks
//     splitting the row over distributed shared memory is the way past
//     it, not taken here); the block holds 32 points a thread in place;
//   * shared memory above 48 KB is dynamic only, after
//     cudaFuncSetAttribute(MaxDynamicSharedMemorySize), which
//     smfft_c2c_prepare sets once a plan (a device); smfft_c2c_run returns
//     cudaGetLastError() right after the launch;
//   * two data layouts, chosen by a runtime flag: interleaved complex64
//     (one float2 load or store per point; the complex API hands over its
//     tensor with no conversion pass) or two contiguous fp32 planes (the
//     planar API);
//   * offsets into the batch are 64-bit: batch * N reaches past 2^31
//     floats at the working sizes (2^27 points per plane);
//   * the precision tier "exact" (<= 2 ulp of max|X|) has its own
//     instantiation: butterflies and twiddle products in fp64 registers
//     from an fp64 twiddle table, fp64 shared memory up to N = 8192 (139 KB
//     padded), fp32 at 16384.  Input and output are fp32, so the registers
//     between the load, the stages and the store hold float2 in both
//     tiers.  Every other tier runs the fp32 instantiation.
//
// Templated on N and the tier (the reference's static size switch);
// layouts, direction and scale are runtime arguments.

#include "hcore.cuh"

namespace {

using namespace smfft;

// 24 warps an SM: at 32 (64 registers a thread) ptxas spills 100-128 bytes
template <int N, bool EXACT>
using RowGeometry = hc::RowGeometry<N, EXACT, 24>;

template <int N, bool EXACT>
__global__ void __launch_bounds__(RowGeometry<N, EXACT>::THREADS,
                                  RowGeometry<N, EXACT>::MINB)
c2c_kernel(Io io, int64_t batch, int inverse, int in_rev, int out_rev,
           float scale,
           const typename RowGeometry<N, EXACT>::C* __restrict__ tw) {
    using G = RowGeometry<N, EXACT>;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, THREADS = G::THREADS;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + G::F * G::BUF);
    Core::fill(tab, tw, threadIdx.x, THREADS);
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const int64_t first = (int64_t)blockIdx.x * G::F;  // first row
    const int64_t valid = (batch - first) * N;         // points left
    const bool live = first + f < batch;
    const int64_t row = (first + f) * N;  // this row's first point
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;
    const T sg = inverse ? T(1) : T(-1);
    const T sc = T(scale);
    const bool rin = G::CB > 1 && in_rev, rout = G::CB > 1 && out_rev;

    // the points t + s*TPF of this row, as the first stage takes them
    float2 u[E];
    if (!rin) {
#pragma unroll
        for (int s = 0; s < E; ++s)
            u[s] = live ? io.load(row + t + s * TPF)
                        : make_float2(0.0f, 0.0f);
    } else {
        // coalesced by position into the staging, then by logical point
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            u[j] = e < valid ? io.load(first * N + e)
                             : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            put(smem[(e / N) * G::BUF + G::stage(e % N)], u[j]);
        }
        __syncthreads();
        // fp32 input values: exact in either storage type
#pragma unroll
        for (int s = 0; s < E; ++s)
            put(u[s], a[G::stage(revblock_pos(t + s * TPF, G::CB))]);
        __syncthreads();
    }

    if (!rout) {
        // the last stage's outputs times the scale, unrounded, into u
        Core::template run_regs<false, false>(
            u, a, b, t, tab, false, sg,
            [&](int, C v) { return cmake(v.x * sc, v.y * sc); });
        if (live) {
#pragma unroll
            for (int s = 0; s < E; ++s) io.store(row + t + s * TPF, u[s]);
        }
        return;
    }
    // revblock out: each output point k times the scale into the staging
    // at its position, then stored by position
    S* dst = Core::run_regs_out(
        u, a, b, t, tab, false, sg, [&](S* d, int k, C v) {
            put(d[G::stage(revblock_pos(k, G::CB))],
                cmake(v.x * sc, v.y * sc));
        });
    const int off = (int)(dst - a);
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int e = threadIdx.x + j * THREADS;
        if (e < valid)
            io.store(first * N + e,
                     as<float2>(smem[(e / N) * G::BUF + off +
                                     G::stage(e % N)]));
    }
}

// A launch of c2c_kernel for one (N, tier, layout, direction, orders),
// worked out once by smfft_c2c_prepare and run by smfft_c2c_run: the
// instantiation's launcher and the arguments every launch repeats.
struct C2cPlan {
    cudaError_t (*run)(const C2cPlan& plan, const Io& io, int64_t batch,
                       float scale, cudaStream_t stream);
    const void* twiddles;
    int interleaved;
    int inverse;
    int in_rev;
    int out_rev;
};

template <int N, bool EXACT>
cudaError_t run_plan(const C2cPlan& p, const Io& io, int64_t batch,
                     float scale, cudaStream_t stream) {
    using G = RowGeometry<N, EXACT>;
    using C = typename G::C;
    c2c_kernel<N, EXACT><<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, p.inverse, p.in_rev, p.out_rev, scale,
        static_cast<const C*>(p.twiddles));
    return cudaGetLastError();
}

template <int N, bool EXACT>
cudaError_t prepare_plan(C2cPlan& p) {
    p.run = run_plan<N, EXACT>;
    return allow_smem(c2c_kernel<N, EXACT>, RowGeometry<N, EXACT>::SMEM);
}

}  // namespace

extern "C" {

// The bytes of a plan: the caller owns its storage (8-byte aligned).
int smfft_c2c_plan_bytes(void) { return (int)sizeof(C2cPlan); }

// Fills `plan` for n and the tier, and lets that instantiation take its
// dynamic shared memory on the current device (cudaFuncSetAttribute), so
// call it once per plan under the device that will run it.  Returns a
// cudaError_t (0 on success).  interleaved != 0: complex64 rows (8-byte
// aligned); otherwise two contiguous fp32 planes.  twiddles is W_N^m,
// m < N, as (re, im) float32 pairs, or float64 pairs when exact != 0; it
// has to outlive the plan.
int smfft_c2c_prepare(void* plan, int64_t n, int exact, int interleaved,
                      int inverse, int in_rev, int out_rev,
                      const void* twiddles) {
    C2cPlan& p = *static_cast<C2cPlan*>(plan);
    p.run = nullptr;
    p.twiddles = twiddles;
    p.interleaved = interleaved;
    p.inverse = inverse;
    p.in_rev = in_rev;
    p.out_rev = out_rev;
#define SMFFT_CASE(NN)                                                      \
    case NN:                                                                \
        return (int)(exact ? prepare_plan<NN, true>(p)                      \
                           : prepare_plan<NN, false>(p));
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

// One launch of a prepared plan on `stream`: y = scale * DFT(x) over
// `batch` contiguous rows (transform b starts at point b*n); in_im and
// out_im are unused for interleaved data.  Returns a cudaError_t.
int smfft_c2c_run(const void* plan, const void* in_re, const void* in_im,
                  void* out_re, void* out_im, int64_t batch, float scale,
                  void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    const C2cPlan& p = *static_cast<const C2cPlan*>(plan);
    Io io;
    io.in_re = static_cast<const float*>(in_re);
    io.in_im = static_cast<const float*>(in_im);
    io.out_re = static_cast<float*>(out_re);
    io.out_im = static_cast<float*>(out_im);
    io.interleaved = p.interleaved != 0;
    return (int)p.run(p, io, batch, scale, static_cast<cudaStream_t>(stream));
}

const char* smfft_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
