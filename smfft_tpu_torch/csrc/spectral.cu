// One-sided power spectrum of real rows in one pass: the R2C kernel's
// transform and pair split (real.cu) with the square fused into the split.
// One kernel for Hopper (sm_90a), fp32.
//
// power_kernel replaces the TPU kernel
//   smfft_tpu/ops/spectral.py::_build_power
// and computes, for n = 256..4096 (L = n/2 = 128..2048), real fp32 rows x
// (B, n) and an optional window w (n,),
//     P[k] = |X[k]|^2 for k = 1..L-1,  P[0] = DC^2,   X = rfft(x * w),
// as fp32 rows (B, L).  The Nyquist bin is omitted: the packed slot 0 =
// (DC, Nyquist) leaves it no slot, and spectral searches discard it
// (use rfft where it matters).
//
// What bounds it on the H100: device memory.  A call reads each sample once
// and writes half a float per sample: 6 bytes a sample (4 in, 2 out; the
// window's n floats come from L2), against about 2.5 n log2 n + 8 n flops a
// row, so 2^27 samples move 0.81 GB, 0.24 ms at 3.35 TB/s, against 0.07 ms
// of fp32 operations at n = 4096.  No spectrum reaches device memory.
//
// Design: r2c_kernel's body (Geometry<L>: 16 points a thread, 4096/L
// rows a block, 256 threads) up to the split.  The real row is read as
// float2, z[m] = x[2m] + i x[2m+1], and the window as float2 at the same
// index, multiplied in at the load.  After the L-point transform Z sits in
// shared memory in natural order; one thread per pair (k, L-k) splits it
// (real_pair.cuh) and writes re^2 + im^2 of both bins straight into the
// output row (k = 0 writes DC^2, k = L/2 its one bin), so the split's
// results never go back to shared memory and no barrier follows.  The
// ragged tail of the batch is masked; offsets are 64-bit; the launcher
// returns cudaGetLastError() right after the launch.

#include "real_pair.cuh"
#include "stockham.cuh"

namespace {

using namespace smfft;

template <int L, int TPF, int F, int MINB>
__global__ void __launch_bounds__(TPF * F, MINB)
power_kernel(const float2* __restrict__ x, const float2* __restrict__ win,
             float* __restrict__ out, int64_t batch,
             const float2* __restrict__ tw, const float2* __restrict__ wn) {
    float2* smem = shared_buffer<float2>();
    constexpr int E = L / TPF;  // points per thread
    constexpr int RL = Ladder<L>::RL;
    const int64_t first = (int64_t)blockIdx.x * F;  // first row
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = first + f < batch;
    // this row's first float2 of input, and its first output bin
    const int64_t row = (first + f) * L;
    float2* buf = smem + f * L;

    // z[m] = (x[2m], x[2m+1]) * (w[2m], w[2m+1])
    constexpr int Q0 = E / 8;
    float2 u[Q0][8];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int j = t + q * TPF + r * (L / 8);
            float2 v = live ? __ldg(x + row + j) : make_float2(0.0f, 0.0f);
            if (win) {
                const float2 w = __ldg(win + j);
                v = make_float2(v.x * w.x, v.y * w.y);
            }
            u[q][r] = v;
        }
    first_stage<L, TPF>(u, buf, t, tw, -1.0f, 1.0f);
    middle_stages<L, TPF>(buf, t, tw, -1.0f);
    constexpr int QL = E / RL;
    float2 z[QL][RL];
    last_stage<L, TPF>(buf, t, tw, -1.0f, z);
    __syncthreads();  // every read of the last stage is done
#pragma unroll
    for (int q = 0; q < QL; ++q)
#pragma unroll
        for (int r = 0; r < RL; ++r) buf[t + q * TPF + r * (L / RL)] = z[q][r];
    __syncthreads();  // Z complete, natural order
    if (!live) return;

    // split and square: one thread per pair (k, L-k)
    float* p = out + row;
    for (int k = t; k <= L / 2; k += TPF) {
        const float2 a = buf[k];
        if (k == 0) {
            const float dc = split_dc(a).x;
            p[0] = dc * dc;
            continue;
        }
        float2 xk, xm;
        split_pair(a, buf[L - k], wn, k, xk, xm);
        p[k] = xk.x * xk.x + xk.y * xk.y;
        if (2 * k != L) p[L - k] = xm.x * xm.x + xm.y * xm.y;
    }
}

template <int L>
cudaError_t launch_power(const float* x, const float* win, float* out,
                         int64_t batch, const void* tw, const void* wn,
                         cudaStream_t stream) {
    using G = Geometry<L>;
    auto kernel = power_kernel<L, G::TPF, G::F, G::MINB>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        reinterpret_cast<const float2*>(x),
        reinterpret_cast<const float2*>(win), out, batch,
        static_cast<const float2*>(tw), static_cast<const float2*>(wn));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Real rows x (batch, n) fp32, n = 256..4096, 8-byte aligned, and an
// optional window (n,) fp32 (null: none) -> power rows out (batch, n/2)
// fp32: out[k] = |X[k]|^2, out[0] = DC^2.  twiddles: W_L^m, m < L
// (L = n/2); split: W_n^k, k < L; both float32 (re, im) pairs.  Returns a
// cudaError_t (0 on success).
int smfft_power(const void* x, const void* window, void* out, int64_t batch,
                int64_t n, const void* twiddles, const void* split,
                void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(window);
    float* of = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(LL)                                                  \
    case 2 * LL:                                                        \
        return (int)launch_power<LL>(xf, wf, of, batch, twiddles, split, \
                                     st);
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
