// Batched fp32 real-to-complex transforms (R2C), n = 64..16384, one
// shared-memory kernel for Hopper (sm_90a) in an fp32 and an "exact" (fp64
// arithmetic) instantiation.  Its inverse, the C2R kernel, is c2r.cu.
//
// The R2C kernel replaces the TPU kernels
//   smfft_tpu/ops/pallas_real.py::_build_rfft      (fused R2C, revblock or
//                                                   natural packed output)
//   smfft_tpu/ops/pencil.py::_build_real           (forward: natural R2C,
//                                                   n <= 2048)
//   smfft_tpu/ops/real_direct.py::_build_rfft_pair (natural R2C, n >= 4096)
//   smfft_tpu/ops/real_direct.py::_build_rfft_direct (single-row R2C).
// Those TPU kernels differ only in how the TPU routes the data (lane
// deinterleave, pencil planes, pair rows); they compute one function:
//
//   R2C: real x (B, n) -> packed half spectrum X (B, L), L = n/2,
//        X[k] = sum_m x[m] W_n^{mk} for k = 1..L-1, slot 0 = (DC, Nyquist).
//
// The half-size trick (reference FFT-GPU-32bit-Stockham.cu:269-344): a real
// row of n fp32 values read as L float2 *is* z[m] = x[2m] + i x[2m+1], so
// the even/odd deinterleave costs nothing (natural complex input, coalesced
// float2 loads).  Z = DFT_L(z), and with W = W_n = exp(-2 pi i / n),
//   E = (Z[k] + conj Z[L-k]) / 2,  O = -i (Z[k] - conj Z[L-k]) / 2,
//   X[k] = E + W^k O,  X[L-k] = conj(E - W^k O),  slot 0 = (Re+Im, Re-Im) Z0.
//
// What bounds it on the H100: 8 bytes per real sample (4 in, 4 out; the
// numpy layout writes one extra complex bin a row), against about
// 2.5 n log2 n flops a row, so it is bound by device memory bandwidth:
// 2^27 real samples move 1.07 GB, 0.32 ms at 3.35 TB/s.  As in c2c.cu,
// one read and one write of device memory per call; the transform and the
// split stay in shared memory and registers.
//
// Design:
//   * R2C, on the Hopper core of hcore.cuh at M = L (RowGeometry: F rows
//     of TPF = L/16 threads, 256 threads a block up to L = 4096, one row of
//     512 at 8192; padded slots in place; 32 warps an SM, which its 64
//     registers a thread allow without spills: 4 blocks, 2 at L = 8192,
//     against 3 blocks of two buffers, 24 warps, which measured no
//     faster): the real row read as float2 goes straight into the
//     registers the first stage takes (thread t holds z[t + s*TPF]:
//     coalesced), the radix-16 ladder runs (two exchanges at L = 512 and
//     2048, three at 8192; stockham.cuh's radix-8 ladder took three and
//     four), and the last stage's epilogue writes Z in natural order into
//     a free buffer (unpadded: a warp's mirror reads L-k are a run one off
//     the padding's blocks of 16, which unpadded runs do not mind), then
//     one barrier.  One thread a pair (k, L-k), k = t + j*TPF < L/2, reads
//     both, forms X[k] and X[L-k] (real_pair.cuh) and stores them straight
//     to device memory: bins k ascend across a warp and bins L-k descend,
//     so both stores are coalesced segments.  The layouts (runtime flag):
//     packed planar natural (planar.rfft), packed complex64 with slot 0 =
//     DC + i Nyquist (fft_packed_real), numpy complex64 (B, L+1) with DC
//     and Nyquist as real bins (rfft), and packed planar revblock at size L
//     (planar.rfft(ordered=False); position k2*128 + k1 holds bin k1*c +
//     k2, c = L/128, natural for L <= 128), the only one that goes back
//     through shared memory: X in place of Z, into the registers, into
//     the revblock staging (RowGeometry::stage), stored by position.  The
//     ragged tail of the batch is masked; offsets are 64-bit.
//   * Tables from the host, computed in float64 and rounded once: the
//     L-point stage twiddles (params.twiddle_table; the block table keeps
//     W^k and the anchors W^(4k) as c2c.cu's does) and W_n^k, k < L
//     (params.real_split_table).  W^{L-k} is -conj(W^k): exact, so one
//     table serves both halves of a pair, and c2r.cu's merge too.
//   * "exact": fp64 arithmetic, tables and shared memory (139 KB padded
//     at L = 8192); the output's rounding to fp32 is the only one.
//   * The launcher returns cudaGetLastError() right after the launch.

#include "hcore.cuh"
#include "real_pair.cuh"

namespace {

using namespace smfft;

// 32 warps an SM (64 registers a thread, no spills), in place
template <int L, bool EXACT>
using RowGeometry = hc::RowGeometry<L, EXACT, 32>;

template <int L, bool EXACT>
__global__ void __launch_bounds__(RowGeometry<L, EXACT>::THREADS,
                                  RowGeometry<L, EXACT>::MINB)
r2c_kernel(const float2* __restrict__ x, float* __restrict__ out_re,
           float* __restrict__ out_im, int layout, int64_t batch,
           const typename RowGeometry<L, EXACT>::C* __restrict__ tw,
           const typename RowGeometry<L, EXACT>::C* __restrict__ wn) {
    using G = RowGeometry<L, EXACT>;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, THREADS = G::THREADS;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + G::F * G::BUF);
    Core::fill(tab, tw, threadIdx.x, THREADS);
    const int64_t first = (int64_t)blockIdx.x * G::F;  // first row
    const int64_t rows_left = batch - first;
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = f < rows_left;
    const int64_t row = (first + f) * L;  // this row's first float2
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;
    if (G::CB == 1 && layout == PLANAR_REV) layout = PLANAR;

    // z[m] = x[2m] + i x[2m+1]: the real row read as float2, point
    // t + s*TPF in u[s]
    float2 u[E];
#pragma unroll
    for (int s = 0; s < E; ++s)
        u[s] = live ? __ldg(x + row + t + s * TPF) : make_float2(0.0f, 0.0f);
    // Z = DFT_L(z), natural order, unpadded, in a free buffer
    S* z = Core::run_regs_out(u, a, b, t, tab, false, T(-1),
                              [&](S* d, int k, C v) { put(d[k], v); });

    // split: one thread a pair (k, L-k), X[k] and X[L-k] straight to device
    // memory (PLANAR_REV: in place of the pair's Z, staged below)
    float2* const pk = reinterpret_cast<float2*>(out_re);
    float2* const ny = pk + (first + f) * (L + 1);
    auto store = [&](int k, C v) {
        if (layout == PLANAR_REV) {
            put(z[k], v);
        } else if (live) {
            const float2 o = as<float2>(v);
            if (layout == NUMPY) {
                ny[k] = o;
            } else if (layout == PACKED) {
                pk[row + k] = o;
            } else {
                out_re[row + k] = o.x;
                out_im[row + k] = o.y;
            }
        }
    };
#pragma unroll
    for (int j = 0; j < E / 2; ++j) {
        const int k = t + j * TPF;  // 0 <= k < L/2
        const C za = as<C>(z[k]);
        if (k == 0) {
            const C d = split_dc(za);  // (DC, Nyquist)
            if (layout == NUMPY) {
                store(0, cmake(d.x, T(0)));
                store(L, cmake(d.y, T(0)));
            } else {
                store(0, d);
            }
            continue;
        }
        C xk, xm;
        split_pair(za, as<C>(z[L - k]), wn, k, xk, xm);
        store(k, xk);
        store(L - k, xm);
    }
    if (t == 0) {  // the pair k = L/2 is its own mirror
        const C h = as<C>(z[L / 2]);
        C xk, xm;
        split_pair(h, h, wn, L / 2, xk, xm);
        store(L / 2, xk);
    }
    if (layout != PLANAR_REV) return;

    // revblock: X in natural order into the registers, into the staging at
    // its position, stored by position
    __syncthreads();
    S v[E];
#pragma unroll
    for (int s = 0; s < E; ++s) v[s] = z[t + s * TPF];
    __syncthreads();
    const int off = (int)(z - a);
#pragma unroll
    for (int s = 0; s < E; ++s)
        z[G::stage(revblock_pos(t + s * TPF, G::CB))] = v[s];
    __syncthreads();
    const int64_t valid = rows_left * L;  // bins left in the batch
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int e = threadIdx.x + j * THREADS;
        if (e >= valid) break;
        const float2 o =
            as<float2>(smem[(e / L) * G::BUF + off + G::stage(e % L)]);
        out_re[first * L + e] = o.x;
        out_im[first * L + e] = o.y;
    }
}

template <int L, bool EXACT>
cudaError_t launch_r2c(const float* x, float* out_re, float* out_im,
                       int layout, int64_t batch, const void* tw,
                       const void* wn, cudaStream_t stream) {
    using G = RowGeometry<L, EXACT>;
    using C = typename G::C;
    auto kernel = r2c_kernel<L, EXACT>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        reinterpret_cast<const float2*>(x), out_re, out_im, layout, batch,
        static_cast<const C*>(tw), static_cast<const C*>(wn));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Real row x (batch, n) fp32, 8-byte aligned -> its packed half spectrum.
// layout 0/1: out_re, out_im are fp32 planes (batch, n/2), natural or
// revblock; 2: out_re is complex64 (batch, n/2); 3: out_re is complex64
// (batch, n/2 + 1).  twiddles: W_L^m, m < L (L = n/2); split: W_n^k,
// k < L; both float32 (re, im) pairs, or float64 pairs when exact != 0.
// Returns a cudaError_t (0 on success).
int smfft_r2c(const void* x, void* out_re, void* out_im, int layout,
              int64_t batch, int64_t n, const void* twiddles,
              const void* split, int exact, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (layout < PLANAR || layout > NUMPY) return (int)cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    float* o_re = static_cast<float*>(out_re);
    float* o_im = static_cast<float*>(out_im);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(LL)                                                       \
    case 2 * LL:                                                             \
        return (int)(exact ? launch_r2c<LL, true>(xf, o_re, o_im, layout,     \
                                                  batch, twiddles, split, st) \
                           : launch_r2c<LL, false>(xf, o_re, o_im, layout,    \
                                                   batch, twiddles, split,    \
                                                   st));
    switch (n) {
        SMFFT_REAL_SIZES(SMFFT_CASE)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef SMFFT_CASE
}

}  // extern "C"
