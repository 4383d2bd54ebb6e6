// Batched fp32 real transforms (R2C and C2R), n = 64..16384, two
// shared-memory kernels for Hopper (sm_90a), each in an fp32 and an
// "exact" (fp64 arithmetic) instantiation.
//
// The R2C kernel replaces the TPU kernels
//   smfft_tpu/ops/pallas_real.py::_build_rfft      (fused R2C, revblock or
//                                                   natural packed output)
//   smfft_tpu/ops/pencil.py::_build_real           (forward: natural R2C,
//                                                   n <= 2048)
//   smfft_tpu/ops/real_direct.py::_build_rfft_pair (natural R2C, n >= 4096)
//   smfft_tpu/ops/real_direct.py::_build_rfft_direct (single-row R2C)
// and the C2R kernel replaces
//   smfft_tpu/ops/pallas_real.py::_build_irfft     (fused C2R, revblock or
//                                                   natural packed input)
//   smfft_tpu/ops/pencil.py::_build_real           (inverse: n <= 1024)
//   smfft_tpu/ops/real_direct.py::_build_irfft_pair, _build_irfft_pair2
//                                                  (natural C2R, n >= 2048)
//   smfft_tpu/ops/real_direct.py::_build_irfft_direct (single-row C2R).
// Those TPU kernels differ only in how the TPU routes the data (lane
// deinterleave, pencil planes, pair rows); they compute two functions:
//
//   R2C: real x (B, n) -> packed half spectrum X (B, L), L = n/2,
//        X[k] = sum_m x[m] W_n^{mk} for k = 1..L-1, slot 0 = (DC, Nyquist);
//   C2R: packed X (B, L) -> scale * L * irfft(X) (B, n), the reference's
//        raw contract at scale 1 (SMFFT_Stockham_R2C_C2R/FFT.c:170-171).
//
// The half-size trick (reference FFT-GPU-32bit-Stockham.cu:269-344): a real
// row of n fp32 values read as L float2 *is* z[m] = x[2m] + i x[2m+1], so
// the even/odd deinterleave costs nothing (natural complex input, coalesced
// float2 loads).  Z = DFT_L(z), and with W = W_n = exp(-2 pi i / n),
//   E = (Z[k] + conj Z[L-k]) / 2,  O = -i (Z[k] - conj Z[L-k]) / 2,
//   X[k] = E + W^k O,  X[L-k] = conj(E - W^k O),  slot 0 = (Re+Im, Re-Im) Z0.
// The inverse merge of the pair (k, L-k), with the scale folded in:
//   E = s (X[k] + conj X[L-k]) / 2,  O = s (X[k] - conj X[L-k]) W^-k / 2,
//   Z[k] = E + i O,  Z[L-k] = conj(E - i O),
//   Z[0] = s ((DC + Nyq) / 2, (DC - Nyq) / 2),
// then an inverse L-point transform whose output z[m] is (x[2m], x[2m+1]).
//
// What bounds them on the H100: 8 bytes per real sample (4 in, 4 out; the
// numpy layout writes one extra complex bin a row), against about
// 2.5 n log2 n flops a row, so both kernels are bound by device memory
// bandwidth: 2^27 real samples move 1.07 GB, 0.32 ms at 3.35 TB/s.  As in
// c2c.cu, one read and one write of device memory per call; the transform,
// the split and the merge stay in shared memory and registers.
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
//   * C2R, on the Stockham core of stockham.cuh with its block Geometry at
//     N = L: E = 16 points per thread, F = 4096/L rows per block for L <=
//     2048, 256 threads (512 at L = 8192).  The block loads its rows,
//     coalesced, from any of the four layouts into shared memory at their
//     logical bin (revblock through the index map; the numpy layout's DC
//     and Nyquist real parts into slot 0, their imaginary parts ignored).
//     After a barrier one thread per pair runs the merge in place; after a
//     second the inverse stages run, and the last writes float2 straight
//     into the real output row: the even/odd re-interleave, coalesced and
//     free.
//   * Tables from the host, computed in float64 and rounded once: the
//     L-point stage twiddles (params.twiddle_table; R2C's block table
//     keeps W^k and the anchors W^(4k) as c2c.cu's does, C2R reads one
//     entry an operand) and W_n^k, k < L (params.real_split_table).  W^-k is the conjugate, W^{L-k} is
//     -conj(W^k): exact, so one table serves both kernels and both halves
//     of a pair.
//   * "exact": fp64 arithmetic, tables and shared memory (R2C: 139 KB
//     padded at L = 8192); the output's rounding to fp32 is the only one.
//   * The launchers return cudaGetLastError() right after the launch.

#include "hcore.cuh"
#include "real_pair.cuh"

namespace {

using namespace smfft;

// Layouts of the spectrum in device memory (ops/real.py numbers them the
// same way).
enum Layout : int { PLANAR = 0, PLANAR_REV = 1, PACKED = 2, NUMPY = 3 };

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

template <int L, int TPF, int F, int MINB, typename C, typename S>
__global__ void __launch_bounds__(TPF * F, MINB)
c2r_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
           int layout, float2* __restrict__ y, int64_t batch, float scale,
           const C* __restrict__ tw, const C* __restrict__ wn) {
    using T = real_t<C>;
    S* smem = shared_buffer<S>();
    constexpr int THREADS = TPF * F;
    constexpr int E = L / TPF;  // points per thread
    constexpr int CB = L >= 128 ? L / 128 : 1;
    constexpr int RL = Ladder<L>::RL;
    const int64_t first = (int64_t)blockIdx.x * F;  // first row
    const int64_t rows_left = batch - first;
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const bool live = f < rows_left;
    const int64_t row = (first + f) * L;  // this row's first output float2
    S* buf = smem + f * L;

    // load the block's rows into shared memory at their logical bins;
    // rows past the batch are zeros
    if (layout == NUMPY) {
        const float2* src =
            reinterpret_cast<const float2*>(in_re) + first * (L + 1);
        for (int e = threadIdx.x; e < F * (L + 1); e += THREADS) {
            const int ff = e / (L + 1), k = e - ff * (L + 1);
            const float2 v = ff < rows_left ? __ldg(src + e)
                                            : make_float2(0.0f, 0.0f);
            S* slot = smem + ff * L;
            if (k == 0)
                slot[0].x = v.x;  // DC; its imaginary part is ignored
            else if (k == L)
                slot[0].y = v.x;  // Nyquist, likewise
            else
                put(slot[k], v);
        }
    } else {
        const int64_t valid = rows_left * L;
        float2 v[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            const int64_t g = first * L + e;
            if (e >= valid)
                v[j] = make_float2(0.0f, 0.0f);
            else if (layout == PACKED)
                v[j] = __ldg(reinterpret_cast<const float2*>(in_re) + g);
            else
                v[j] = make_float2(__ldg(in_re + g), __ldg(in_im + g));
        }
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int e = threadIdx.x + j * THREADS;
            const int pos = e % L;
            const int k =
                layout == PLANAR_REV ? revblock_index(pos, CB) : pos;
            put(smem[(e - pos) + k], v[j]);
        }
    }
    __syncthreads();

    // merge: one thread per pair (k, L-k), scale folded in
    const T h = T(0.5) * T(scale);
    for (int k = t; k <= L / 2; k += TPF) {
        const C a = as<C>(buf[k]);
        if (k == 0) {
            put(buf[0], merge_dc(a, h));
            continue;
        }
        C zk, zm;
        merge_pair(a, as<C>(buf[L - k]), wn, k, h, zk, zm);
        put(buf[k], zk);
        if (2 * k != L) put(buf[L - k], zm);
    }
    __syncthreads();

    // inverse L-point transform
    constexpr int Q0 = E / 8;
    S u[Q0][8];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r) u[q][r] = buf[t + q * TPF + r * (L / 8)];
    __syncthreads();
    first_stage<L, TPF>(u, buf, t, tw, T(1), T(1));
    middle_stages<L, TPF>(buf, t, tw, T(1));
    constexpr int QL = E / RL;
    float2 w[QL][RL];
    last_stage<L, TPF>(buf, t, tw, T(1), w);
    // z[m] = (x[2m], x[2m+1]): float2 stores into the real row
    if (live) {
#pragma unroll
        for (int q = 0; q < QL; ++q)
#pragma unroll
            for (int r = 0; r < RL; ++r)
                y[row + t + q * TPF + r * (L / RL)] = w[q][r];
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

template <int L, bool EXACT>
cudaError_t launch_c2r(const float* in_re, const float* in_im, int layout,
                       float* y, int64_t batch, float scale, const void* tw,
                       const void* wn, cudaStream_t stream) {
    using G = Geometry<L, EXACT>;
    using C = typename G::C;
    auto kernel = c2r_kernel<L, G::TPF, G::F, G::MINB, C, typename G::S>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        in_re, in_im, layout, reinterpret_cast<float2*>(y), batch, scale,
        static_cast<const C*>(tw), static_cast<const C*>(wn));
    return cudaGetLastError();
}

}  // namespace

// The half sizes L = n/2 of the real transforms.
#define SMFFT_REAL_SIZES(X) \
    X(32) X(64) X(128) X(256) X(512) X(1024) X(2048) X(4096) X(8192)

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
