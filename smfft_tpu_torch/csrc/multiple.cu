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
// traffic.  What the loops spend besides the arithmetic is shared memory
// (a few round trips a transform) and the barriers between stages.  The
// design is the reference's (one FFT per block, resident on chip across
// NREUSES applications) on the Hopper core of hcore.cuh:
//   * the row kernels' block (RowGeometry, as c2c.cu and the R2C kernel of
//     real.cu have it, at their own warps an SM below): F rows of TPF
//     threads, thread t holding the points t + s*TPF of its row in
//     registers, the radix-16 ladder through padded conflict-free slots,
//     the stage table with the anchored powers W^(4k) filled once a block,
//     outside the loop (every transform of a call has the same direction;
//     the real loop's inverse reads the forward table conjugated);
//   * C2C natural hand-off (the pencil form, and fft_planar's last
//     hand-off before a revblock-in final transform): the core returns
//     natural order in the register layout it reads, so the output of one
//     transform is the input of the next, with no shared-memory hand-off;
//     1/sqrt(N) multiplies the last stage's unrounded outputs.  The last
//     transform runs after the loop, so that nothing the loop does not
//     need stays live in it (with the last transform in the loop, fp32
//     spilled 52-64 bytes at N = 512-4096 and 344 at 16384, and ran 5-10 %
//     slower; out of it 0, and 4 at 16384);
//   * C2C revblock hand-off (fft_planar's fb_rev: position k2*128 + k1
//     holds bin k1*C + k2, read back as natural input): the last stage's
//     epilogue stores point k times 1/sqrt(N) at its position in the
//     staging (RowGeometry::stage(revblock_pos(k))), one barrier, each
//     thread reads its next points t + s*TPF by position: one shared round
//     trip a transform, conflict-free on both sides;
//   * the output stores natural order straight from the registers, or
//     revblock order through the same staging, as c2c.cu does;
//   * the real round trip: the forward L-point transform's last stage
//     stores Z into the row's buffer in natural order, unpadded (a warp's
//     mirror reads L-k run one off the padding's blocks of 16); one
//     barrier; one thread a pair (k, L-k) splits and at once merges in
//     place, W_n^k from a block table in shared memory filled once; one
//     barrier; the inverse transform starts from the unpadded row
//     (Core::run_smem, its middle stages between the row's two buffers)
//     and returns natural z in the registers, which are the next forward
//     transform's input.  No whole-row store and reload;
//   * "exact" C2C keeps the registers between transforms in the storage
//     type (double2 up to N = 8192), as the shared memory.
// Separate __global__s from c2c.cu and real.cu, so the single-pass kernels'
// code is untouched.  Offsets are 64-bit; the ragged tail of the batch is
// masked; the launchers return cudaGetLastError() right after the launch.

#include "hcore.cuh"
#include "real_pair.cuh"

namespace {

using namespace smfft;

// The blocks an SM (ptxas and the H100, models/hcore.py REUSE_WARPS):
// the C2C loop takes c2c.cu's block, 24 warps an SM for fp32 (80
// registers, no spills; 16 warps measured no faster), the real loop the
// R2C kernel's at 24 warps (two buffers a row, 80-104 registers, no
// spills: at the R2C kernel's 32, in place, 64 registers spilled 24-48
// bytes and ran 5-6 % slower)
template <int N, bool EXACT>
using C2cGeometry = hc::RowGeometry<N, EXACT, 24>;
template <int L>
using RealGeometry = hc::RowGeometry<L, false, 24>;

// the real loop's block: RealGeometry's rows and stage table, then W_n^k
// for k <= L/2; the blocks an SM are RealGeometry's where they still fit
template <int L>
struct RealLoop {
    using G = RealGeometry<L>;
    static constexpr size_t SMEM =
        G::SMEM + (L / 2 + 1) * sizeof(typename G::C);
    static constexpr int FIT = (int)(233472 / (SMEM + 1024));
    static constexpr int MINB = G::MINB < FIT ? G::MINB : FIT;
};

template <int N, bool EXACT>
__global__ void __launch_bounds__(C2cGeometry<N, EXACT>::THREADS,
                                  C2cGeometry<N, EXACT>::MINB)
c2c_multiple_kernel(Io io, int64_t batch, int inverse, int loops,
                    int fb_rev, int last_rev, int out_rev, float first_scale,
                    double loop_scale,
                    const typename C2cGeometry<N, EXACT>::C* __restrict__ tw) {
    using G = C2cGeometry<N, EXACT>;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, THREADS = G::THREADS, CB = G::CB;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + G::F * G::BUF);
    Core::fill(tab, tw, threadIdx.x, THREADS);
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;
    const T sg = inverse ? T(1) : T(-1);

    // the points t + s*TPF of this row times the first scale
    S u[E];
    {
        const int64_t r = (int64_t)blockIdx.x * G::F + f;  // this row
        const bool live = r < batch;
        const T fs = T(first_scale);
#pragma unroll
        for (int s = 0; s < E; ++s) {
            const C v = as<C>(live ? io.load(r * N + t + s * TPF)
                                   : make_float2(0.0f, 0.0f));
            put(u[s], cmake(v.x * fs, v.y * fs));
        }
    }

    // the first `loops` transforms, each times 1/sqrt(N) and handed to the
    // next in the registers (natural) or through the staging (revblock)
    const T ls = T(loop_scale);
    for (int it = 0; it < loops; ++it) {
        if (CB > 1 && (it + 1 == loops ? last_rev : fb_rev)) {
            S* d = Core::run_regs_out(
                u, a, b, t, tab, false, sg, [&](S* dd, int k, C v) {
                    put(dd[G::stage(revblock_pos(k, CB))],
                        cmake(v.x * ls, v.y * ls));
                });
            // the revblock row read back as natural input
#pragma unroll
            for (int s = 0; s < E; ++s) u[s] = d[G::stage(t + s * TPF)];
            // the next first stage writes a
            if (!G::PP || Core::LAST_READS_B) __syncthreads();
        } else {
            Core::template run_regs<false, false>(
                u, a, b, t, tab, false, sg,
                [&](int, C v) { return cmake(v.x * ls, v.y * ls); });
            // the next first stage writes a, which the last stage read
            if (!Core::LAST_READS_B) __syncthreads();
        }
    }

    // the last transform, unscaled: natural out from the registers, or
    // revblock out through the staging, stored by position
    const int64_t first = (int64_t)blockIdx.x * G::F;  // first row
    if (CB == 1 || !out_rev) {
        Core::template run_regs<false, false>(u, a, b, t, tab, false, sg,
                                              [&](int, C v) { return v; });
        if (first + f < batch) {
#pragma unroll
            for (int s = 0; s < E; ++s)
                io.store((first + f) * N + t + s * TPF, as<float2>(u[s]));
        }
        return;
    }
    S* d = Core::run_regs_out(u, a, b, t, tab, false, sg,
                              [&](S* dd, int k, C v) {
                                  put(dd[G::stage(revblock_pos(k, CB))], v);
                              });
    const int off = (int)(d - a);
    const int64_t valid = (batch - first) * N;  // points left
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int e = threadIdx.x + j * THREADS;
        if (e < valid)
            io.store(first * N + e,
                     as<float2>(smem[(e / N) * G::BUF + off +
                                     G::stage(e % N)]));
    }
}

template <int L>
__global__ void __launch_bounds__(RealGeometry<L>::THREADS,
                                  RealLoop<L>::MINB)
real_multiple_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                     int64_t batch, int pairs,
                     const float2* __restrict__ tw_f,
                     const float2* __restrict__ wn) {
    using G = RealGeometry<L>;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, THREADS = G::THREADS;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + G::F * G::BUF);
    C* wk = tab + G::TAB;  // W_n^k, k <= L/2
    Core::fill(tab, tw_f, threadIdx.x, THREADS);
    for (int k = threadIdx.x; k <= L / 2; k += THREADS) wk[k] = __ldg(wn + k);
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;
    const T h = T(0.5) / T(L);  // the merge's scale 1/L, halved

    // z[m] = x[2m] + i x[2m+1]: the real row read as float2, point
    // t + s*TPF in u[s]
    C u[E];
    {
        const int64_t r = (int64_t)blockIdx.x * G::F + f;  // this row
#pragma unroll
        for (int s = 0; s < E; ++s)
            u[s] = r < batch ? __ldg(x + r * L + t + s * TPF)
                             : make_float2(0.0f, 0.0f);
    }

    for (int p = 0;; ++p) {
        // R2C: Z = DFT_L(z), natural order, unpadded, in the row's buffer
        S* z = Core::run_regs_out(u, a, b, t, tab, false, T(-1),
                                  [&](S* d, int k, C v) { put(d[k], v); });
        // split and at once merge, in place: one thread a pair (k, L-k)
#pragma unroll
        for (int j = 0; j < E / 2; ++j) {
            const int k = t + j * TPF;  // 0 <= k < L/2
            if (k == 0) {
                put(z[0], merge_dc(split_dc(as<C>(z[0])), h));
                continue;
            }
            const C w = wk[k];
            C xk, xm, zk, zm;
            split_pair_w(as<C>(z[k]), as<C>(z[L - k]), w, xk, xm);
            merge_pair_w(xk, xm, w, h, zk, zm);
            put(z[k], zk);
            put(z[L - k], zm);
        }
        if (t == 0) {  // the pair k = L/2 is its own mirror
            const C zh = as<C>(z[L / 2]), w = wk[L / 2];
            C xk, xm, zk, zm;
            split_pair_w(zh, zh, w, xk, xm);
            merge_pair_w(xk, xk, w, h, zk, zm);
            put(z[L / 2], zk);
        }
        __syncthreads();
        // C2R: the inverse transform of the unpadded row (the forward
        // table conjugated), natural z into the registers
        Core::template run_smem<false>(z, G::PP && z == a ? b : a, u, t,
                                       tab, true, T(1), T(1),
                                       [&](int, C v) { return v; });
        if (p + 1 == pairs) break;
        // the next forward's first stage writes a, which the last stage
        // read
        __syncthreads();
    }
    // z[m] = (x[2m], x[2m+1]): float2 stores into the real row
    const int64_t r = (int64_t)blockIdx.x * G::F + f;
    if (r < batch) {
#pragma unroll
        for (int s = 0; s < E; ++s) y[r * L + t + s * TPF] = u[s];
    }
}

template <int N, bool EXACT>
cudaError_t launch_c2c(const Io& io, int64_t batch, int inverse, int loops,
                       int fb_rev, int last_rev, int out_rev,
                       float first_scale, double loop_scale, const void* tw,
                       cudaStream_t stream) {
    using G = C2cGeometry<N, EXACT>;
    using C = typename G::C;
    auto kernel = c2c_multiple_kernel<N, EXACT>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, inverse, loops, fb_rev, last_rev, out_rev, first_scale,
        loop_scale, static_cast<const C*>(tw));
    return cudaGetLastError();
}

template <int L>
cudaError_t launch_real(const float* x, float* y, int64_t batch, int pairs,
                        const void* tw_f, const void* wn,
                        cudaStream_t stream) {
    using G = RealGeometry<L>;
    auto kernel = real_multiple_kernel<L>;
    cudaError_t err = allow_smem(kernel, RealLoop<L>::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, RealLoop<L>::SMEM, stream>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
        batch, pairs, static_cast<const float2*>(tw_f),
        static_cast<const float2*>(wn));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// loops + 1 transforms of every row (see the top of this file): the first
// reads its input in natural order times first_scale; hand-off j (j = 1 ..
// loops) stores its spectrum in revblock order when fb_rev (last_rev for
// hand-off `loops`), each later transform's input times loop_scale; the
// output is natural or, with out_rev, revblock.  Data pointers and
// twiddles as smfft_c2c_prepare's (float64 twiddles when exact != 0).  Returns a
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
// forward and inverse W_L^{-+m}, m < L (L = n/2; the kernel reads tw_f
// and conjugates it for the inverse, tw_i is not read); split: W_n^k,
// k < L; all float32 (re, im) pairs.  Returns a cudaError_t (0 on
// success).
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
        return (int)launch_real<LL>(xf, yf, batch, pairs, tw_f, split, \
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
