// Fused spectral convolution: forward transform, filter product and
// inverse transform of every row in one kernel, with one read and one
// write of device memory.  Two kernels for Hopper (sm_90a), each in an
// fp32 and an "exact" (fp64 arithmetic) instantiation, and each in a
// single-filter (m = 1) and a filter-bank (m > 1) form; and the complex
// bank's plane form, a third kernel.
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
// conv_plane_kernel replaces no TPU kernel: it is the acceleration
// search's power plane (accel.py) in one launch.  For spectra x (T, L)
// complex64 and m responses (m, n) of k-tap filters it computes
//     P[t, j, b] = |y_tj[(k - 1)/2 + b]|^2,   b < L,
// y_tj the linear convolution of x[t] (zero beyond both ends) with filter
// j, by overlap-save in segments of n = 256..16384 points, hop = n - k + 1,
// ceil(L / hop) segments a trial, float32 (T, m, L).
//
// What bounds them on the H100: device memory.  A call reads each input
// point once and writes each output once: 8 + 8m bytes a complex point,
// 4 + 4m a real sample; against about 5 N log2 N (1 + m) flops a complex
// row, so at m <= 4 the bytes dominate (2^27 points at N = 1024, m = 1:
// 0.64 ms of bytes against 0.20 ms of fp32 operations at the published
// peaks).  The filters (m N complex) are read from L2 by every block.
//
// Design, on the Hopper core of hcore.cuh with the row kernels' block
// (RowGeometry: F rows of TPF threads, thread t holding the points
// t + s*TPF of its row in registers, the radix-16 ladder through padded
// conflict-free slots, the stage table with the anchored powers W^(4k)
// filled once a block; the inverse reads the forward table conjugated, so
// there is one table):
//   * conv_kernel, m = 1: the row goes from device memory straight into
//     the registers the forward core's first stage takes; the forward
//     core's last stage leaves point t + s*TPF in u[s], natural order, so
//     its epilogue multiplies the unrounded point by H[t + s*TPF] (a
//     coalesced __ldg) into the registers that the inverse core's first
//     stage reads.  No hand-off through shared memory: one barrier between
//     the two cores where the forward's last stage read the buffer the
//     inverse's first stage writes (none with two buffers and an odd
//     number of stages), and the inverse's natural output is stored from
//     the registers.  bluestein_kernel (chirp.cu) runs the same pattern;
//   * conv_kernel, m > 1 (its own instantiation, so that the m = 1 form
//     carries no copy of the spectrum): the forward core runs once a row
//     and its spectrum survives the m inverses in registers, E points a
//     thread in the storage type; each inverse starts from the spectrum
//     times H[j] in the registers: ptxas gives the fp32 banks 83-125
//     registers and no spills up to N = 8192 at 16 warps an SM, so no
//     shared memory is spent on it (a third slot a row, for the spectrum,
//     was not tried).  At N = 16384 (E = 32, one block of 512 threads, one
//     139 KB slot) a second slot does not fit beside the stage table in
//     the 227 KB a block may use, so the spectrum stays in registers there
//     as in the old kernel (fp32 spills 164 bytes);
//   * conv_real_kernel: the R2C half-size trick.  The real row read as
//     float2 is z[m] = x[2m] + i x[2m+1]; the forward L-point core's last
//     stage stores Z unpadded into the row's buffer (Core::run_regs_out,
//     as the R2C kernel and real_multiple_kernel do), one barrier; one
//     thread a pair (k, L-k) splits the pair into X[k], X[L-k]
//     (real_pair.cuh), multiplies each by its response and merges the
//     products at scale 1/2 (1/L is in H) back into the same two bins, with
//     no barrier between its reads and writes (no other thread touches the
//     pair); thread 0 of a row takes slot 0 (DC and Nyquist, two real
//     products) and the self-pair k = L/2; W_n^k comes from a block table
//     in shared memory filled once (the "exact" tier at L = 8192 reads it
//     with __ldg: its 139 KB row and 74 KB stage table leave no room).
//     One barrier; the inverse core runs from the unpadded row
//     (Core::run_smem, its middle stages between the row's two buffers
//     where it has two) and returns natural z, which is (y[2m], y[2m+1]):
//     float2 stores straight into the real output row;
//   * conv_real_kernel, m > 1: the split pairs X[k], X[L-k] of each thread
//     stay in registers across the m filters; a barrier before each pair
//     step after the first (the previous inverse read the row);
//   * the blocks an SM: every form at 16 warps an SM (CONV_WARPS; "exact"
//     takes RowGeometry's 16 anyway), 128 registers a thread, which hold
//     the banks' spectrum or split pairs beside the core's registers
//     without spills up to 4096 points a transform; two buffers a row
//     where those blocks still fit with them (RowGeometry::PP);
//   * "exact": fp64 arithmetic, twiddles and responses, fp64 shared memory
//     and registers between the stages up to 8192 points, fp32 storage at
//     N = 16384 (the real kernel's L stops at 8192);
//   * conv_plane_kernel, its own instantiation beside the bank's (so that
//     the bank's callers keep their machine code: its output differs in
//     kind, float power at whole bins against complex segments): the
//     bank's loop (bank_loop, which both call), one forward transform a
//     segment kept in registers across the m inverses, with its own
//     prologue and epilogue.  The
//     prologue reads row r, segment f = r mod S of spectrum i = r / S (S
//     = ceil(L / hop) segments a spectrum), straight from the spectrum:
//     position p from x[i, f*hop + p - left], left = k - 1 - (k - 1)/2,
//     zero outside [0, L); no padded row or frame in device memory.  The
//     epilogue takes each unrounded output of inverse j in the core's
//     last stage (point p = t + s*TPF, natural order) and, for p >= k - 1
//     with bin f*hop + p - (k - 1) < L, stores re^2 + im^2, computed in
//     the tier's precision, as float32 to that bin of plane row (i, j)
//     (the responses are unscaled: the prologue multiplies each point by
//     the inverse's 1/n, exactly),
//     so no complex segment or |y| reaches device memory: consecutive
//     threads store consecutive bins (evict-first, so that the responses
//     stay in L2), a block's rows are consecutive segments (one, of 4
//     warps, from n = 2048 on: ConvPlane), and the ragged last segment of
//     a trial stores only its bins below L.  It moves the segments'
//     reads, the responses from L2 and the plane's 4 bytes a bin and
//     template (6.74 GB for 2 x (2^22 + 1) bins against 201 templates of
//     233 taps at n = 2048, 2.0 ms at peak bandwidth, against 1.74 ms of
//     fp32 operations at peak): its transforms' SM work bounds it (4.66-
//     4.86 ms alone on the H100), the store floor beside it (the bank
//     form would write 15.2 GB of complex segments there);
//   * 64-bit offsets (the output is (m, B, N)); the ragged tail of the
//     batch computes on zeros and stores nothing, and every thread meets
//     every barrier; the launchers return cudaGetLastError() right after
//     the launch.

#include "hcore.cuh"
#include "real_pair.cuh"

namespace {

using namespace smfft;

// The warps an SM the fp32 instantiations aim at (ptxas of 16, 24 and 32,
// and the kernels alone at 16 and 24 in one call on the H100): 16, 128
// registers a thread.
// At 24 (85 registers) the single-filter forms spilled 4 bytes (complex N
// = 2048 / 4096, real L = 512) and the real bank 64-68 bytes; the complex
// single form ran 2-4 % faster there, the real one 0-7 % slower, the real
// bank 10 % slower.  At 32 (64 registers) they spilled 8-120 bytes.
constexpr int CONV_WARPS = 16;

template <int M, bool EXACT>
using ConvGeometry = hc::RowGeometry<M, EXACT, CONV_WARPS>;

// The real kernel's block: ConvGeometry's rows and stage table at M = L,
// then W_n^k for k <= L/2 where it still fits a block's shared memory; the
// blocks an SM are ConvGeometry's where they still fit.
template <int L, bool EXACT>
struct ConvReal {
    using G = ConvGeometry<L, EXACT>;
    static constexpr size_t WK = (L / 2 + 1) * sizeof(typename G::C);
    static constexpr bool WK_SHARED = G::SMEM + WK <= 232448;
    static constexpr size_t SMEM = G::SMEM + (WK_SHARED ? WK : 0);
    static constexpr int FIT = (int)(233472 / (SMEM + 1024));
    static constexpr int MINB = G::MINB < FIT ? G::MINB : FIT;
};

// The bank's loop, which conv_kernel's bank form and its plane form share:
// the forward transform of the row in u once, kept in registers across the
// m inverses.  Inverse j's last stage hands each output point t + s*TPF,
// unrounded, to last(j)(s, v), which returns it; stored(j) follows with
// the outputs in u.
template <class G, class Last, class Stored>
__device__ __forceinline__ void bank_loop(
    typename G::S (&u)[G::E], typename G::S* a, typename G::S* b, int t,
    const typename G::C* tab, int m, const typename G::C* __restrict__ h,
    Last last, Stored stored) {
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, N = E * TPF;
    Core::template run_regs<false, false>(u, a, b, t, tab, false, T(-1),
                                          [](int, C v) { return v; });
    S spec[E];
#pragma unroll
    for (int s = 0; s < E; ++s) spec[s] = u[s];
    for (int j = 0; j < m; ++j) {
        const C* hj = h + (int64_t)j * N;
        // the next first stage writes a, which the last stage read
        if (!Core::LAST_READS_B) __syncthreads();
#pragma unroll
        for (int s = 0; s < E; ++s)
            put(u[s], cmul(as<C>(spec[s]), __ldg(&hj[t + s * TPF])));
        Core::template run_regs<false, false>(u, a, b, t, tab, true, T(1),
                                              last(j));
        stored(j);
    }
}

template <int N, bool EXACT, bool BANK>
__global__ void __launch_bounds__(ConvGeometry<N, EXACT>::THREADS,
                                  ConvGeometry<N, EXACT>::MINB)
conv_kernel(Io io, int64_t batch, int m,
            const typename ConvGeometry<N, EXACT>::C* __restrict__ h,
            const typename ConvGeometry<N, EXACT>::C* __restrict__ tw) {
    using G = ConvGeometry<N, EXACT>;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + G::F * G::BUF);
    Core::fill(tab, tw, threadIdx.x, G::THREADS);
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const int64_t r = (int64_t)blockIdx.x * G::F + f;  // this row
    const bool live = r < batch;
    const int64_t row = r * N;  // this row's first point
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;
    const auto same = [](int, C v) { return v; };

    // the points t + s*TPF of this row
    S u[E];
#pragma unroll
    for (int s = 0; s < E; ++s)
        put(u[s], live ? io.load(row + t + s * TPF)
                       : make_float2(0.0f, 0.0f));

    if constexpr (!BANK) {
        // the forward core; each spectrum point t + s*TPF times H,
        // unrounded, into the registers the inverse core's first stage
        // takes
        Core::template run_regs<false, false>(
            u, a, b, t, tab, false, T(-1),
            [&](int s, C v) { return cmul(v, __ldg(&h[t + s * TPF])); });
        // the inverse's first stage writes a, which the last stage read
        if (!Core::LAST_READS_B) __syncthreads();
        Core::template run_regs<false, false>(u, a, b, t, tab, true, T(1),
                                              same);
        if (live) {
#pragma unroll
            for (int s = 0; s < E; ++s)
                io.store(row + t + s * TPF, as<float2>(u[s]));
        }
    } else {
        bank_loop<G>(u, a, b, t, tab, m, h, [&](int) { return same; },
                     [&](int j) {
                         if (live) {
                             const int64_t out = (int64_t)j * batch * N + row;
#pragma unroll
                             for (int s = 0; s < E; ++s)
                                 io.store(out + t + s * TPF, as<float2>(u[s]));
                         }
                     });
    }
}

// The plane form's block: F = 128 / TPF rows of ConvGeometry's buffers
// and stage table, one from N = 2048 on, where ConvGeometry's block holds
// 256 threads.  Its barriers then hold fewer segments: at N = 2048 one
// segment of 4 warps a block, 4 blocks an SM, ran in 4.82 ms where
// ConvGeometry's 2 segments a block took 5.59, 4 segments 7.15 (the
// cell's 4620 segments x 201 templates alone on the H100).
template <int N, bool EXACT>
struct ConvPlane {
    using G = ConvGeometry<N, EXACT>;
    static constexpr int F = G::TPF >= 128 ? 1 : 128 / G::TPF;
    static constexpr int THREADS = F * G::TPF;
    static constexpr size_t SMEM = (size_t)F * G::BUF * sizeof(typename G::S) +
                                   G::TAB * sizeof(typename G::C);
    static constexpr int BY_SMEM = (int)(233472 / (SMEM + 1024));
    static constexpr int BY_WARPS = CONV_WARPS * 32 / THREADS;
    static constexpr int MINB =
        BY_SMEM < BY_WARPS ? (BY_SMEM > 0 ? BY_SMEM : 1)
                           : (BY_WARPS > 0 ? BY_WARPS : 1);
    static unsigned blocks(int64_t batch) {
        return (unsigned)((batch + F - 1) / F);
    }
};

// The bank's plane form: conv_kernel's bank loop, with the overlap-save
// framing as its prologue and the valid part's power as its epilogue.
// Row r of the launch is segment fr = r % frames of spectrum
// trial = r / frames; it holds x[trial, fr*hop + p - left] at position p
// (zero outside [0, bins)), and after inverse j its points p >= k - 1
// are bins fr*hop + p - (k - 1) of the (trial, j) row of the plane.
template <int N, bool EXACT>
__global__ void __launch_bounds__(ConvPlane<N, EXACT>::THREADS,
                                  ConvPlane<N, EXACT>::MINB)
conv_plane_kernel(const float2* __restrict__ x, float* __restrict__ plane,
                  int64_t batch, int64_t bins, int64_t frames, int k, int m,
                  const typename ConvGeometry<N, EXACT>::C* __restrict__ h,
                  const typename ConvGeometry<N, EXACT>::C* __restrict__ tw) {
    using K = ConvPlane<N, EXACT>;
    using G = typename K::G;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    constexpr int E = G::E, TPF = G::TPF;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + K::F * G::BUF);
    Core::fill(tab, tw, threadIdx.x, K::THREADS);
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const int64_t r = (int64_t)blockIdx.x * K::F + f;  // this segment
    const bool live = r < batch;
    const int64_t trial = r / frames;
    const int64_t first = (r - trial * frames) * (N - k + 1);  // its bin 0
    const int64_t left = k - 1 - (k - 1) / 2;
    // position p reads x[trial, first + p - left] where that lies in
    // [0, bins), and its power is bin first + p - (k - 1) where that lies
    // below bins
    const float2* xs = x + trial * bins + first - left;
    const int64_t in_lo = left - first, in_hi = bins - first + left;
    const int64_t out_hi = bins - first + k - 1;
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;
    // the inverse's 1/N, on the load (a power of two: the products are
    // exact), so that the responses are unscaled
    constexpr float INV = 1.0f / N;

    S u[E];
    unsigned keep = 0;  // bit s: point t + s*TPF is stored
#pragma unroll
    for (int s = 0; s < E; ++s) {
        const int p = t + s * TPF;
        const float2 v = live && p >= in_lo && p < in_hi
                             ? __ldg(xs + p) : make_float2(0.0f, 0.0f);
        put(u[s], make_float2(v.x * INV, v.y * INV));
        keep |= (unsigned)(live && p >= k - 1 && p < out_hi) << s;
    }
    // |y|^2 of each kept point, unrounded, in the tier's precision; stored
    // evict-first, so that the responses stay in L2 (4.65 ms against 4.92
    // with plain stores, and 5.16 with the three compares of each point in
    // place of the mask, at N = 2048)
    bank_loop<G>(u, a, b, t, tab, m, h,
                 [&](int j) {
                     float* out = plane + (trial * m + j) * bins + first -
                                  (k - 1);
                     return [=](int s, C v) {
                         if ((keep >> s) & 1u)
                             __stcs(out + t + s * TPF,
                                    (float)(v.x * v.x + v.y * v.y));
                         return v;
                     };
                 },
                 [](int) {});
}

// Z'[k], Z'[L-k] of the pair (k, L-k), 0 < k <= L/2, from its split X[k],
// X[L-k], their responses hk, hm and w = W_n^k: the products merged at
// scale 1 (h = 1/2; 1/L is in H).  The self-pair k = L/2 passes X[L/2]
// and H[L/2] twice, and stores zk.
template <typename C>
__device__ __forceinline__ void filter_pair(C xk, C xm, C hk, C hm, C w,
                                            C& zk, C& zm) {
    merge_pair_w(cmul(xk, hk), cmul(xm, hm), w, real_t<C>(0.5), zk, zm);
}

// Z'[0] from slot 0 = (DC, Nyquist) and h0 = (Re H[0], Re H[L]): two real
// products, merged at scale 1.
template <typename C>
__device__ __forceinline__ C filter_dc(C d, C h0) {
    return merge_dc(cmake(d.x * h0.x, d.y * h0.y), real_t<C>(0.5));
}

template <int L, bool EXACT, bool BANK>
__global__ void __launch_bounds__(ConvGeometry<L, EXACT>::THREADS,
                                  ConvReal<L, EXACT>::MINB)
conv_real_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                 int64_t batch, int m,
                 const typename ConvGeometry<L, EXACT>::C* __restrict__ h,
                 const typename ConvGeometry<L, EXACT>::C* __restrict__ tw,
                 const typename ConvGeometry<L, EXACT>::C* __restrict__ wn) {
    using K = ConvReal<L, EXACT>;
    using G = typename K::G;
    using C = typename G::C;
    using S = typename G::S;
    using Core = typename G::Core;
    using T = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, THREADS = G::THREADS;
    S* smem = shared_buffer<S>();
    C* tab = reinterpret_cast<C*>(smem + G::F * G::BUF);
    C* wk = tab + G::TAB;  // W_n^k, k <= L/2 (WK_SHARED)
    Core::fill(tab, tw, threadIdx.x, THREADS);
    if (K::WK_SHARED)
        for (int k = threadIdx.x; k <= L / 2; k += THREADS)
            wk[k] = __ldg(wn + k);
    const auto wpow = [&](int k) {
        return K::WK_SHARED ? wk[k] : __ldg(wn + k);
    };
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const int64_t r = (int64_t)blockIdx.x * G::F + f;  // this row
    const bool live = r < batch;
    const int64_t row = r * L;  // this row's first float2
    S* a = smem + f * G::BUF;
    S* b = G::PP ? a + G::SLOT : a;

    // z[m] = x[2m] + i x[2m+1]: the real row read as float2, point
    // t + s*TPF in u[s]
    C u[E];
#pragma unroll
    for (int s = 0; s < E; ++s)
        u[s] = as<C>(live ? __ldg(x + row + t + s * TPF)
                          : make_float2(0.0f, 0.0f));
    // Z = DFT_L(z), natural order, unpadded, in the row's buffer z; the
    // inverse runs its middle stages between z and zb
    S* z = Core::run_regs_out(u, a, b, t, tab, false, T(-1),
                              [&](S* d, int k, C v) { put(d[k], v); });
    S* zb = G::PP && z == a ? b : a;
    // the inverse transform of the row, natural z into the registers,
    // stored as (y[2m], y[2m+1]) into output row j
    const auto inverse = [&](int j) {
        Core::template run_smem<false>(z, zb, u, t, tab, true, T(1), T(1),
                                       [&](int, C v) { return v; });
        if (live) {
            const int64_t out = (int64_t)j * batch * L + row;
#pragma unroll
            for (int s = 0; s < E; ++s)
                y[out + t + s * TPF] = as<float2>(u[s]);
        }
    };

    if constexpr (!BANK) {
        // split, product and merge in place: one thread a pair (k, L-k)
#pragma unroll
        for (int p = 0; p < E / 2; ++p) {
            const int k = t + p * TPF;  // 0 <= k < L/2
            if (k == 0) {
                put(z[0], filter_dc(split_dc(as<C>(z[0])), __ldg(h)));
                continue;
            }
            const C w = wpow(k);
            C xk, xm, zk, zm;
            split_pair_w(as<C>(z[k]), as<C>(z[L - k]), w, xk, xm);
            filter_pair(xk, xm, __ldg(h + k), __ldg(h + L - k), w, zk, zm);
            put(z[k], zk);
            put(z[L - k], zm);
        }
        if (t == 0) {  // the pair k = L/2 is its own mirror
            const C zh = as<C>(z[L / 2]), w = wpow(L / 2);
            const C hh = __ldg(h + L / 2);
            C xk, xm, zk, zm;
            split_pair_w(zh, zh, w, xk, xm);
            filter_pair(xk, xk, hh, hh, w, zk, zm);
            put(z[L / 2], zk);
        }
        __syncthreads();
        inverse(0);
    } else {
        // the bank: thread t splits its pairs k = t + p*TPF once and keeps
        // xs[p] = (X[k], X[L-k]) (slot 0: (DC, Nyquist)), thread 0 also
        // X[L/2]
        S xs[E / 2][2];
        S xh;
#pragma unroll
        for (int p = 0; p < E / 2; ++p) {
            const int k = t + p * TPF;
            if (k == 0) {
                put(xs[p][0], split_dc(as<C>(z[0])));
                continue;
            }
            C xk, xm;
            split_pair_w(as<C>(z[k]), as<C>(z[L - k]), wpow(k), xk, xm);
            put(xs[p][0], xk);
            put(xs[p][1], xm);
        }
        if (t == 0) {
            const C zh = as<C>(z[L / 2]);
            C xk, xm;
            split_pair_w(zh, zh, wpow(L / 2), xk, xm);
            put(xh, xk);
        }
        for (int j = 0; j < m; ++j) {
            const C* hj = h + (int64_t)j * L;
            // each thread rewrites only the bins it read itself: a barrier
            // is needed only after an inverse, which read the row
            if (j > 0) __syncthreads();
#pragma unroll
            for (int p = 0; p < E / 2; ++p) {
                const int k = t + p * TPF;
                if (k == 0) {
                    put(z[0], filter_dc(as<C>(xs[p][0]), __ldg(hj)));
                    continue;
                }
                C zk, zm;
                filter_pair(as<C>(xs[p][0]), as<C>(xs[p][1]),
                            __ldg(hj + k), __ldg(hj + L - k), wpow(k), zk,
                            zm);
                put(z[k], zk);
                put(z[L - k], zm);
            }
            if (t == 0) {
                const C xk = as<C>(xh), hh = __ldg(hj + L / 2);
                C zk, zm;
                filter_pair(xk, xk, hh, hh, wpow(L / 2), zk, zm);
                put(z[L / 2], zk);
            }
            __syncthreads();
            inverse(j);
        }
    }
}

template <int N, bool EXACT, bool BANK>
cudaError_t launch_conv_form(const Io& io, int64_t batch, int m,
                             const void* h, const void* tw,
                             cudaStream_t stream) {
    using G = ConvGeometry<N, EXACT>;
    using C = typename G::C;
    auto kernel = conv_kernel<N, EXACT, BANK>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<G::blocks(batch), G::THREADS, G::SMEM, stream>>>(
        io, batch, m, static_cast<const C*>(h), static_cast<const C*>(tw));
    return cudaGetLastError();
}

template <int N, bool EXACT>
cudaError_t launch_conv(const Io& io, int64_t batch, int m, const void* h,
                        const void* tw, cudaStream_t stream) {
    return m > 1 ? launch_conv_form<N, EXACT, true>(io, batch, m, h, tw,
                                                    stream)
                 : launch_conv_form<N, EXACT, false>(io, batch, m, h, tw,
                                                     stream);
}

template <int N, bool EXACT>
cudaError_t launch_conv_plane(const float2* x, float* plane, int64_t rows,
                              int64_t bins, int k, int m, const void* h,
                              const void* tw, cudaStream_t stream) {
    using K = ConvPlane<N, EXACT>;
    using C = typename K::G::C;
    auto kernel = conv_plane_kernel<N, EXACT>;
    cudaError_t err = allow_smem(kernel, K::SMEM);
    if (err != cudaSuccess) return err;
    const int64_t frames = (bins + N - k) / (N - k + 1);
    kernel<<<K::blocks(rows * frames), K::THREADS, K::SMEM, stream>>>(
        x, plane, rows * frames, bins, frames, k, m,
        static_cast<const C*>(h), static_cast<const C*>(tw));
    return cudaGetLastError();
}

template <int L, bool EXACT, bool BANK>
cudaError_t launch_conv_real_form(const float* x, float* y, int64_t batch,
                                  int m, const void* h, const void* tw,
                                  const void* wn, cudaStream_t stream) {
    using K = ConvReal<L, EXACT>;
    using C = typename K::G::C;
    auto kernel = conv_real_kernel<L, EXACT, BANK>;
    cudaError_t err = allow_smem(kernel, K::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<K::G::blocks(batch), K::G::THREADS, K::SMEM, stream>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
        batch, m, static_cast<const C*>(h), static_cast<const C*>(tw),
        static_cast<const C*>(wn));
    return cudaGetLastError();
}

template <int L, bool EXACT>
cudaError_t launch_conv_real(const float* x, float* y, int64_t batch, int m,
                             const void* h, const void* tw, const void* wn,
                             cudaStream_t stream) {
    return m > 1 ? launch_conv_real_form<L, EXACT, true>(x, y, batch, m, h,
                                                         tw, wn, stream)
                 : launch_conv_real_form<L, EXACT, false>(x, y, batch, m, h,
                                                          tw, wn, stream);
}

}  // namespace

extern "C" {

// Rows (batch, n) as smfft_c2c_run's (interleaved complex64 or fp32 planes)
// against m >= 1 responses h (m, n) -> out (m, batch, n) in the same
// layout.  h: complex (re, im) pairs with 1/n folded in, float32, or
// float64 when exact != 0, like the twiddles: tw_f = W_N^{-j}, j < N (the
// inverse core conjugates it; tw_i, the inverse table, is not read).
// Returns a cudaError_t (0 on success).
int smfft_conv(const void* in_re, const void* in_im, void* out_re,
               void* out_im, int interleaved, int64_t batch, int64_t n,
               int m, const void* h, const void* tw_f, const void* tw_i,
               int exact, void* stream) {
    (void)tw_i;
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
                                                   st)                     \
                           : launch_conv<NN, false>(io, batch, m, h, tw_f, \
                                                    st));
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

// Spectra x (rows, bins) complex64, 8-byte aligned, against m >= 1
// responses h (m, n) of k-tap filters, 1 <= k < n, as smfft_conv's but
// without the 1/n (the kernel scales each segment's points by it) ->
// plane (rows, m, bins) float32: |y|^2 of output (k - 1)/2 + b of each
// row's linear convolution with each filter (x zero beyond both ends), by
// overlap-save in segments of n = 256..16384 points.  Returns a
// cudaError_t.
int smfft_conv_plane(const void* x, void* plane, int64_t rows, int64_t bins,
                     int64_t n, int k, int m, const void* h,
                     const void* tw_f, int exact, void* stream) {
    if (rows <= 0 || bins <= 0) return (int)cudaSuccess;
    if (m < 1 || k < 1 || k >= n) return (int)cudaErrorInvalidValue;
    const float2* xf = static_cast<const float2*>(x);
    float* pf = static_cast<float*>(plane);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(NN)                                                       \
    case NN:                                                                 \
        return (int)(exact ? launch_conv_plane<NN, true>(xf, pf, rows, bins, \
                                                         k, m, h, tw_f, st)  \
                           : launch_conv_plane<NN, false>(xf, pf, rows,      \
                                                          bins, k, m, h,     \
                                                          tw_f, st));
    switch (n) {
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
// m >= 1 packed half responses h (m, n/2) -> y (m, batch, n).  tw_f:
// W_L^{-j}, j < L (L = n/2; the inverse core conjugates it, tw_i is not
// read); split: W_n^k, k < L; h, the tables: float32 (re, im) pairs, or
// float64 when exact != 0.  Returns a cudaError_t.
int smfft_conv_real(const void* x, void* y, int64_t batch, int64_t n, int m,
                    const void* h, const void* tw_f, const void* tw_i,
                    const void* split, int exact, void* stream) {
    (void)tw_i;
    if (batch <= 0) return (int)cudaSuccess;
    if (m < 1) return (int)cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(LL)                                                       \
    case 2 * LL:                                                             \
        return (int)(exact ? launch_conv_real<LL, true>(xf, yf, batch, m, h, \
                                                        tw_f, split, st)     \
                           : launch_conv_real<LL, false>(xf, yf, batch, m,   \
                                                         h, tw_f, split,     \
                                                         st));
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
