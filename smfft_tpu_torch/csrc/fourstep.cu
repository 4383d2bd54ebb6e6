// One pass of a multi-pass (Bailey) decomposition of a huge power-of-two
// C2C FFT, N = R1 * R2 * ... * Rp: one kernel for Hopper (sm_90a), in an
// fp32 and an "exact" (fp64 arithmetic) instantiation, templated on the
// pass's radix R = 16..2048.
//
// fourstep_pass_kernel replaces the TPU kernels
//   smfft_tpu/ops/rowfour.py::_build                (B17)
//   smfft_tpu/ops/hugefft.py::_build_p0             (B18)
//   smfft_tpu/ops/hugefft.py::_build_p2_direct      (B19)
//   smfft_tpu/ops/hugefft.py::_build_p1             (B20)
//   smfft_tpu/ops/hugefft.py::_build_p2_contract    (B21)
//   smfft_tpu/ops/fourstep_fused.py::_build_pass1   (B22)
//   smfft_tpu/ops/fourstep_fused.py::_build_pass2   (B23)
// which are the passes of the TPU's plans; here a plan is a list of launches
// of this one kernel (ops/fourstep_fused.py builds the list).  A launch
// computes, for every transform c of every row b (N/R transforms a row),
//
//     y[out(c) + k * out_stride] = W_L^(s(c) * k) * DFT_R(scale * x[in(c) +
//                                   j * in_stride])[k],   k < R,
//
// where in(c) and out(c) are one of two index maps (runtime):
//   * column (stride S): c = o*S + s, the R points at o*R*S + s + j*S;
//   * digit-reversed row: c = d1 + R1*(d2 + R2*(...)) over the radices
//     R1..Rq, the R contiguous points of row ((d1*R2 + d2)*R3 + ...) * R;
// and the twiddle W_L^(s*k), s = c mod tw_s, L = R * tw_s, is omitted when
// tw_s = 0.  The default plan is p - 1 in-place column passes, pass i with
// S = R_{i+1}...R_p and tw_s = S (DIF), and a last pass that reads
// digit-reversed rows and writes columns of stride N/R_p, which lands the
// output in natural order X[k1 + R1*k2 + R1*R2*k3 + ...].  The JAX
// package's strided two-pass (B22/B23) is the same kernel with other maps:
// pass 1 column in, row out (its twiddled Bmat), pass 2 column in and out.
//
// What bounds it on the H100: each pass reads and writes every point once
// (16 bytes a point for complex64; 32 for the "exact" tier's complex128
// intermediates) against ~5 R log2 R flops a transform, so a pass is bound
// by device memory, and a p-pass plan costs p times the bytes of a
// single-pass row kernel.  The design keeps each pass at one read and one
// write of device memory and keeps both moving while the block computes:
//   * a tile is T transforms of R points (PassTile): T = 16 for complex64
//     and 8 for complex128 (128 contiguous bytes a row of a column tile;
//     more at small R), one slot of LD points each in shared memory;
//   * a persistent grid (as many blocks as fit on the card) walks the
//     tiles, with two tile buffers: tile i+1 is in flight while tile i is
//     transformed and stored.  At R = 1024 two tiles of a 128-byte segment
//     do not fit in 227 KB, so it takes two of half a segment (64 bytes a
//     row; one buffer of a full segment measured 2.2 ms a pass at 2^20
//     against 1.2 at R = 512 with two); at R = 2048 even that does not fit,
//     and one buffer of half a segment overlaps tile i+1's load with tile
//     i's store only;
//   * the loads are 16-, 8- or 4-byte cp.async straight into the slots
//     (the element is the load: a complex128, a complex64, or one plane of
//     a planar pair into its half), issued by every thread in the layout
//     the index map gives contiguous addresses (transform-fastest for a
//     column map, point-fastest for a row map); no register staging.  TMA
//     was not chosen: its tensor maps would be encoded on the host per
//     operand and shape, its boxes cannot follow the digit-reversed row
//     map, and a slot is padded per transform, which an 8-byte copy
//     addresses freely.  Where the element types differ (the "exact"
//     tier's complex64 or planar input) the load is a plain load and a
//     widening store;
//   * the transform runs on hcore.cuh's core straight from the staged slot
//     (its first stage reads the tile, its last returns registers) with
//     the lanes of a warp across FW adjacent transforms (16 complex64, 8
//     complex128), so every stage's shared-memory access is conflict-free
//     by the slot stride LD = R + 1 alone (R >= 1024: padded points), and
//     the last stage's registers store straight to a column map, 128
//     contiguous bytes a half warp; only a row map out (B22's pass 1)
//     goes back through the slot;
//   * the twiddle is applied to the last stage's outputs unrounded, from an
//     exact integer exponent and two small float64-computed tables
//     (huge.cuh's root): no sincos of an fp32 angle.  W_N^(mul k) for k = t
//     + s*TPF is W_N^(mul t), one root a thread, times W_N^(mul TPF s) from
//     a per-tile table in shared memory, so the scattered reads of the root
//     tables are a few a thread, not two a point;
//   * the passes of a plan run in place on one intermediate buffer (a tile
//     owns its transforms' points, and a prefetched tile is disjoint from
//     the one being stored);
//   * "exact": fp64 arithmetic, shared memory and tables, and complex128
//     intermediates between the passes (ops/fourstep_fused.py), so the only
//     fp32 rounding is the output's;
//   * index maps by shifts (every size is a power of two), 64-bit offsets
//     (b * N passes 2^31 points at N = 2^28, b = 8); the ragged tail of the
//     transforms is masked; the launcher returns cudaGetLastError() right
//     after the launch.
//
// The pair split (fourstep_pass_kernel<R, EXACT, true>: the last pass of a
// plan with the split as its epilogue; it replaces the pair split of
// real_huge.cu, B25).  A forward
// real transform in pair mode runs Z = FFT_N(x_p + i x_q) and wants the
// packed half-spectra X_p[j] = (Z[j] + conj Z[N-j]) / 2 and X_q[j] = -i
// (Z[j] - conj Z[N-j]) / 2, j < N/2, slot 0 = (Re Z[0], Re Z[N/2]) and
// (Im Z[0], Im Z[N/2]).  The last pass (digit-reversed rows in, columns
// of stride S = N/R out) has transform c write Z[c + k*S], k < R, and
// Z[N - c - k*S] is point R-1-k of transform S-c (c != 0): the split
// pairs whole transforms, c with S-c, and 0 and S/2 each with itself
// (k with R-k, and k with R-1-k; DC and Nyquist are both transform 0's).
// So a split tile (SplitTile) holds T/2 pairs: slot f < T/2 transform c =
// P, slot f + T/2 its mirror S-P (S/2 for P = 0), pair P of its row (the
// pairs run over the rows, so a tile may span rows where S/2 < T/2).
// After the last stage each thread puts its outputs k >= R/2 into its
// slot (every mirror of a point k < R/2 is one of those), reads its
// points' mirrors from the other slot of its pair, and streams the bins
// c + k*S < N/2 of both rows of the pair from the unrounded outputs: no Z
// array is written or read back, and the pass moves its input once and
// the spectra once.  Bins of adjacent transforms are adjacent, so a warp
// stores a run of T/2 bins a row at most.  The spectrum is huge.cuh's
// Spectrum (planar, packed or numpy), its rows r and r + batch for Z row
// r (the q rows past the spectrum's last are left out: an odd batch).  The
// split is an overload of the pass kernel with its flag after EXACT, so
// that the plain passes' code, names and registers stay as they are; it
// has their loads, core and slots, twice their transforms a tile, and no
// twiddle, for last passes of radix 16..256.

#include "hcore.cuh"
#include "huge.cuh"

namespace {

using namespace smfft;

// One pass: the operands, their index maps (0 column of stride 2^ls, 1
// digit-reversed row over the radices 2^lr[i]) and the twiddle.
struct PassArgs {
    Cells in, out;
    int in_map, out_map;
    int in_ls, out_ls;
    int nr;
    int lr[4];
    int log_n, log_pr;   // log2 N, log2 (N / R)
    int64_t total;       // transforms: batch * N / R
    int64_t tw_mask;     // tw_s - 1, or -1 without the twiddle
    int log_tw_step;     // log2 (N / (R tw_s))
    int lo_bits;
};

// The largest t <= t0 (halving) whose t slots of `slot` bytes fit `budget`.
constexpr int fit_tile(int t0, int slot, int budget) {
    return t0 > 1 && t0 * slot > budget ? fit_tile(t0 / 2, slot, budget)
                                        : t0;
}

// The tile layout of a pass of radix R (models/hcore.py pass_geometry):
// T transforms a tile (at least a 128-byte segment, more at small R, as
// many as fit 140 KB), two tile buffers where they fit, else two of half a
// segment (R = 1024) where that fits, else one (R = 2048); points padded
// inside a slot where a tile is narrower than a segment.
template <int R, bool EXACT>
struct PassTile {
    using C = typename std::conditional<EXACT, double2, float2>::type;
    static constexpr int ELEM = sizeof(C);
    static constexpr int SEG = 128 / ELEM;  // transforms in 128 bytes
    static constexpr int BUDGET = 140 * 1024;  // bytes of tile buffers
    static constexpr int T0 = (EXACT ? 2048 : 4096) / R;
    static constexpr int T1 = fit_tile(T0 > SEG ? T0 : SEG, (R + 1) * ELEM,
                                       BUDGET);
    static constexpr bool TWO = 2 * T1 * (R + 1) * ELEM <= BUDGET;
    static constexpr bool HALVE = !TWO && T1 / 2 >= SEG / 2;
    static constexpr int T = HALVE ? T1 / 2 : T1;
    static constexpr int NB = TWO || HALVE ? 2 : 1;
    static constexpr bool PAD = T < SEG;
    static constexpr int LD = PAD ? R + R / 16 + (EXACT ? 0 : 2) : R + 1;
    static constexpr int E = T * R / 16 <= (EXACT ? 256 : 512) ? 16 : 32;
    static constexpr int TPF = R / E;
    static constexpr int FW = T < SEG ? T : SEG;
    static constexpr int THREADS = T * TPF;
    using Core = hc::Core<R, TPF, PAD, false>;
    // the tiles, the stage twiddles, and a tile's W_N^(mul TPF s) (T * E)
    static constexpr size_t SMEM =
        ((size_t)NB * T * LD + Core::TAB + T * E) * ELEM;
    static_assert(NB * T * LD * ELEM <= BUDGET, "tiles over budget");
    static constexpr int BY_SMEM = (int)(233472 / (SMEM + 1024));
    static constexpr int MINB = BY_SMEM < 2 ? 1 : 2;
};

// Where transform g's points start: its row's offset plus the map's first
// point.
__device__ __forceinline__ int64_t transform_at(const PassArgs& a, int map,
                                                int ls, int log_r,
                                                int64_t g) {
    const int64_t b = g >> a.log_pr;
    const int64_t c = g & ((int64_t(1) << a.log_pr) - 1);
    int64_t p;
    if (map == 0) {
        p = ((c >> ls) << (log_r + ls)) + (c & ((int64_t(1) << ls) - 1));
    } else {
        int64_t pos = 0, rest = c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // unrolled: no local copy of a.lr
            if (i < a.nr) {
                pos = (pos << a.lr[i]) |
                      (rest & ((int64_t(1) << a.lr[i]) - 1));
                rest >>= a.lr[i];
            }
        }
        p = pos << log_r;
    }
    return (b << a.log_n) + p;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Point j of a transform at offset `at` of the input into slot element d.
template <bool EXACT, typename C>
__device__ __forceinline__ void stage_point(C* d, const Cells& in,
                                            int64_t at) {
    if (EXACT && in.kind == 2) {
        cp_async16(d, static_cast<const double2*>(in.a) + at);
    } else if (!EXACT && in.kind == 0) {
        cp_async8(d, static_cast<const float2*>(in.a) + at);
    } else if (!EXACT && in.kind == 1) {
        float* f = reinterpret_cast<float*>(d);
        cp_async4(f, static_cast<const float*>(in.a) + at);
        cp_async4(f + 1, static_cast<const float*>(in.b) + at);
    } else {
        *d = in.load<C>(at);  // widening: a plain load
    }
}

// Issue the loads of tile `tile` into buf (T slots of LD points).
template <int R, bool EXACT>
__device__ __forceinline__ void issue_tile(
    const PassArgs& a, int64_t tile, typename PassTile<R, EXACT>::C* buf) {
    using G = PassTile<R, EXACT>;
    constexpr int LOG_R = ilog2(R);
    const int tid = threadIdx.x;
    const int64_t g0 = tile * G::T;
    if (a.in_map == 0) {
        // transform-fastest: thread tid takes transform tid % T, points
        // tid / T + k * TPF
        const int f = tid % G::T;
        if (g0 + f >= a.total) return;
        const int64_t at = transform_at(a, 0, a.in_ls, LOG_R, g0 + f);
#pragma unroll 8
        for (int k = 0; k < G::E; ++k) {
            const int j = tid / G::T + k * G::TPF;
            stage_point<EXACT>(buf + f * G::LD + G::Core::pos(j), a.in,
                               at + ((int64_t)j << a.in_ls));
        }
    } else {
        // point-fastest: element e = tid + k * THREADS is point e % R of
        // transform e / R
#pragma unroll 4
        for (int k = 0; k < G::E; ++k) {
            const int e = tid + k * G::THREADS;
            const int f = e >> LOG_R, j = e & (R - 1);
            if (g0 + f >= a.total) continue;
            const int64_t at = transform_at(a, 1, 0, LOG_R, g0 + f);
            stage_point<EXACT>(buf + f * G::LD + G::Core::pos(j), a.in,
                               at + j);
        }
    }
}

template <int R, bool EXACT>
__global__ void __launch_bounds__(PassTile<R, EXACT>::THREADS,
                                  PassTile<R, EXACT>::MINB)
fourstep_pass_kernel(PassArgs a, double scale,
                     const typename PassTile<R, EXACT>::C* __restrict__ tw,
                     const typename PassTile<R, EXACT>::C* __restrict__ lo,
                     const typename PassTile<R, EXACT>::C* __restrict__ hi,
                     int inverse) {
    using G = PassTile<R, EXACT>;
    using C = typename G::C;
    using Tr = real_t<C>;
    using Core = typename G::Core;
    constexpr int LOG_R = ilog2(R);
    constexpr int E = G::E, TPF = G::TPF;
    C* smem = shared_buffer<C>();
    C* tab = smem + G::NB * G::T * G::LD;
    C* steps = tab + Core::TAB;  // [s][f]: W_N^(mul_f * TPF * s)
    const int tid = threadIdx.x;
    const Tr sgn = inverse ? Tr(1) : Tr(-1);
    const int64_t ntiles = (a.total + G::T - 1) / G::T;
    // the lanes of a warp across FW adjacent transforms
    const int f = tid % G::FW + G::FW * (tid / (G::FW * TPF));
    const int t = (tid / G::FW) % TPF;

    Core::fill(tab, tw, tid, G::THREADS);
    constexpr int64_t SLOTS = (int64_t)G::T * G::LD;
    const int64_t step = gridDim.x;
    // NB buffers: NB - 1 tiles in flight ahead of the one transformed
    // (with one buffer the next tile's load starts after the transform)
    int64_t tile = blockIdx.x;
#pragma unroll
    for (int k = 0; k < (G::NB > 1 ? G::NB - 1 : 1); ++k) {
        if (tile + k * step < ntiles)
            issue_tile<R, EXACT>(a, tile + k * step, smem + k * SLOTS);
        cp_commit();
    }
    // the exponent of W_N per output point k of transform g (0: none)
    auto tw_mul = [&](int64_t g) -> int64_t {
        return a.tw_mask >= 0
                   ? ((g & ((int64_t(1) << a.log_pr) - 1)) & a.tw_mask)
                         << a.log_tw_step
                   : 0;
    };
    for (int it = 0; tile < ntiles; tile += step, ++it) {
        C* cur = smem + (it % G::NB) * SLOTS;
        const int64_t next = tile + step;
        // W_N^(mul * k), k = t + s*TPF, is W_N^(mul t) (one root a thread)
        // times W_N^(mul TPF s) from this table (one root a transform and
        // s): two reads of the root tables a thread and a tile's few
        // entries, not two a point
        if (a.tw_mask >= 0) {
            for (int e = tid; e < G::T * E; e += G::THREADS) {
                const int ff = e % G::T, s = e / G::T;
                steps[e] = root(lo, hi, tw_mul(tile * G::T + ff) * TPF * s,
                                a.lo_bits);
            }
        }
        if (G::NB > 1) {
            const int64_t ahead = tile + (G::NB - 1) * step;
            if (ahead < ntiles)
                issue_tile<R, EXACT>(a, ahead,
                                     smem + ((it + G::NB - 1) % G::NB) *
                                                SLOTS);
            cp_commit();
            cp_wait<G::NB - 1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();

        const int64_t g = tile * G::T + f;
        const bool valid = g < a.total;
        const bool twid = a.tw_mask >= 0;
        const C base = twid ? root(lo, hi, tw_mul(g) * t, a.lo_bits)
                            : cmake(Tr(1), Tr(0));
        C u[E];
        Core::run_smem(cur + f * G::LD, u, t, tab, false, sgn, Tr(scale),
                       [&](int s, C v) {
                           return twid ? cmul(v, cmul(base,
                                                      steps[s * G::T + f]))
                                       : v;
                       });
        if (a.out_map == 0) {
            if (G::NB == 1) {
                __syncthreads();  // every read of the slot is done
                if (next < ntiles) issue_tile<R, EXACT>(a, next, smem);
                cp_commit();
            }
            if (valid) {
                const int64_t at =
                    transform_at(a, 0, a.out_ls, LOG_R, g);
#pragma unroll
                for (int s = 0; s < E; ++s)
                    a.out.store(at + ((int64_t)(t + s * TPF) << a.out_ls),
                                u[s]);
            }
        } else {
            // a row map out: through the slot, then point-fastest
            __syncthreads();
#pragma unroll
            for (int s = 0; s < E; ++s)
                cur[f * G::LD + Core::pos(t + s * TPF)] = u[s];
            __syncthreads();
#pragma unroll 4
            for (int k = 0; k < E; ++k) {
                const int e = tid + k * G::THREADS;
                const int ff = e >> LOG_R, j = e & (R - 1);
                const int64_t gg = tile * G::T + ff;
                if (gg < a.total)
                    a.out.store(transform_at(a, 1, 0, LOG_R, gg) + j,
                                cur[ff * G::LD + Core::pos(j)]);
            }
            if (G::NB == 1) {
                __syncthreads();
                if (next < ntiles) issue_tile<R, EXACT>(a, next, smem);
                cp_commit();
            }
        }
        if (G::NB > 1) __syncthreads();  // cur is refilled at it + NB
    }
    cp_wait<0>();
}

// The split pass's tile (models/hcore.py split_geometry): T slots hold T/2
// pairs, and a spectrum row's bins of a side's T/2 adjacent transforms are
// one contiguous run of T/2 * 8 bytes.  At the plain pass's T those runs
// are 128 bytes at R = 128, and on an H100 the last pass of a 2^23-point
// pair-mode call of 4 GiB took 6.1-6.4 ms where the plain pass takes 3.3;
// at twice the transforms, 256-byte runs, 4.4 (PERF.md section 6).  So
// the tile holds twice the plain pass's transforms in two buffers, which
// fit the plain pass's budget to R = 256 (ops/fourstep_fused.py
// SPLIT_MAX_RADIX: above it the runs would stay 32-64 bytes, and the pair
// split runs as real_huge.cu's own pass); E = 16 points a thread up to
// 512 threads (256 for "exact"), else 32; the lanes of a warp across 32
// transforms of a side where a side has 32 (a warp stores 256 contiguous
// bytes of complex64), else the plain pass's FW.
template <int R, bool EXACT>
struct SplitTile {
    using P = PassTile<R, EXACT>;
    using C = typename P::C;
    static constexpr int ELEM = P::ELEM;
    static constexpr int LD = P::LD;
    static constexpr int T = 2 * P::T;
    static constexpr int E = T * R / 16 <= (EXACT ? 256 : 512) ? 16 : 32;
    static constexpr int TPF = R / E;
    static constexpr int FW = T / 2 >= 32 ? 32 : P::FW;
    static constexpr int THREADS = T * TPF;
    using Core = hc::Core<R, TPF, false, false>;
    static constexpr size_t SMEM = ((size_t)2 * T * LD + Core::TAB) * ELEM;
    static constexpr int BY_SMEM = (int)(233472 / (SMEM + 1024));
    static constexpr int MINB = BY_SMEM < 2 ? 1 : 2;
};

// The transform in slot f of split tile `tile`, or -1 past the last pair:
// pair P (over every row, S/2 a row) = tile * T/2 + f mod T/2; slot f <
// T/2 holds transform P of the pair's row, slot f + T/2 its mirror S - P,
// or S/2 for P = 0 (0 and S/2 each pair with themselves).
template <typename G>
__device__ __forceinline__ int64_t split_transform(const PassArgs& a,
                                                   int64_t tile, int f) {
    constexpr int H = G::T / 2;
    const int64_t pg = tile * H + (f & (H - 1));
    if (pg >= a.total / 2) return -1;
    const int64_t half = int64_t(1) << (a.log_pr - 1);  // S/2
    const int64_t p = pg & (half - 1);
    const int64_t c = f < H ? p : (p ? 2 * half - p : half);
    return ((pg >> (a.log_pr - 1)) << a.log_pr) + c;
}

// Where the split writes: the packed spectra (huge.cuh's Spectrum), rows
// of them in all (the q rows past the last are left out).
struct SplitOut {
    Spectrum spec;
    int64_t rows;
};

// Issue the loads of split tile `tile` into buf: each slot's transform, a
// contiguous row of the digit-reversed map, point-fastest.
template <int R, bool EXACT>
__device__ __forceinline__ void issue_split_tile(
    const PassArgs& a, int64_t tile, typename SplitTile<R, EXACT>::C* buf) {
    using G = SplitTile<R, EXACT>;
    constexpr int LOG_R = ilog2(R);
    const int tid = threadIdx.x;
#pragma unroll 4
    for (int k = 0; k < G::E; ++k) {
        const int e = tid + k * G::THREADS;
        const int f = e >> LOG_R, j = e & (R - 1);
        const int64_t g = split_transform<G>(a, tile, f);
        if (g < 0) continue;
        stage_point<EXACT>(buf + f * G::LD + G::Core::pos(j), a.in,
                           transform_at(a, 1, 0, LOG_R, g) + j);
    }
}

// The pair split of the last stage's outputs u (points t + s*TPF of
// transform g, slot f of cur), in place in u: the outputs k >= R/2
// through the slot to the pair's other transform, then X_p of the points
// k < R/2 into u[s] and X_q into u[s + E/2], s < E/2.  Returns with every
// read of the slots done by the calling thread.
template <int R, bool EXACT, typename C>
__device__ __forceinline__ void split_pairs(
    const PassArgs& a, C* cur, C (&u)[SplitTile<R, EXACT>::E], int f, int t,
    int64_t g) {
    using G = SplitTile<R, EXACT>;
    using Core = typename G::Core;
    using Tr = real_t<C>;
    constexpr int E = G::E, TPF = G::TPF, H = G::T / 2;
    __syncthreads();  // every read of the slot by the last stage is done
#pragma unroll
    for (int s = E / 2; s < E; ++s)
        cur[f * G::LD + Core::pos(t + s * TPF)] = u[s];
    __syncthreads();
    const int64_t S = int64_t(1) << a.log_pr;
    const int64_t c = g & (S - 1);
    const C* own = cur + f * G::LD;
    const C* mate = c == 0 || c == S / 2 ? own : cur + (f ^ H) * G::LD;
    const Tr h = Tr(0.5);
#pragma unroll
    for (int s = 0; s < E / 2; ++s) {
        const int k = t + s * TPF;
        const C z = u[s];
        if (c == 0 && k == 0) {
            const C ny = own[Core::pos(R / 2)];  // Z[N/2]
            u[s] = cmake(z.x, ny.x);
            u[s + E / 2] = cmake(z.y, ny.y);
        } else {
            // Z[N - c - k S]: point R-k of transform 0, else R-1-k of S-c
            const C m = c == 0 ? own[Core::pos(R - k)]
                               : mate[Core::pos(R - 1 - k)];
            u[s] = cmake(h * (z.x + m.x), h * (z.y - m.y));
            u[s + E / 2] = cmake(h * (z.y + m.y), h * (m.x - z.x));
        }
    }
}

// The last pass of a plan with the pair split as its epilogue: the plain
// kernel's loads and core over split tiles (two buffers, the next tile in
// flight; no twiddle), the split through the slots, and each thread's
// bins c + k*S, k < R/2, of the pair's two spectrum rows streamed from
// the registers.
template <int R, bool EXACT, bool SPLIT>
__global__ void __launch_bounds__(SplitTile<R, EXACT>::THREADS,
                                  SplitTile<R, EXACT>::MINB)
fourstep_pass_kernel(PassArgs a, SplitOut o, double scale,
                     const typename PassTile<R, EXACT>::C* __restrict__ tw,
                     int inverse) {
    using G = SplitTile<R, EXACT>;
    using C = typename G::C;
    using Tr = real_t<C>;
    using Core = typename G::Core;
    constexpr int E = G::E;
    static_assert(SPLIT, "the plain pass is fourstep_pass_kernel<R, EXACT>");
    static_assert(!G::P::PAD && 2 * G::T * G::LD * G::ELEM <= G::P::BUDGET,
                  "two unpadded buffers of the split tile fit the budget");
    C* smem = shared_buffer<C>();
    C* tab = smem + 2 * G::T * G::LD;
    const int tid = threadIdx.x;
    const Tr sgn = inverse ? Tr(1) : Tr(-1);
    const int64_t ntiles = (a.total + G::T - 1) / G::T;
    const int f = tid % G::FW + G::FW * (tid / (G::FW * G::TPF));
    const int t = (tid / G::FW) % G::TPF;
    const int64_t q_off = a.total >> a.log_pr;  // the rows of Z

    Core::fill(tab, tw, tid, G::THREADS);
    constexpr int64_t SLOTS = (int64_t)G::T * G::LD;
    const int64_t step = gridDim.x;
    int64_t tile = blockIdx.x;
    if (tile < ntiles) issue_split_tile<R, EXACT>(a, tile, smem);
    cp_commit();
    for (int it = 0; tile < ntiles; tile += step, ++it) {
        C* cur = smem + (it % 2) * SLOTS;
        if (tile + step < ntiles)
            issue_split_tile<R, EXACT>(a, tile + step,
                                       smem + ((it + 1) % 2) * SLOTS);
        cp_commit();
        cp_wait<1>();
        __syncthreads();
        C u[E];
        Core::run_smem(cur + f * G::LD, u, t, tab, false, sgn, Tr(scale),
                       [](int, C v) { return v; });
        const int64_t g = split_transform<G>(a, tile, f);
        split_pairs<R, EXACT>(a, cur, u, f, t, g);
        if (g >= 0) {
            const int64_t row = g >> a.log_pr;
            const int64_t c = g & ((int64_t(1) << a.log_pr) - 1);
#pragma unroll
            for (int s = 0; s < E / 2; ++s) {
                const int64_t bin = c + ((int64_t)(t + s * G::TPF)
                                         << a.log_pr);
                o.spec.store<true>(row, bin, u[s]);
                if (row + q_off < o.rows)
                    o.spec.store<true>(row + q_off, bin, u[s + E / 2]);
            }
        }
        __syncthreads();  // cur is refilled at it + 2
    }
    cp_wait<0>();
}

__host__ int ilog2_64(int64_t v) {
    int k = 0;
    while ((int64_t(1) << (k + 1)) <= v) ++k;
    return k;
}

// Blocks of a persistent grid of `kernel` (THREADS threads, SMEM bytes
// of shared memory): as many as fit the card, at most one a tile.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem,
                            int64_t ntiles, unsigned* grid) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    const int64_t g = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    *grid = (unsigned)(g < ntiles ? g : ntiles);
    return cudaSuccess;
}

template <int R, bool EXACT>
cudaError_t launch(const PassArgs& args, double scale, const void* tw,
                   const void* lo, const void* hi, int inverse,
                   cudaStream_t stream) {
    using G = PassTile<R, EXACT>;
    using C = typename G::C;
    void (*kernel)(PassArgs, double, const C*, const C*, const C*, int) =
        fourstep_pass_kernel<R, EXACT>;
    unsigned grid = 0;
    cudaError_t err = persistent_grid(kernel, G::THREADS, G::SMEM,
                                      (args.total + G::T - 1) / G::T, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
        args, scale, static_cast<const C*>(tw), static_cast<const C*>(lo),
        static_cast<const C*>(hi), inverse);
    return cudaGetLastError();
}

// The split pass (T/2 of the total / 2 pairs a tile), to R = 256.
template <int R, bool EXACT>
cudaError_t launch_split(const PassArgs& args, const SplitOut& out,
                         double scale, const void* tw, int inverse,
                         cudaStream_t stream) {
    if constexpr (R > 256) {
        return cudaErrorInvalidValue;
    } else {
        using G = SplitTile<R, EXACT>;
        using C = typename G::C;
        void (*kernel)(PassArgs, SplitOut, double, const C*, int) =
            fourstep_pass_kernel<R, EXACT, true>;
        unsigned grid = 0;
        cudaError_t err = persistent_grid(
            kernel, G::THREADS, G::SMEM, (args.total + G::T - 1) / G::T,
            &grid);
        if (err != cudaSuccess) return err;
        kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
            args, out, scale, static_cast<const C*>(tw), inverse);
        return cudaGetLastError();
    }
}

template <int R>
cudaError_t dispatch(const PassArgs& args, const SplitOut* split,
                     double scale, const void* tw, const void* lo,
                     const void* hi, int inverse, int exact,
                     cudaStream_t st) {
    if (split)
        return exact ? launch_split<R, true>(args, *split, scale, tw,
                                             inverse, st)
                     : launch_split<R, false>(args, *split, scale, tw,
                                              inverse, st);
    return exact ? launch<R, true>(args, scale, tw, lo, hi, inverse, st)
                 : launch<R, false>(args, scale, tw, lo, hi, inverse, st);
}

}  // namespace

extern "C" {

// One pass over batch rows of n points.  in_kind / out_kind: 0 complex64,
// 1 planar fp32 (in_b / out_b the imaginary planes), 2 complex128; in_map /
// out_map: 0 column of stride in_s / out_s, 1 digit-reversed row over the
// nr radices r0..r3.  n, the radix, the strides, tw_s and the row map's
// radices are powers of two; the radix divides n; tw_s = 0 omits the
// twiddle.  tw: W_radix^m, m < radix; lo, hi: W_n^j, j < 2^lo_bits, and
// W_n^(i * 2^lo_bits); all three (re, im) float32 pairs, or float64 when
// exact != 0.  spec_layout >= 0: the pass is a plan's last (row map in,
// columns of stride n / radix out, no twiddle, radix <= 256) and writes
// the pair split of its output into spec_rows rows of packed spectra of
// n/2 bins at out_a / out_b in layout spec_layout (0 planar pair, 1 packed
// complex64, 2 numpy complex64 of n/2 + 1 bins), the q rows batch after
// the p rows (out_kind unused); -1: out is the pass's output.  Returns a
// cudaError_t (0 on success).
int smfft_fourstep_pass(void* in_a, void* in_b, int in_kind, int in_map,
                        int64_t in_s, void* out_a, void* out_b, int out_kind,
                        int out_map, int64_t out_s, int nr, int64_t r0,
                        int64_t r1, int64_t r2, int64_t r3, int64_t batch,
                        int64_t n, int64_t radix, int64_t tw_s, double scale,
                        const void* tw, const void* lo, const void* hi,
                        int lo_bits, int inverse, int exact, int spec_layout,
                        int64_t spec_rows, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (nr < 0 || nr > 4 || n % radix) return (int)cudaErrorInvalidValue;
    const bool split = spec_layout >= 0;
    if (split && (spec_layout > 2 || in_map != 1 || out_map != 0 ||
                  out_s != n / radix || tw_s != 0 || n / radix < 2 ||
                  spec_rows < batch || spec_rows > 2 * batch))
        return (int)cudaErrorInvalidValue;
    const int64_t rs[4] = {r0, r1, r2, r3};
    const int64_t pow2[5] = {n, radix, in_map == 0 ? in_s : 1,
                             out_map == 0 ? out_s : 1, tw_s ? tw_s : 1};
    for (int64_t v : pow2)
        if (v < 1 || (v & (v - 1))) return (int)cudaErrorInvalidValue;
    PassArgs args{};
    args.in = Cells{in_a, in_b, in_kind};
    args.out = Cells{out_a, out_b, out_kind};
    args.in_map = in_map;
    args.out_map = out_map;
    args.in_ls = in_map == 0 ? ilog2_64(in_s) : 0;
    args.out_ls = out_map == 0 ? ilog2_64(out_s) : 0;
    args.nr = nr;
    for (int i = 0; i < nr; ++i) {
        if (rs[i] < 1 || (rs[i] & (rs[i] - 1)))
            return (int)cudaErrorInvalidValue;
        args.lr[i] = ilog2_64(rs[i]);
    }
    args.log_n = ilog2_64(n);
    args.log_pr = ilog2_64(n / radix);
    args.total = batch * (n / radix);
    args.tw_mask = tw_s ? tw_s - 1 : -1;
    args.log_tw_step = tw_s ? ilog2_64(n / (radix * tw_s)) : 0;
    args.lo_bits = lo_bits;
    const SplitOut out{Spectrum{static_cast<float*>(out_a),
                                static_cast<float*>(out_b), spec_layout,
                                n / 2},
                       spec_rows};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(RR)                                                     \
    case RR:                                                               \
        return (int)dispatch<RR>(args, split ? &out : nullptr, scale, tw,  \
                                 lo, hi, inverse, exact, st);
    switch (radix) {
        SMFFT_CASE(16)
        SMFFT_CASE(32)
        SMFFT_CASE(64)
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
