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
// and the twiddle W_L^(s*k), s = c mod tw_s with its low log2 tw_lo bits
// cleared, L = R * tw_s, is omitted when tw_s = 0.  tw_lo = K > 1 serves
// an axis of M = R * R2 points at stride K (ops/fourstep_fused.py
// column_plan): its first pass reads columns of stride R2 * K, and
// transform s = b * K + col takes W_M^(b * k) = W_(R R2 K)^(b K k) whatever
// its column.  The default plan is p - 1 in-place column passes, pass i with
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
//
// The fused tail (below) runs pass 2 and the split pass of a pair-mode
// plan in one launch, through L2: a third overload of the kernel.  The
// fused column launch (after it) runs both passes of the column route's
// two-pass plan in one launch, through L2 (a fourth): one sweep of device
// memory a call where the two launches make two, bound by L2's capacity
// and throughput where each pass alone is bound by device memory.

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
    int64_t tw_mask;     // (tw_s - 1) & ~(tw_lo - 1), or -1 without it
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

// ---------------------------------------------------------------------------
// The fused tail (fourstep_pass_kernel<R2, R3, false, true, true>): pass 2
// and the split pass of a three-pass pair-mode plan (R1, R2, R3) in one
// persistent launch, which hands the intermediate from the one to the
// other through L2.  Pass 1's output digit d1 cuts each Z row into R1
// blocks of N/R1 points: pass 2 (columns of stride R3) stays inside a
// block, and split tile (d2, g) reads row d2 of blocks g*H .. g*H + H - 1
// and row R2-1-d2 of their mirrors (R1 - d1) mod R1 (H pairs a tile).  So
// once pass 1 is done, pass 2 and the split of a group pair (groups j and
// G-1-j of a row, G = R1/H: 2H blocks) need no other group pair but one
// block of each neighbour.  The plan (ops/fourstep_fused.py tail_plan) is
// (N / 2^14, 128, 128): blocks of 128 KiB and group pairs of 8 MiB at
// every N, where (256, 128) and its 16 MiB pairs only broke even on an
// H100 (PERF.md).
//   * one ordered list of work (models/hcore.py tail_items): the pass-2
//     items of the first LAG = 2 group pairs, then for each pair q those
//     of q + 2 and the split items of q in turn, handed out by an atomic
//     ticket.  A split item waits only for items of a lower ticket, which
//     running blocks hold, and a block waits only with no item of its own
//     unfinished: no deadlock.  Three pairs (24 MiB) are in L2 at once,
//     and reads and writes of device memory stay in flight together;
//   * a counter a block of pass-2 items done: the items' stores,
//     __syncthreads, __threadfence, then the count; a split item's
//     counters are read by warp 0 with ld.acquire, then __syncthreads.  The
//     ticket, the counters, the epoch and a count of split items that were
//     not ready when polled live on the device across calls
//     (ops/fourstep_fused.py).  A launch's epoch is the word's value plus
//     one, and a counter of an older epoch reads as not done; the last
//     block to leave stores that epoch and sets the ticket back to 0, so a
//     launch needs nothing from the host (a CUDA graph replays it);
//   * a split item reads the intermediate from L2 (ld.global.cg), never
//     L1: a pass-2 item on the same SM may have cached old lines of its
//     blocks.  A pass-2 item's lines are each read once, by it, so its
//     loads are cp.async into the tile buffer;
//   * two tile buffers: while an item is transformed and stored, the next
//     one's loads are in flight (a pass-2 item's from the start, a split
//     item's into the registers from the middle of the current item), and
//     the ticket after it is taken (its value read and its counters
//     polled in the middle, before the stores).  The split rows'
//     positions follow from the item's digits (SlotRows), not a loop over
//     the radices a point;
//   * after a split item has its rows, it discards their L2 lines
//     (discard.global.L2): the intermediate is dead, each row has one
//     reader, so its dirty lines are dropped, not written back.  The pass
//     2 loads of pass 1's output go with an evict_first hint and its
//     stores with evict_last; the spectra stream out (st.global.cs);
//   * a pass-2 item is T2 = 512 * 16 / R2 adjacent transforms, lanes
//     across 32 of them (runs of 256 bytes), the plain pass's core, twiddle
//     and maps; a split item is the split pass's SplitTile, core and
//     epilogue.
// ---------------------------------------------------------------------------

// The device words of a launch that hands out its items by ticket (the
// fused tail's, the fused column launch's): the ticket, the waits, the
// epoch of the last launch, the blocks of this launch that have left, then
// one counter a block (the tail) or a slab (the column launch).
struct TailSync {
    unsigned long long* words;

    // this launch's epoch, in warp 0 (0 elsewhere): the word changes only
    // once every block has left, so every block reads the same
    __device__ __forceinline__ unsigned long long epoch(int tid) const {
        unsigned long long e = 0;
        if (tid < 32)
            e = __shfl_sync(0xffffffffu,
                            tid == 0 ? *(volatile unsigned long long*)(
                                           words + 2)
                                     : 0ull,
                            0) + 1;
        return e;
    }
    // the block leaves (its tickets all taken, its counts all made): the
    // last to leave stores the epoch and sets the ticket back for the next
    // launch
    __device__ __forceinline__ void leave(int tid,
                                          unsigned long long epoch) const {
        if (tid == 0) {
            __threadfence();
            if (atomicAdd(words + 3, 1ull) == gridDim.x - 1) {
                *(volatile unsigned long long*)words = 0;
                *(volatile unsigned long long*)(words + 3) = 0;
                *(volatile unsigned long long*)(words + 2) = epoch;
                __threadfence();
            }
        }
    }
};

// The tail's items (models/hcore.py tail_geometry): the split pass's
// threads and E; a pass-2 item of T2 = 512 * 16 / R2 adjacent transforms
// (lanes across 32 of them: runs of 256 bytes); a split item the split
// pass's tile (H pairs).  Two tile buffers, each holding either item.
template <int R2, int R3>
struct TailTile {
    using S = SplitTile<R3, false>;
    static constexpr int THREADS = S::THREADS;
    static constexpr int E = S::E;
    static constexpr int T2 = THREADS * E / R2;
    static constexpr int TPF2 = R2 / E;
    static constexpr int FW2 = 32;
    static constexpr int LD2 = R2 + 1;
    using Core2 = hc::Core<R2, TPF2, false, false>;
    static constexpr int H = S::T / 2;             // pairs a split item
    static constexpr int PER_BLOCK = R3 / T2;      // pass-2 items a block
    static constexpr int NP = 2 * H * PER_BLOCK;   // a group pair's items
    static constexpr int NC = R2;
    // group pairs between a pair's pass-2 items and its split items: with
    // 8 MiB pairs, three in L2 at once (being read, written, waiting), and
    // a split item's blocks all written a turn before it
    static constexpr int LAG = 2;
    static constexpr int SLOTS =
        T2 * LD2 > S::T * S::LD ? T2 * LD2 : S::T * S::LD;
    // two tile buffers, the stage tables, two pass-2 twiddle tables
    static constexpr size_t SMEM =
        ((size_t)2 * SLOTS + Core2::TAB + S::Core::TAB + 2 * T2 * E) *
        sizeof(float2);
    static_assert(E == 16 && THREADS == T2 * TPF2 && T2 % FW2 == 0 &&
                      PER_BLOCK >= 1 && !S::P::PAD,
                  "the tail's items share threads, E and unpadded buffers");
};

__device__ __forceinline__ unsigned long long l2_policy_first() {
    unsigned long long p;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
    return p;
}
__device__ __forceinline__ unsigned long long l2_policy_last() {
    unsigned long long p;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
    return p;
}
// A load of the intermediate from L2 (not L1), with an L2 policy.
__device__ __forceinline__ float2 load_cg(const float2* p,
                                          unsigned long long pol) {
    float2 v;
    asm volatile("ld.global.cg.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
                 : "=f"(v.x), "=f"(v.y)
                 : "l"(p), "l"(pol)
                 : "memory");
    return v;
}
__device__ __forceinline__ void store_hint(float2* p, float2 v,
                                           unsigned long long pol) {
    asm volatile("st.global.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;"
                 :: "l"(p), "f"(v.x), "f"(v.y), "l"(pol)
                 : "memory");
}
__device__ __forceinline__ void discard_l2(const void* p) {
    asm volatile("discard.global.L2 [%0], 128;" :: "l"(p) : "memory");
}
__device__ __forceinline__ void cp_async8_hint(void* dst, const void* src,
                                               unsigned long long pol) {
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n"
        :: "r"(smem_addr(dst)), "l"(src), "l"(pol));
}
__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

// One item of the work list: a pass-2 item (block row * R1 + d1, its
// first transform) or a split item (its tile, its first own block).
struct TailItem {
    bool split;
    int64_t block, first;
};

// Ticket i's item (models/hcore.py tail_item): the pass-2 items of the
// first LAG group pairs, then for each pair q those of q + LAG and the
// split items of q in turn (so that reads and writes of device memory
// stay in flight together), then the split items of the last LAG pairs.
template <int R2, int R3>
__device__ __forceinline__ TailItem tail_item(int64_t i, int log_r1,
                                              int64_t pairs) {
    using G = TailTile<R2, R3>;
    constexpr int H = G::H, NP = G::NP;
    static_assert(G::NC == NP && (NP & (NP - 1)) == 0,
                  "a turn is a pass-2 item and a split item, NP times");
    const int64_t lag = pairs < G::LAG ? pairs : G::LAG;
    const int log_half = log_r1 - ilog2(2 * H);
    const int64_t r1 = int64_t(1) << log_r1, half = r1 >> ilog2(2 * H);
    int64_t q, u;
    bool split;
    if (i < lag * NP) {
        split = false, q = i / NP, u = i % NP;
    } else if (i < lag * NP + (pairs - lag) * 2 * NP) {
        const int64_t k = (i - lag * NP) / (2 * NP);
        const int64_t r = (i - lag * NP) % (2 * NP);
        split = r & 1;
        q = split ? k : k + lag;
        u = r >> 1;
    } else {
        const int64_t r = i - lag * NP - (pairs - lag) * 2 * NP;
        split = true, q = pairs - lag + r / NP, u = r % NP;
    }
    const int64_t b = q >> log_half, j = q & (half - 1);
    if (!split) {
        const int64_t m = u / G::PER_BLOCK, sub = u % G::PER_BLOCK;
        const int64_t d1 = m < H ? j * H + m : (2 * half - 1 - j) * H + m - H;
        const int64_t blk = b * r1 + d1;
        return {false, blk, (blk * G::PER_BLOCK + sub) * G::T2};
    }
    const int64_t grp = u < R2 / 2 ? j : 2 * half - 1 - j;
    const int64_t d2 = u < R2 / 2 ? u : u - R2 / 2;
    return {true, b * r1 + grp * H,
            b * (r1 * R2 / (2 * H)) + d2 * (r1 / H) + grp};
}

// Where the Z rows of a split item's slots start (split_transform and the
// digit-reversed row map of its last pass, with the arithmetic of one
// item's pairs: no loop over the radices a point).  Pair p = d1 + R1 d2 of
// a row, d2 < R2/2: slot f < H holds transform p + f, at row ((d1 + f) R2
// + d2) R3; slot H + m its mirror S - p - m, whose digits are (R1 - d1 -
// m, R2 - 1 - d2), or (0, R2 - d2) for d1 + m = 0 (S/2 for p = 0).
template <int R2, int R3, int H>
struct SlotRows {
    int64_t z;    // the item's Z row, b N
    int d1, d2;   // slot 0's digits
    int r1;

    __device__ __forceinline__ int64_t at(int f) const {
        int e1 = d1 + f, e2 = d2;
        if (f >= H) {
            const int m = d1 + f - H;
            e1 = (r1 - m) & (r1 - 1);
            e2 = m ? R2 - 1 - d2 : (d2 ? R2 - d2 : R2 / 2);
        }
        return z + ((int64_t)(e1 * R2 + e2) * R3);
    }
};

// Whether the 2H blocks split item `it` reads are written (warp 0, every
// lane): its own H blocks and their mirrors (R1 - d1) mod R1.
template <int H>
__device__ __forceinline__ bool tail_ready(const TailItem& it,
                                           const unsigned long long* done,
                                           unsigned long long want,
                                           int log_r1, int lane) {
    const int64_t r1 = int64_t(1) << log_r1;
    const int64_t row0 = it.block & ~(r1 - 1), d1 = it.block & (r1 - 1);
    bool ok = true;
    for (int i = lane; i < 2 * H; i += 32) {
        const int64_t blk =
            row0 + (i < H ? d1 + i : (r1 - d1 - (i - H)) & (r1 - 1));
        ok = ok && load_acquire(done + blk) >= want;
    }
    return __all_sync(0xffffffffu, ok);
}

template <int R2, int R3, bool EXACT, bool SPLIT, bool TAIL>
__global__ void __launch_bounds__(TailTile<R2, R3>::THREADS, 1)
fourstep_pass_kernel(PassArgs a2, PassArgs a3, SplitOut o, TailSync sy,
                     const float2* __restrict__ tw2,
                     const float2* __restrict__ tw3,
                     const float2* __restrict__ lo,
                     const float2* __restrict__ hi) {
    static_assert(!EXACT && SPLIT && TAIL,
                  "the fused tail is fp32 with the pair split");
    using G = TailTile<R2, R3>;
    using S = typename G::S;
    using C = float2;
    using Tr = float;
    constexpr int E = G::E, H = G::H, T2 = G::T2, TPF2 = G::TPF2;
    constexpr int LOG_R2 = ilog2(R2), LOG_R3 = ilog2(R3);
    C* const bufs = shared_buffer<C>();      // two tile buffers
    C* const tab2 = bufs + 2 * G::SLOTS;
    C* const tab3 = tab2 + G::Core2::TAB;
    C* const stepss = tab3 + S::Core::TAB;   // two [s][f]: W_N^(m_f TPF2 s)
    __shared__ long long s_next;
    __shared__ int s_ready;
    const int tid = threadIdx.x;
    const Tr sgn = Tr(-1);
    // the lanes of a warp across 32 adjacent transforms, in either item
    const int f2 = tid % G::FW2 + G::FW2 * (tid / (G::FW2 * TPF2));
    const int t2 = (tid / G::FW2) % TPF2;
    const int f3 = tid % S::FW + S::FW * (tid / (S::FW * S::TPF));
    const int t3 = (tid / S::FW) % S::TPF;
    const int log_r1 = a3.lr[0];
    const int64_t rows = a3.total >> a3.log_pr;
    const int64_t pairs = (rows << log_r1) / (2 * H);
    const int64_t items = pairs * (G::NP + G::NC);
    float2* const z = static_cast<float2*>(a2.in.a);
    unsigned long long* const ticket = sy.words;
    unsigned long long* const waits = sy.words + 1;
    unsigned long long* const done = sy.words + 4;
    const unsigned long long epoch = sy.epoch(tid);
    const unsigned long long mark = epoch << 16;
    const unsigned long long want = mark + G::PER_BLOCK;
    const unsigned long long evict_first = l2_policy_first();
    const unsigned long long evict_last = l2_policy_last();
    const int64_t tw_cols = (int64_t(1) << a2.log_pr) - 1;
    auto tw_mul = [&](int64_t g) -> int64_t {
        return ((g & tw_cols) & a2.tw_mask) << a2.log_tw_step;
    };

    G::Core2::fill(tab2, tw2, tid, G::THREADS);
    S::Core::fill(tab3, tw3, tid, G::THREADS);

    // lane 0: a ticket (its value is first read in poll)
    auto take = [&]() -> unsigned long long {
        return tid == 0 ? atomicAdd(ticket, 1ull) : 0ull;
    };
    // warp 0: ticket t broadcast and decoded, and for a split item whether
    // its blocks are written (tail_ready's ld.acquire: in the middle of an
    // item, before its stores, it waits for no store of warp 0's), into
    // s_next / s_ready, with the count of split items that were not
    auto poll = [&](unsigned long long t) {
        const long long i = __shfl_sync(0xffffffffu, (long long)t, 0);
        const TailItem pit =
            i < items ? tail_item<R2, R3>(i, log_r1, pairs) : TailItem{};
        const bool ok =
            !pit.split || tail_ready<H>(pit, done, want, log_r1, tid);
        if (tid == 0) {
            s_next = i;
            s_ready = ok;
            if (!ok) atomicAdd(waits, 1ull);
        }
    };
    // warp 0 waits until split item it's blocks are written
    auto wait = [&](const TailItem& it) {
        if (tid < 32)
            while (!tail_ready<H>(it, done, want, log_r1, tid))
                __nanosleep(256);
    };
    auto rows_of = [&](const TailItem& it) {
        const int64_t pg = it.first * H;
        const int64_t p = pg & ((int64_t(1) << (a3.log_pr - 1)) - 1);
        return SlotRows<R2, R3, H>{(pg >> (a3.log_pr - 1)) << a3.log_n,
                                   (int)(p & ((1 << log_r1) - 1)),
                                   (int)(p >> log_r1), 1 << log_r1};
    };
    // a pass-2 item's loads, asynchronous into buf (transform-fastest:
    // thread tid takes transform tid % T2, points tid / T2 + k TPF2); each
    // of its lines is read once, here, so L1 may keep it; and its twiddle
    // table
    auto issue = [&](const TailItem& it, C* buf, C* steps) {
        const int64_t at =
            transform_at(a2, 0, a2.in_ls, LOG_R2, it.first + tid % T2);
#pragma unroll
        for (int k = 0; k < E; ++k) {
            const int j = tid / T2 + k * TPF2;
            cp_async8_hint(buf + (tid % T2) * G::LD2 + j,
                           z + at + ((int64_t)j << a2.in_ls), evict_first);
        }
        for (int e = tid; e < T2 * E; e += G::THREADS)
            steps[e] = root(lo, hi,
                            tw_mul(it.first + e % T2) * TPF2 * (e / T2),
                            a2.lo_bits);
    };
    // a split item's rows from L2 (ld.global.cg: L1 may hold old lines of
    // its blocks) into the registers, point-fastest over its slots' rows,
    // and from there into buf
    C nx[E];
    auto fetch = [&](const TailItem& it) {
        const SlotRows<R2, R3, H> sr = rows_of(it);
#pragma unroll
        for (int k = 0; k < E; ++k) {
            const int e = tid + k * G::THREADS;
            nx[k] = load_cg(z + sr.at(e >> LOG_R3) + (e & (R3 - 1)),
                            evict_first);
        }
    };
    auto put = [&](C* buf) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
            const int e = tid + k * G::THREADS;
            buf[(e >> LOG_R3) * S::LD + (e & (R3 - 1))] = nx[k];
        }
    };


    // the first item, loaded before the loop; then each turn: the next
    // item's loads in flight while the current one is transformed and
    // stored, and the ticket after it taken and polled
    if (tid < 32) poll(take());
    __syncthreads();
    long long cur = s_next;
    if (cur >= items) {
        sy.leave(tid, epoch);
        return;
    }
    TailItem it = tail_item<R2, R3>(cur, log_r1, pairs);
    if (!s_ready) wait(it);
    __syncthreads();
    int b = 0;
    if (it.split) {
        fetch(it);
        put(bufs);
    } else {
        issue(it, bufs, stepss);
        cp_commit();
        cp_wait<0>();
    }
    if (tid < 32) poll(take());
    __syncthreads();
    long long nxt = s_next;
    bool ready = s_ready;
    for (;;) {
        C* const buf = bufs + b * G::SLOTS;
        C* const other = bufs + (b ^ 1) * G::SLOTS;
        C* const steps = stepss + b * (T2 * E);
        const TailItem nit =
            nxt < items ? tail_item<R2, R3>(nxt, log_r1, pairs) : TailItem{};
        if (nxt < items && !nit.split)
            issue(nit, other, stepss + (b ^ 1) * (T2 * E));
        cp_commit();
        const unsigned long long after = take();
        C u[E];
        if (!it.split) {
            const int64_t g = it.first + f2;
            const C base2 = root(lo, hi, tw_mul(g) * t2, a2.lo_bits);
            G::Core2::run_smem(buf + f2 * G::LD2, u, t2, tab2, false, sgn,
                               Tr(1), [&](int s, C v) {
                                   return cmul(v, cmul(base2,
                                                       steps[s * T2 + f2]));
                               });
            if (tid < 32) poll(after);
            if (nit.split && ready) fetch(nit);
            const int64_t at = transform_at(a2, 0, a2.out_ls, LOG_R2, g);
#pragma unroll
            for (int s = 0; s < E; ++s)
                store_hint(z + at + ((int64_t)(t2 + s * TPF2) << a2.out_ls),
                           u[s], evict_last);
            __syncthreads();  // every store of the item is issued
            if (tid == 0) {
                __threadfence();
                atomicMax(done + it.block, mark);
                atomicAdd(done + it.block, 1ull);
            }
        } else {
            // the rows are in the buffer: drop their lines from L2
            constexpr int LINES = R3 * (int)sizeof(C) / 128;
            const SlotRows<R2, R3, H> sr = rows_of(it);
            for (int l = tid; l < S::T * LINES; l += G::THREADS)
                discard_l2(z + sr.at(l / LINES) +
                           (l % LINES) * (128 / (int)sizeof(C)));
            S::Core::run_smem(buf + f3 * S::LD, u, t3, tab3, false, sgn,
                              Tr(1), [](int, C v) { return v; });
            if (tid < 32) poll(after);
            if (nit.split && ready) fetch(nit);
            const int64_t g = split_transform<S>(a3, it.first, f3);
            split_pairs<R3, false>(a3, buf, u, f3, t3, g);
            if (g >= 0) {
                const int64_t row = g >> a3.log_pr;
                const int64_t c = g & ((int64_t(1) << a3.log_pr) - 1);
#pragma unroll
                for (int s = 0; s < E / 2; ++s) {
                    const int64_t bin =
                        c + ((int64_t)(t3 + s * S::TPF) << a3.log_pr);
                    o.spec.store<true>(row, bin, u[s]);
                    if (row + rows < o.rows)
                        o.spec.store<true>(row + rows, bin, u[s + E / 2]);
                }
            }
        }
        if (nxt >= items) break;
        if (nit.split) {
            if (!ready) {
                wait(nit);
                __syncthreads();
                fetch(nit);
            }
            put(other);
        } else {
            cp_wait<0>();
        }
        // the other buffer holds nxt, cur's reads of its own are done, and
        // s_next / s_ready are set
        __syncthreads();
        cur = nxt;
        it = nit;
        nxt = s_next;
        ready = s_ready;
        b ^= 1;
    }
    cp_wait<0>();
    sy.leave(tid, epoch);
}

// ---------------------------------------------------------------------------
// The fused column launch (fourstep_pass_kernel<RA, RB, false, false>):
// both passes of a two-pass column plan (ops/fourstep_fused.py
// column_plan: an axis of M = RA RB points at stride K, M = 4096..16384) in
// one persistent launch, which hands the intermediate from pass A to pass B
// through L2.  Pass A's transform (b, col) reads and writes the points b +
// RB j of column col; pass B's (o, col) reads the points RA o + j, each
// written by pass A's transforms of the same column.  So a slab of W
// adjacent columns (W = 32 at M = 16384: 4 MiB) is closed under both passes:
// pass B's items of a slab need pass A's items of that slab alone.
//
// What bounds it on the H100: the two passes' separate launches each read
// and write the grid once (at 16384^2 1.59 and 1.54 ms, where a copy of the
// 2 GiB grid takes 1.43); fused, device memory sees one read and one write
// (the row kernel's result in, the output out), and the intermediate is
// written to and read from L2 while a few slabs are in flight.  So what
// bounds the launch is L2: its capacity, which sets how many slabs may be
// in flight, and its throughput, which carries four streams of the grid
// (in, the intermediate out and back, out) where a pass carries two.  The
// SM work of two passes on one sweep's bytes hides under it (on an H100 at
// 16384^2 the launch without its transforms took 2.22 ms, with them
// 2.23).  The design:
//   * one ordered list of work (models/hcore.py column_items): pass A's
//     items of the first LAG slabs, then for each slab q those of q + LAG
//     and pass B's items of q in turn, then pass B's of the last LAG slabs,
//     handed out by an atomic ticket.  LAG + 1 slabs fit a 20 MiB L2 budget
//     (LAG = 4 at 4 MiB slabs): more held in flight and the intermediate no
//     longer stays in L2 (LAG = 8: 3.7 ms), fewer and pass B's items find
//     their slab unfinished (LAG = 2: 2.6 ms, most of them waiting).  A
//     pass-B item waits only for items of lower tickets, and a block waits
//     only with no item of its own unfinished: no deadlock;
//   * two blocks an SM (256 threads, two 32 KiB item buffers each): while
//     an item is transformed and stored its block's next item loads, and
//     the ticket after that is taken, its counter polled at the end of the
//     item; the stores are not waited for.  Three blocks an SM held so
//     many tickets that the lag needed for them overflowed L2 (3.07 ms);
//   * the device words are the tail's scheme: the ticket, a count of
//     pass-B items whose slab was not done when polled (column_waits()),
//     the epoch of the last launch, the blocks that have left, one counter
//     a slab of pass-A items done (atomicMax to this launch's epoch, then
//     +1; the stores, __syncthreads and __threadfence before it), so that a
//     launch needs nothing from the host (a CUDA graph replays it);
//   * an item is T = 4096 / R adjacent transforms (columns) of R points,
//     32 KiB, point-major in its buffer (hcore.cuh's Core with the point
//     stride LDS = T): each of its R rows is a contiguous run of the grid
//     (256 bytes at T = 32), loaded by 16-byte cp.async.cg (L2, never L1:
//     no SM holds an old line of the intermediate) and read by the stages
//     with the 32 lanes of a warp across 32 transforms, so every
//     shared-memory access of a warp is one row's contiguous 256 bytes, and
//     every store a 256-byte run;
//   * pass A reads with an evict_first hint, writes the intermediate with
//     evict_last, and counts the item; pass B reads the intermediate, then
//     discards its lines (discard.global.L2: the intermediate is dead, each
//     line has one reader, so it is never written back; without it 2.58
//     against 2.35 ms at LAG = 3), and streams its output (st.global.cs);
//   * the same arithmetic as the two launches, bit for bit on the H100:
//     pass A's twiddle W_N^(mul t) W_N^(mul TPF s) (mul blind to the
//     column, tw_lo) from a per-item table of R products, the scale on pass
//     A's input, the core.
// ---------------------------------------------------------------------------

// One side of the fused column launch at radix R: an item of T = 4096 / R
// transforms, E = 16 points a thread, lanes across 32 transforms.
template <int R>
struct ColSide {
    static constexpr int T = 4096 / R;
    static constexpr int E = 16;
    static constexpr int TPF = R / E;
    static constexpr int FW = T < 32 ? T : 32;
    using Core = hc::Core<R, TPF, false, false, false, T>;
};

// The fused column launch's layout (models/hcore.py column_geometry): W
// columns a slab, NI items a side a slab, LAG slabs between a slab's pass-A
// items and its pass-B items, two item buffers, the two stage tables and
// pass A's twiddle products.
template <int RA, int RB>
struct ColTile {
    using A = ColSide<RA>;
    using B = ColSide<RB>;
    static constexpr int THREADS = 256;
    static constexpr int W = A::T > B::T ? A::T : B::T;
    static constexpr int NI = W / A::T * RB;
    static constexpr int64_t SLAB = (int64_t)RA * RB * W * 8;
    static constexpr int64_t L2_BUDGET = int64_t(20) << 20;
    static constexpr int LAG = (int)(L2_BUDGET / SLAB) - 1;
    static constexpr int SLOTS = 4096;
    static constexpr size_t SMEM =
        ((size_t)2 * SLOTS + A::Core::TAB + B::Core::TAB + RA) *
        sizeof(float2);
    static_assert(A::T * A::TPF == THREADS && B::T * B::TPF == THREADS &&
                      NI == W / B::T * RA && LAG >= 1 &&
                      (NI & (NI - 1)) == 0,
                  "both sides' items share the threads and a slab");
};

// One item of the fused column launch: its side, its slab, and its first
// transform (of that pass's batch * N / R).
struct ColItem {
    bool b;
    int64_t slab, first;
};

// Ticket i's item (models/hcore.py column_item): pass A's items of the
// first LAG slabs, then for each slab q those of q + LAG and pass B's of q
// in turn, then pass B's of the last LAG slabs.  A slab is W columns of a
// row (K / W slabs a row, 2^log_spr); pass A's item u of slab q is
// transforms b * K + col of b = u / (W / TA), pass B's o * K + col of o =
// u / (W / TB), each T adjacent columns.
template <int RA, int RB>
__device__ __forceinline__ ColItem col_item(int64_t i, int64_t slabs,
                                            int log_spr, int log_k) {
    using G = ColTile<RA, RB>;
    constexpr int NI = G::NI;
    const int64_t lag = slabs < G::LAG ? slabs : G::LAG;
    int64_t q, u;
    bool b;
    if (i < lag * NI) {
        b = false, q = i / NI, u = i % NI;
    } else if (i < lag * NI + (slabs - lag) * 2 * NI) {
        const int64_t r = i - lag * NI;
        const int64_t k = r / (2 * NI);
        b = r & 1;
        q = b ? k : k + lag;
        u = (r % (2 * NI)) >> 1;
    } else {
        const int64_t r = i - lag * NI - (slabs - lag) * 2 * NI;
        b = true, q = slabs - lag + r / NI, u = r % NI;
    }
    const int64_t row = q >> log_spr;
    const int64_t col = (q & ((int64_t(1) << log_spr) - 1)) * G::W;
    constexpr int TA = G::A::T, TB = G::B::T;
    if (!b)
        return {false, q,
                ((row * RB + u / (G::W / TA)) << log_k) + col +
                    (u % (G::W / TA)) * TA};
    return {true, q,
            ((row * RA + u / (G::W / TB)) << log_k) + col +
                (u % (G::W / TB)) * TB};
}

__device__ __forceinline__ void cp_async16_hint(void* dst, const void* src,
                                                unsigned long long pol) {
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
        :: "r"(smem_addr(dst)), "l"(src), "l"(pol));
}

template <int RA, int RB, bool EXACT, bool SPLIT>
__global__ void __launch_bounds__(ColTile<RA, RB>::THREADS, 2)
fourstep_pass_kernel(PassArgs a, PassArgs b, TailSync sy, double scale,
                     const float2* __restrict__ twa,
                     const float2* __restrict__ twb,
                     const float2* __restrict__ lo,
                     const float2* __restrict__ hi, int inverse) {
    static_assert(!EXACT && !SPLIT,
                  "the fused column launch is fp32, with no split");
    using G = ColTile<RA, RB>;
    using SA = typename G::A;
    using SB = typename G::B;
    using C = float2;
    using Tr = float;
    constexpr int E = 16;
    C* const bufs = shared_buffer<C>();   // two item buffers
    C* const taba = bufs + 2 * G::SLOTS;
    C* const tabb = taba + SA::Core::TAB;
    C* const twk = tabb + SB::Core::TAB;  // W_N^(mul t) W_N^(mul TPF s)
    __shared__ long long s_next;
    __shared__ int s_ready;
    const int tid = threadIdx.x;
    const Tr sgn = inverse ? Tr(1) : Tr(-1);
    const int fa = tid % SA::FW + SA::FW * (tid / (SA::FW * SA::TPF));
    const int ta = (tid / SA::FW) % SA::TPF;
    const int fb = tid % SB::FW + SB::FW * (tid / (SB::FW * SB::TPF));
    const int tb = (tid / SB::FW) % SB::TPF;
    const int log_k = b.in_ls;
    const int log_spr = log_k - ilog2(G::W);
    const int64_t slabs = (b.total >> b.log_pr) << log_spr;
    const int64_t items = slabs * 2 * G::NI;
    const float2* const src = static_cast<const float2*>(a.in.a);
    float2* const mid = static_cast<float2*>(a.out.a);
    float2* const dst = static_cast<float2*>(b.out.a);
    unsigned long long* const ticket = sy.words;
    unsigned long long* const waits = sy.words + 1;
    unsigned long long* const done = sy.words + 4;
    const unsigned long long epoch = sy.epoch(tid);
    const unsigned long long mark = epoch << 16;
    const unsigned long long want = mark + G::NI;
    const unsigned long long evict_first = l2_policy_first();
    const unsigned long long evict_last = l2_policy_last();

    SA::Core::fill(taba, twa, tid, G::THREADS);
    SB::Core::fill(tabb, twb, tid, G::THREADS);

    auto decode = [&](long long i) {
        return col_item<RA, RB>(i, slabs, log_spr, log_k);
    };
    // thread 0: whether item it may be loaded (pass A always; pass B once
    // its slab's pass-A items are all done)
    auto ready = [&](const ColItem& it) {
        return !it.b || load_acquire(done + it.slab) >= want;
    };
    // thread 0: the ticket t into s_next, and whether its item may be
    // loaded into s_ready, counting a pass-B item that may not
    auto poll = [&](unsigned long long t) {
        const bool ok = (long long)t >= items || ready(decode(t));
        if (!ok) atomicAdd(waits, 1ull);
        s_next = (long long)t;
        s_ready = ok;
    };
    // thread 0 waits for item it's slab; a wait of over 2^26 polls (~17 s
    // and more) traps, so that a fault cannot hang the card
    auto wait = [&](const ColItem& it) {
        if (tid == 0)
            for (unsigned n = 0; !ready(it); ++n) {
                if (n >> 26) __trap();
                __nanosleep(256);
            }
    };
    // an item's loads into buf: R rows of T points, 16 bytes a copy
    auto issue = [&](const ColItem& it, C* buf) {
        if (!it.b) {
            constexpr int T = SA::T, LOG_T = ilog2(T / 2);
            const int64_t at = transform_at(a, 0, a.in_ls, ilog2(RA),
                                            it.first);
#pragma unroll
            for (int k = 0; k < RA * T / 2 / G::THREADS; ++k) {
                const int e = tid + k * G::THREADS;
                const int j = e >> LOG_T, c = 2 * (e & (T / 2 - 1));
                cp_async16_hint(buf + j * T + c,
                                src + at + c + ((int64_t)j << a.in_ls),
                                evict_first);
            }
        } else {
            constexpr int T = SB::T, LOG_T = ilog2(T / 2);
            const int64_t at = transform_at(b, 0, b.in_ls, ilog2(RB),
                                            it.first);
#pragma unroll
            for (int k = 0; k < RB * T / 2 / G::THREADS; ++k) {
                const int e = tid + k * G::THREADS;
                const int j = e >> LOG_T, c = 2 * (e & (T / 2 - 1));
                cp_async16_hint(buf + j * T + c,
                                mid + at + c + ((int64_t)j << b.in_ls),
                                evict_first);
            }
        }
    };

    if (tid == 0) poll(atomicAdd(ticket, 1ull));
    __syncthreads();
    long long cur = s_next;
    if (cur >= items) {
        sy.leave(tid, epoch);
        return;
    }
    ColItem it = decode(cur);
    if (!s_ready) wait(it);
    __syncthreads();
    issue(it, bufs);
    cp_commit();
    if (tid == 0) poll(atomicAdd(ticket, 1ull));
    __syncthreads();
    long long nxt = s_next;
    bool ready_next = s_ready;
    int sel = 0;
    for (;;) {
        C* const buf = bufs + sel * G::SLOTS;
        C* const other = bufs + (sel ^ 1) * G::SLOTS;
        const ColItem nit = nxt < items ? decode(nxt) : ColItem{};
        const bool early = nxt < items && ready_next;
        if (early) issue(nit, other);
        cp_commit();
        const unsigned long long after =
            tid == 0 ? atomicAdd(ticket, 1ull) : 0ull;
        cp_wait<1>();
        __syncthreads();  // buf holds it
        C u[E];
        if (!it.b) {
            // pass A: W_N^(mul k), k = t + s TPF, as the plain pass forms
            // it (mul = the item's b K: every column of the item has it)
            if (tid < RA) {
                const int64_t mul = (it.first & ((int64_t(1) << a.log_pr) -
                                                 1) & a.tw_mask)
                                    << a.log_tw_step;
                twk[tid] = cmul(
                    root(lo, hi, mul * (tid % SA::TPF), a.lo_bits),
                    root(lo, hi, mul * SA::TPF * (tid / SA::TPF),
                         a.lo_bits));
            }
            SA::Core::run_smem(buf + fa, u, ta, taba, false, sgn,
                               Tr(scale), [&](int s, C v) {
                                   return cmul(v, twk[ta + s * SA::TPF]);
                               });
            const int64_t at = transform_at(a, 0, a.out_ls, ilog2(RA),
                                            it.first) + fa;
#pragma unroll
            for (int s = 0; s < E; ++s)
                store_hint(mid + at +
                               ((int64_t)(ta + s * SA::TPF) << a.out_ls),
                           u[s], evict_last);
            __syncthreads();  // every store of the item is issued
            if (tid == 0) {
                __threadfence();
                atomicMax(done + it.slab, mark);
                atomicAdd(done + it.slab, 1ull);
            }
        } else {
            // the rows are in the buffer: drop their lines from L2
            constexpr int LINES = SB::T * (int)sizeof(C) / 128;
            const int64_t at = transform_at(b, 0, b.in_ls, ilog2(RB),
                                            it.first);
            for (int l = tid; l < RB * LINES; l += G::THREADS)
                discard_l2(mid + at + ((int64_t)(l / LINES) << b.in_ls) +
                           (l % LINES) * (128 / (int)sizeof(C)));
            SB::Core::run_smem(buf + fb, u, tb, tabb, false, sgn, Tr(1),
                               [](int, C v) { return v; });
            const int64_t out = transform_at(b, 0, b.out_ls, ilog2(RB),
                                             it.first) + fb;
#pragma unroll
            for (int s = 0; s < E; ++s)
                __stcs(dst + out + ((int64_t)(tb + s * SB::TPF) << b.out_ls),
                       u[s]);
        }
        if (nxt >= items) break;
        if (!early) {
            wait(nit);
            __syncthreads();
            issue(nit, other);
            cp_commit();
        }
        if (tid == 0) poll(after);
        // other holds (or is loading) nxt, every read of buf is done, and
        // s_next / s_ready are set
        __syncthreads();
        cur = nxt;
        it = nit;
        nxt = s_next;
        ready_next = s_ready;
        sel ^= 1;
    }
    cp_wait<0>();
    sy.leave(tid, epoch);
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

// The fused tail over the items of a2 / a3's rows.
template <int R2, int R3>
cudaError_t launch_tail(const PassArgs& a2, const PassArgs& a3,
                        const SplitOut& out, const TailSync& sy,
                        const void* tw2, const void* tw3, const void* lo,
                        const void* hi, cudaStream_t stream) {
    using G = TailTile<R2, R3>;
    void (*kernel)(PassArgs, PassArgs, SplitOut, TailSync, const float2*,
                   const float2*, const float2*, const float2*) =
        fourstep_pass_kernel<R2, R3, false, true, true>;
    const int64_t rows = a3.total >> a3.log_pr;
    if ((int64_t(1) << a3.lr[0]) % (2 * G::H)) return cudaErrorInvalidValue;
    const int64_t items =
        (rows << a3.lr[0]) / (2 * G::H) * (G::NP + G::NC);
    unsigned grid = 0;
    cudaError_t err =
        persistent_grid(kernel, G::THREADS, G::SMEM, items, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
        a2, a3, out, sy, static_cast<const float2*>(tw2),
        static_cast<const float2*>(tw3), static_cast<const float2*>(lo),
        static_cast<const float2*>(hi));
    return cudaGetLastError();
}

// The fused column launch over a's and b's transforms.
template <int RA, int RB>
cudaError_t launch_cols(const PassArgs& a, const PassArgs& b,
                        const TailSync& sy, double scale, const void* twa,
                        const void* twb, const void* lo, const void* hi,
                        int inverse, cudaStream_t stream) {
    using G = ColTile<RA, RB>;
    void (*kernel)(PassArgs, PassArgs, TailSync, double, const float2*,
                   const float2*, const float2*, const float2*, int) =
        fourstep_pass_kernel<RA, RB, false, false>;
    if ((int64_t(1) << b.in_ls) < G::W) return cudaErrorInvalidValue;
    const int64_t items =
        (b.total >> b.log_pr) * ((int64_t(1) << b.in_ls) / G::W) * 2 * G::NI;
    unsigned grid = 0;
    cudaError_t err =
        persistent_grid(kernel, G::THREADS, G::SMEM, items, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
        a, b, sy, scale, static_cast<const float2*>(twa),
        static_cast<const float2*>(twb), static_cast<const float2*>(lo),
        static_cast<const float2*>(hi), inverse);
    return cudaGetLastError();
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
// twiddle; tw_lo, a power of two to tw_s (1 but in a column route's first
// pass), clears the low bits of the twiddle's column.  tw: W_radix^m, m < radix; lo, hi: W_n^j, j < 2^lo_bits, and
// W_n^(i * 2^lo_bits); all three (re, im) float32 pairs, or float64 when
// exact != 0.  spec_layout >= 0: the pass is a plan's last (row map in,
// columns of stride n / radix out, no twiddle, radix <= 256) and writes
// the pair split of its output into spec_rows rows of packed spectra of
// n/2 bins at out_a / out_b in layout spec_layout (0 planar pair, 1 packed
// complex64, 2 numpy complex64 of n/2 + 1 bins), the q rows batch after
// the p rows (out_kind unused); -1: out is the pass's output.
// tail_radix > 0 and spec_layout >= 0: the fused tail, radix = tail_radix
// = 128.  The pass given (columns of stride tail_radix in and out, tw_s =
// tail_radix, fp32) runs in place on the complex64 intermediate at in_a
// (128-byte aligned), then the plan's last pass of radix tail_radix over
// the digit-reversed rows (n / (radix * tail_radix), radix) writes its
// pair split as above; tw_tail is the W_tail_radix table, sync the device
// words (the ticket, the waits, the epoch, the blocks left, then a counter
// for each of the batch * n / (radix * tail_radix) blocks), zeros before
// the first launch on them and left as the last launch leaves them, one
// launch on them at a time.  tail_radix > 0 and spec_layout = -1: the
// fused column launch of an axis of m = radix * tail_radix points at
// stride k = n / m (radix, tail_radix) = (64, 64), (128, 64) or (128,
// 128), k at least the slab's columns (64, 64, 32), fp32: the pass given
// (pass A: columns of stride tail_radix * k in and out, tw_s = tail_radix
// * k, tw_lo = k) from in_a (complex64, 16-byte aligned) into mid (the
// complex64 intermediate, 128-byte aligned; in_a itself for a pass in
// place), then pass B of radix tail_radix from columns of stride k of mid
// into columns of stride radix * k of out_a (complex64); sync as the
// tail's, a counter for each of the batch * k / columns slabs.  Returns a
// cudaError_t (0 on success).
int smfft_fourstep_pass(void* in_a, void* in_b, int in_kind, int in_map,
                        int64_t in_s, void* out_a, void* out_b, int out_kind,
                        int out_map, int64_t out_s, int nr, int64_t r0,
                        int64_t r1, int64_t r2, int64_t r3, int64_t batch,
                        int64_t n, int64_t radix, int64_t tw_s,
                        int64_t tw_lo, double scale,
                        const void* tw, const void* lo, const void* hi,
                        int lo_bits, int inverse, int exact, int spec_layout,
                        int64_t spec_rows, int64_t tail_radix,
                        const void* tw_tail, void* sync, void* mid,
                        void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (nr < 0 || nr > 4 || n % radix || tw_lo < 1 || (tw_lo & (tw_lo - 1)) ||
        (tw_lo > 1 && (tw_lo > tw_s || spec_layout >= 0)))
        return (int)cudaErrorInvalidValue;
    const bool split = spec_layout >= 0;
    const bool tail = tail_radix > 0 && split;
    const bool cols = tail_radix > 0 && !split;
    if (cols && (exact || in_kind != 0 || out_kind != 0 || in_map != 0 ||
                 out_map != 0 || in_s != out_s || tw_s != in_s || nr != 0 ||
                 !sync || !tw_tail || !mid || (uintptr_t)in_a % 16 ||
                 (uintptr_t)mid % 128 || n % (radix * tail_radix) ||
                 tw_lo != n / (radix * tail_radix) ||
                 in_s != tail_radix * tw_lo))
        return (int)cudaErrorInvalidValue;
    if (tail && (exact || inverse || in_kind != 0 ||
                 in_map != 0 || out_map != 0 || in_s != tail_radix ||
                 out_s != tail_radix || tw_s != tail_radix || nr != 0 ||
                 !sync || !tw_tail ||
                 n % (radix * tail_radix) || (uintptr_t)in_a % 128))
        return (int)cudaErrorInvalidValue;
    if (split && !tail &&
        (spec_layout > 2 || in_map != 1 || out_map != 0 ||
         out_s != n / radix || tw_s != 0 || n / radix < 2))
        return (int)cudaErrorInvalidValue;
    if (split && (spec_layout > 2 || spec_rows < batch ||
                  spec_rows > 2 * batch))
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
    args.tw_mask = tw_s ? (tw_s - 1) & ~(tw_lo - 1) : -1;
    args.log_tw_step = tw_s ? ilog2_64(n / (radix * tw_s)) : 0;
    args.lo_bits = lo_bits;
    const SplitOut out{Spectrum{static_cast<float*>(out_a),
                                static_cast<float*>(out_b), spec_layout,
                                n / 2},
                       spec_rows};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cols) {
        // pass A from in_a into mid; pass B from mid into out_a
        args.out = Cells{mid, nullptr, 0};
        PassArgs pb{};
        pb.in = args.out;
        pb.out = Cells{out_a, nullptr, 0};
        pb.in_ls = ilog2_64(tw_lo);
        pb.out_ls = ilog2_64(radix * tw_lo);
        pb.log_n = args.log_n;
        pb.log_pr = ilog2_64(n / tail_radix);
        pb.total = batch * (n / tail_radix);
        pb.tw_mask = -1;
        pb.lo_bits = lo_bits;
        const TailSync sy{static_cast<unsigned long long*>(sync)};
#define SMFFT_COLS(RA, RB)                                                 \
    if (radix == RA && tail_radix == RB)                                   \
        return (int)launch_cols<RA, RB>(args, pb, sy, scale, tw, tw_tail,  \
                                        lo, hi, inverse, st);
        SMFFT_COLS(64, 64)
        SMFFT_COLS(128, 64)
        SMFFT_COLS(128, 128)
#undef SMFFT_COLS
        return (int)cudaErrorInvalidValue;
    }
    if (tail) {
        // pass 2 in place; the split pass over rows (R1, R2) of radix R3
        const int64_t q = n / (radix * tail_radix);
        if (q < 1 || (q & (q - 1)) || (tail_radix & (tail_radix - 1)))
            return (int)cudaErrorInvalidValue;
        args.out = args.in;
        PassArgs last{};
        last.in = args.in;
        last.in_map = 1;
        last.nr = 2;
        last.lr[0] = ilog2_64(q);
        last.lr[1] = ilog2_64(radix);
        last.log_n = args.log_n;
        last.log_pr = ilog2_64(n / tail_radix);
        last.total = batch * (n / tail_radix);
        last.tw_mask = -1;
        last.lo_bits = lo_bits;
        const TailSync sy{static_cast<unsigned long long*>(sync)};
        if (radix == 128 && tail_radix == 128)
            return (int)launch_tail<128, 128>(args, last, out, sy, tw,
                                              tw_tail, lo, hi, st);
        return (int)cudaErrorInvalidValue;
    }
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
