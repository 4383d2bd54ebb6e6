// The in-block FFT core for Hopper of bluestein_kernel (chirp.cu),
// fourstep_pass_kernel (fourstep.cu), c2c_kernel (c2c.cu), the R2C and C2R
// kernels (real.cu), the reuse loops (multiple.cu) and the fused
// convolutions (conv.cu): an M-point transform (M = 16..16384) by TPF
// threads, E = M / TPF points a thread, in shared memory and registers.
// The other kernels keep stockham.cuh; this header only borrows its
// complex helpers.
//
// Thread t holds the points t + s*TPF (s < E) of its transform in u[s],
// natural order, before the first stage (Core::run_regs) and after the
// last.  Stages (models/hcore.py writes the same index maps out):
//   * the ladder is radix-16 stages (p = 1, 16, 256, ...) and one last
//     stage of radix RL = 2, 4, 8 or 16: m = 2048 is 16*16*8, two
//     exchanges through shared memory where stockham.cuh's radix-8 ladder
//     takes three;
//   * stage 0 takes its operands from registers (run_regs) or from a
//     staged tile in shared memory (run_smem); the middle stages go shared
//     memory to shared memory; the last stage returns its outputs to u;
//   * with two buffers a stage reads one and writes the other (one barrier
//     a stage); with one it reads, synchronises and writes in place (two);
//   * PAD stores point idx at idx + idx/16 (one pad element after every
//     16), which with the kernels' slot strides keeps every access of a
//     warp at the minimum of 2 wavefronts for 8-byte elements and 4 for
//     16-byte ones (tests/test_torch_hcore.py counts them);
//   * the stage twiddles come from a block-local table in shared memory,
//     W_(p*R)^k for k < p per stage (Core::TAB entries, filled once a
//     block from the W_M table), one read a butterfly; the powers W^(r*k)
//     are products in registers (at most four deep).  With ANCH (the row
//     kernels) the radix-8 and radix-16 stages also keep W^(4k), and each
//     power is at most three products from a table entry;
//   * HALF skips the first stage's operands r >= 8 (inputs j >= M/2 that
//     are zero), LOWER computes only the last stage's outputs r < RL/2
//     (the points k < M/2);
//   * the last stage hands each output to an epilogue unrounded (a
//     product, a twiddle) before it is stored in the registers' type, or
//     (Core::run_regs_out) to a store into shared memory;
//   * RowGeometry lays out the row kernels' blocks (F rows of TPF
//     threads) and their revblock staging.
// Two number types as in stockham.cuh: C the arithmetic, S the storage.

#pragma once

#include "stockham.cuh"

namespace smfft {
namespace hc {

template <typename C>
__device__ __forceinline__ C conj_if(C w, bool cj) {
    return cj ? cmake(w.x, -w.y) : w;
}

// W_16^e = exp(s * 2 pi i e / 16) applied to a, for the exponents the
// radix-8 and radix-16 DFTs use.
template <int E, typename C>
__device__ __forceinline__ C w16(C a, real_t<C> s) {
    using T = real_t<C>;
    static_assert(E == 1 || E == 2 || E == 3 || E == 4 || E == 6 || E == 9,
                  "an exponent the DFTs below use");
    if (E == 4) return mul_si(a, s);
    const T c1 = static_cast<T>(0.92387953251128675613);  // cos(pi/8)
    const T s1 = static_cast<T>(0.38268343236508977173);  // sin(pi/8)
    const T h = static_cast<T>(0.70710678118654752440);   // cos(pi/4)
    const T re = E == 1 ? c1 : E == 2 ? h : E == 3 ? s1 : E == 6 ? -h : -c1;
    const T im = E == 1 ? s1 : E == 2 ? h : E == 3 ? c1 : E == 6 ? h : -s1;
    return cmul(a, cmake(re, s * im));
}

// In-register DFT of R points, natural order, sign s.  HALF (radix 4 and
// 16): u[R/2..] are zeros and are not read; LOWER: only u[0..R/2) are
// computed (the rest is left as it was).
template <int R, bool HALF, bool LOWER> struct Dft;

template <bool HALF, bool LOWER> struct Dft<2, HALF, LOWER> {
    static_assert(!HALF, "only the first stage, radix 16, skips inputs");
    template <typename C>
    static __device__ __forceinline__ void run(C* u, real_t<C>) {
        const C a = u[0], b = u[1];
        u[0] = cadd(a, b);
        if (!LOWER) u[1] = csub(a, b);
    }
};

template <bool HALF, bool LOWER> struct Dft<4, HALF, LOWER> {
    template <typename C>
    static __device__ __forceinline__ void run(C* u, real_t<C> s) {
        if (HALF) {
            const C a = u[0], b = u[1];
            const C sb = mul_si(b, s);
            u[0] = cadd(a, b);
            u[1] = cadd(a, sb);
            if (!LOWER) {
                u[2] = csub(a, b);
                u[3] = csub(a, sb);
            }
            return;
        }
        const C t0 = cadd(u[0], u[2]), t1 = csub(u[0], u[2]);
        const C t2 = cadd(u[1], u[3]);
        const C t3 = mul_si(csub(u[1], u[3]), s);
        u[0] = cadd(t0, t2);
        u[1] = cadd(t1, t3);
        if (!LOWER) {
            u[2] = csub(t0, t2);
            u[3] = csub(t1, t3);
        }
    }
};

template <bool HALF, bool LOWER> struct Dft<8, HALF, LOWER> {
    static_assert(!HALF, "only the first stage, radix 16, skips inputs");
    template <typename C>
    static __device__ __forceinline__ void run(C* u, real_t<C> s) {
        C e[4] = {u[0], u[2], u[4], u[6]};
        C o[4] = {u[1], u[3], u[5], u[7]};
        Dft<4, false, false>::run(e, s);
        Dft<4, false, false>::run(o, s);
        o[1] = w16<2>(o[1], s);
        o[2] = w16<4>(o[2], s);
        o[3] = w16<6>(o[3], s);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            u[k] = cadd(e[k], o[k]);
            if (!LOWER) u[k + 4] = csub(e[k], o[k]);
        }
    }
};

// 16 = 4 x 4: n = 4 n1 + n2, k = k1 + 4 k2.
template <bool HALF, bool LOWER> struct Dft<16, HALF, LOWER> {
    template <typename C>
    static __device__ __forceinline__ void run(C* u, real_t<C> s) {
        C y[4][4];
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
            y[n2][0] = u[n2];
            y[n2][1] = u[4 + n2];
            if (!HALF) {
                y[n2][2] = u[8 + n2];
                y[n2][3] = u[12 + n2];
            }
            Dft<4, HALF, false>::run(y[n2], s);
        }
        y[1][1] = w16<1>(y[1][1], s);
        y[1][2] = w16<2>(y[1][2], s);
        y[1][3] = w16<3>(y[1][3], s);
        y[2][1] = w16<2>(y[2][1], s);
        y[2][2] = w16<4>(y[2][2], s);
        y[2][3] = w16<6>(y[2][3], s);
        y[3][1] = w16<3>(y[3][1], s);
        y[3][2] = w16<6>(y[3][2], s);
        y[3][3] = w16<9>(y[3][3], s);
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1) {
            C v[4] = {y[0][k1], y[1][k1], y[2][k1], y[3][k1]};
            Dft<4, false, LOWER>::run(v, s);
            u[k1] = v[0];
            u[k1 + 4] = v[1];
            if (!LOWER) {
                u[k1 + 8] = v[2];
                u[k1 + 12] = v[3];
            }
        }
    }
};

// v[r] *= w^r, r = 1..R-1, the powers as products of powers of two (w^(2^j)
// by squaring, the rest w^r = w^(r - 2^j) * w^(2^j)).
template <int R, typename C>
__device__ __forceinline__ void twiddle(C (&v)[R], C w) {
    static_assert(R <= 16, "radix 16 at most");
    C p[R];
    p[1] = w;
#pragma unroll
    for (int r = 2; r < R; ++r) {
        // the highest power of two <= r, a constant once unrolled
        const int hb = r >= 8 ? 8 : (r >= 4 ? 4 : 2);
        p[r] = hb == r ? cmul(p[r / 2], p[r / 2]) : cmul(p[r - hb], p[hb]);
    }
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], p[r]);
}

__host__ __device__ constexpr int pow16(int s) {
    return s == 0 ? 1 : 16 * pow16(s - 1);
}
// stages of an M-point ladder, the radix of stage s, and where its
// twiddles start in the block's table
__host__ __device__ constexpr int nstages(int m) {
    return (ilog2(m) + 3) / 4;
}
__host__ __device__ constexpr int stage_radix(int m, int s) {
    return s < nstages(m) - 1 ? 16 : (ilog2(m) % 4 ? 1 << (ilog2(m) % 4) : 16);
}
__host__ __device__ constexpr int tab_off(int s) {
    return (pow16(s) - 16) / 15;
}

// v[r] *= w^r, r = 1..R-1 (R = 8 or 16), from two table entries w and
// w4 = w^4: w^(4a+b) = (w^4)^a w^b, a, b < 4, so that no power is more
// than three products from a table entry (twiddle's squarings carry the
// rounding of w to w^8 eightfold).
template <int R, typename C>
__device__ __forceinline__ void twiddle_anchored(C (&v)[R], C w, C w4) {
    static_assert(R == 8 || R == 16, "radix 8 or 16");
    const C w2 = cmul(w, w);
    const C lo[4] = {w, w, w2, cmul(w2, w)};  // lo[b] = w^b, b >= 1
    const C w8 = cmul(w4, w4);
    const C hi[4] = {w4, w4, w8, cmul(w8, w4)};  // hi[a] = w^(4a), a >= 1
#pragma unroll
    for (int r = 1; r < R; ++r) {
        const int a = r >> 2, b = r & 3;
        v[r] = cmul(v[r], a == 0 ? lo[b] : (b == 0 ? hi[a]
                                                   : cmul(hi[a], lo[b])));
    }
}

// The transform of one M-point row by TPF threads.  PAD: the padded
// positions inside a buffer; PP: two buffers a, b (one barrier a stage),
// else in place in a.  ANCH: the radix-8 and radix-16 stages keep W^(4k)
// beside W^k in the table and take their powers by twiddle_anchored (the
// fp32 error of the products four deep was up to 3.3x the stockham.cuh
// kernels', which read every power from the W_M table).  LDS: the distance
// between a row's consecutive points in its buffer (fourstep.cu's fused
// column launch keeps its tiles point-major, LDS transforms a point).
template <int M, int TPF, bool PAD, bool PP, bool ANCH = false, int LDS = 1>
struct Core {
    static constexpr int E = M / TPF;
    static constexpr int NS = nstages(M);
    static constexpr int RL = stage_radix(M, NS - 1);
    // whether stage s keeps its anchors W^(4k), and where its entries start
    // in the table: 16 + 256 + ... for stages 1..NS-1 (twice for anchors)
    __host__ __device__ static constexpr bool anchored(int s) {
        return ANCH && stage_radix(M, s) >= 8;
    }
    __host__ __device__ static constexpr int off(int s) {
        return s <= 1 ? 0
                      : off(s - 1) + pow16(s - 1) * (anchored(s - 1) ? 2 : 1);
    }
    // twiddle table entries
    static constexpr int TAB = off(NS);
    // whether run_regs's last stage reads b, so that a may be written at
    // once after it
    static constexpr bool LAST_READS_B = PP && NS % 2 == 1;
    static_assert(E >= 16 && E % 16 == 0, "a thread holds 16k points");

    static __device__ __forceinline__ int pos(int idx) {
        return (PAD ? idx + (idx >> 4) : idx) * LDS;
    }

    // The stage tables from the W_M table tw: stage s (p = 16^s, radix
    // R_s) at tab_off(s), W_(p R_s)^k = W_M^(k M / (p R_s)), k < p.
    template <typename C, typename W>
    static __device__ __forceinline__ void fill(C* tab,
                                                const W* __restrict__ tw,
                                                int tid, int nthreads) {
        fill_stage<1>(tab, tw, tid, nthreads);
    }
    template <int SI, typename C, typename W>
    static __device__ __forceinline__ void fill_stage(
        C* tab, const W* __restrict__ tw, int tid, int nthreads) {
        if constexpr (SI < NS) {
            constexpr int P = pow16(SI), OFF = off(SI);
            constexpr int STEP = M / (P * stage_radix(M, SI));
            for (int k = tid; k < P; k += nthreads) {
                tab[OFF + k] = as<C>(__ldg(&tw[k * STEP]));
                if (anchored(SI))
                    tab[OFF + P + k] = as<C>(__ldg(&tw[4 * k * STEP]));
            }
            fill_stage<SI + 1>(tab, tw, tid, nthreads);
        }
    }

    // Twiddle (stages s >= 1) and DFT of butterfly i of stage SI.
    template <int SI, bool LOWER, typename C>
    static __device__ __forceinline__ void butterfly(
        C (&v)[stage_radix(M, SI)], int i, const C* tab, bool cj,
        real_t<C> sg) {
        constexpr int P = pow16(SI), OFF = off(SI);
        if constexpr (SI > 0 && anchored(SI)) {
            const int k = i & (P - 1);
            twiddle_anchored(v, conj_if(tab[OFF + k], cj),
                             conj_if(tab[OFF + P + k], cj));
        } else if (SI > 0) {
            twiddle(v, conj_if(tab[OFF + (i & (P - 1))], cj));
        }
        Dft<stage_radix(M, SI), false, LOWER>::run(v, sg);
    }

    // Middle stage SI (radix 16): reads src, writes dst in Stockham order,
    // then synchronises; in place (src == dst) all reads finish first.
    template <int SI, bool INPLACE, typename C, typename S>
    static __device__ __forceinline__ void middle(const S* src, S* dst,
                                                  int t, const C* tab,
                                                  bool cj, real_t<C> sg) {
        constexpr int P = pow16(SI);
        constexpr int Q = E / 16;
        constexpr int STEP = M / 16;
        S raw[Q][16];
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int r = 0; r < 16; ++r)
                raw[q][r] = src[pos(t + q * TPF + r * STEP)];
        if (INPLACE) __syncthreads();
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int i = t + q * TPF;
            C v[16];
#pragma unroll
            for (int r = 0; r < 16; ++r) v[r] = as<C>(raw[q][r]);
            butterfly<SI, false>(v, i, tab, cj, sg);
            const int k = i & (P - 1);
#pragma unroll
            for (int r = 0; r < 16; ++r)
                put(dst[pos((i - k) * 16 + k + r * P)], v[r]);
        }
        __syncthreads();
    }

    // The middle stages SI..NS-2, reading a first; returns the buffer the
    // last stage reads.
    template <int SI, typename C, typename S>
    static __device__ __forceinline__ const S* middles(S* a, S* b, int t,
                                                       const C* tab, bool cj,
                                                       real_t<C> sg) {
        if constexpr (SI >= NS - 1) {
            return a;
        } else if constexpr (PP) {
            middle<SI, false>(a, b, t, tab, cj, sg);
            return middles<SI + 1>(b, a, t, tab, cj, sg);
        } else {
            middle<SI, true>(a, a, t, tab, cj, sg);
            return middles<SI + 1>(a, a, t, tab, cj, sg);
        }
    }

    // Stage 0 (radix 16, p = 1) from registers into a.  HALF: only the
    // operands r < 8 are read.
    template <bool HALF, typename C, typename S, typename U>
    static __device__ __forceinline__ void first_regs(const U (&u)[E], S* a,
                                                      int t, real_t<C> sg) {
#pragma unroll
        for (int q = 0; q < E / 16; ++q) {
            C v[16];
#pragma unroll
            for (int r = 0; r < (HALF ? 8 : 16); ++r)
                v[r] = as<C>(u[q + r * (E / 16)]);
            Dft<16, HALF, false>::run(v, sg);
            const int i = t + q * TPF;
#pragma unroll
            for (int r = 0; r < 16; ++r) put(a[pos(i * 16 + r)], v[r]);
        }
        __syncthreads();
    }

    // Stage 0 from the staged tile in a (each operand times scale), in
    // place: all reads finish before the writes.  PADIN: the tile's points
    // sit at their padded positions, else at their indices (the writes are
    // padded either way).
    template <typename C, bool PADIN = PAD, typename S>
    static __device__ __forceinline__ void first_smem(S* a, int t,
                                                      real_t<C> sg,
                                                      real_t<C> scale) {
        constexpr int Q = E / 16;
        S raw[Q][16];
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int r = 0; r < 16; ++r) {
                const int idx = t + q * TPF + r * (M / 16);
                raw[q][r] = a[PADIN ? pos(idx) : idx * LDS];
            }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            C v[16];
#pragma unroll
            for (int r = 0; r < 16; ++r) {
                v[r] = as<C>(raw[q][r]);
                v[r] = cmake(v[r].x * scale, v[r].y * scale);
            }
            Dft<16, false, false>::run(v, sg);
            const int i = t + q * TPF;
#pragma unroll
            for (int r = 0; r < 16; ++r) put(a[pos(i * 16 + r)], v[r]);
        }
        __syncthreads();
    }

    // The last stage from src: u[s] = epi(s, point t + s*TPF), the
    // epilogue on the unrounded output (LOWER: only the points < M/2).
    template <bool LOWER, typename C, typename S, typename U, typename Epi>
    static __device__ __forceinline__ void last(const S* src, U (&u)[E],
                                                int t, const C* tab, bool cj,
                                                real_t<C> sg, Epi epi) {
        constexpr int Q = E / RL;
        constexpr int STEP = M / RL;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int i = t + q * TPF;
            C v[RL];
#pragma unroll
            for (int r = 0; r < RL; ++r) v[r] = as<C>(src[pos(i + r * STEP)]);
            butterfly<NS - 1, LOWER>(v, i, tab, cj, sg);
#pragma unroll
            for (int r = 0; r < (LOWER ? RL / 2 : RL); ++r)
                put(u[q + r * (E / RL)], epi(q + r * (E / RL), v[r]));
        }
    }

    // The transform of u, registers in and out (held in the storage type
    // U), through a (and b with PP); epi(s, v) maps each unrounded output
    // point t + s*TPF before it is put back into u.  Synchronises after
    // every write to shared memory; a caller that writes a buffer
    // afterwards synchronises first (a needs none when LAST_READS_B).
    template <bool HALF, bool LOWER, typename C, typename S, typename U,
              typename Epi>
    static __device__ __forceinline__ void run_regs(U (&u)[E], S* a, S* b,
                                                    int t, const C* tab,
                                                    bool cj, real_t<C> sg,
                                                    Epi epi) {
        static_assert(NS > 1, "Bluestein's convolutions start at 32");
        first_regs<HALF, C>(u, a, t, sg);
        last<LOWER>(middles<1>(a, b, t, tab, cj, sg), u, t, tab, cj, sg, epi);
    }

    // The last stage from src into shared memory: out(k, v) stores output
    // point k (natural order) unrounded, for k = i + r*M/RL, i = t + q*TPF.
    // INPLACE (out writes the buffer src): every read finishes first.
    // Synchronises after the writes.
    template <bool INPLACE, typename C, typename S, typename Out>
    static __device__ __forceinline__ void last_out(const S* src, int t,
                                                    const C* tab, bool cj,
                                                    real_t<C> sg, Out out) {
        constexpr int Q = E / RL;
        constexpr int STEP = M / RL;
        S raw[Q][RL];
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int r = 0; r < RL; ++r)
                raw[q][r] = src[pos(t + q * TPF + r * STEP)];
        if (INPLACE) __syncthreads();
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int i = t + q * TPF;
            C v[RL];
#pragma unroll
            for (int r = 0; r < RL; ++r) v[r] = as<C>(raw[q][r]);
            butterfly<NS - 1, false>(v, i, tab, cj, sg);
#pragma unroll
            for (int r = 0; r < RL; ++r) out(i + r * STEP, v[r]);
        }
        __syncthreads();
    }

    // The transform of u (registers in, as run_regs) into shared memory:
    // out(dst, k, v) stores every output point k, unrounded, in dst, the
    // buffer returned (with PP the one the last stage does not read, else
    // a after all its reads), at whatever index the caller chooses.
    // Synchronises after the writes.
    template <typename C, typename S, typename U, typename Out>
    static __device__ __forceinline__ S* run_regs_out(const U (&u)[E], S* a,
                                                      S* b, int t,
                                                      const C* tab, bool cj,
                                                      real_t<C> sg, Out out) {
        static_assert(NS > 1, "the row kernels start at 32 points");
        first_regs<false, C>(u, a, t, sg);
        const S* src = middles<1>(a, b, t, tab, cj, sg);
        S* dst = PP ? (LAST_READS_B ? a : b) : a;
        last_out<!PP>(src, t, tab, cj, sg,
                      [&](int k, C v) { out(dst, k, v); });
        return dst;
    }

    // The transform of the staged tile in a (times scale) into u: the
    // first stage in place in a, the middle stages between a and b (PP,
    // one barrier a stage; without PP in place in a, b unused).  PADIN as
    // first_smem's (unpadded: the real reuse loop's row).  The caller
    // synchronises before writing a or b again.
    template <bool PADIN = PAD, typename C, typename S, typename Epi>
    static __device__ __forceinline__ void run_smem(S* a, S* b, C (&u)[E],
                                                    int t, const C* tab,
                                                    bool cj, real_t<C> sg,
                                                    real_t<C> scale,
                                                    Epi epi) {
        if constexpr (NS == 1) {
#pragma unroll
            for (int r = 0; r < 16; ++r) {
                const int idx = t + r * TPF;
                u[r] = as<C>(a[PADIN ? pos(idx) : idx * LDS]);
                u[r] = cmake(u[r].x * scale, u[r].y * scale);
            }
            Dft<16, false, false>::run(u, sg);
#pragma unroll
            for (int r = 0; r < 16; ++r) u[r] = epi(r, u[r]);
        } else {
            first_smem<C, PADIN>(a, t, sg, scale);
            last<false>(middles<1>(a, b, t, tab, cj, sg), u, t, tab, cj, sg,
                        epi);
        }
    }

    // run_smem in one buffer, in place in a.
    template <bool PADIN = PAD, typename C, typename S, typename Epi>
    static __device__ __forceinline__ void run_smem(S* a, C (&u)[E], int t,
                                                    const C* tab, bool cj,
                                                    real_t<C> sg,
                                                    real_t<C> scale,
                                                    Epi epi) {
        static_assert(!PP, "PP's stages would read and write a at once");
        run_smem<PADIN>(a, a, u, t, tab, cj, sg, scale, epi);
    }
};

// The block layout of the row kernels on the core, c2c_kernel,
// c2c_multiple_kernel and conv_kernel at M = N, the R2C and C2R kernels,
// real_multiple_kernel and conv_real_kernel at M = L = n/2
// (models/hcore.py row_geometry):
//   * E = 16 points a thread (32 at M = 16384), TPF = M / E threads a row,
//     F rows a block: 256 threads up to M = 4096 (F = 128 rows of 2
//     threads at M = 32), one row of 512 at 8192 and 16384;
//   * WARPS, the warps an SM the fp32 instantiation aims at (its register
//     budget: 24 warps allow 85 registers a thread, 32 allow 64), 16 for
//     "exact" (128); MINB, the blocks an SM __launch_bounds__ must allow,
//     is that or what the shared memory allows, whichever is fewer;
//   * each row's buffers are padded slots (SLOT = M + M/16 elements), two
//     of them (PP, one barrier a stage) where MINB blocks of two still
//     fit an SM, else one in place; rows BUF elements apart, BUF = TPF mod
//     16 where a warp spans rows (TPF < 16; 8 at TPF = 16), so that the
//     rows of a warp meet different banks;
//   * C is the arithmetic, S the storage: float2 for fp32; "exact" computes
//     in double2 and stores double2 up to M = 8192 (139 KB padded), float2
//     at 16384;
//   * the stage twiddle table follows the F rows' buffers, with the
//     anchors W^(4k) of Core's ANCH: on the H100 the products four deep
//     had 3x the stockham.cuh kernels' fp32 error in ulp(max|X|) (up to
//     6.9 against 2.5), the anchors keep it within 1.6x of theirs;
//   * the revblock staging keeps position p of a row at stage(p), PADR
//     pad elements after every 128 positions: a warp writing or reading
//     consecutive positions, and one reading or writing consecutive logical
//     points (positions 128 apart, CB of them), meet every bank evenly.
__host__ __device__ constexpr int row_stride(int base, int tpf) {
    return tpf > 16 ? base
                    : base + (((tpf < 16 ? tpf : 8) - base) % 16 + 16) % 16;
}

template <int M, bool EXACT, int WARPS>
struct RowGeometry {
    using C = typename std::conditional<EXACT, double2, float2>::type;
    using S = typename std::conditional<EXACT && M <= 8192, double2,
                                        float2>::type;
    static constexpr int E = M >= 16384 ? 32 : 16;
    static constexpr int TPF = M / E;
    static constexpr int F = TPF >= 256 ? 1 : 256 / TPF;
    static constexpr int THREADS = TPF * F;
    static constexpr int SLOT = M + M / 16;
    static constexpr int BY_WARPS = (EXACT ? 16 : WARPS) * 32 / THREADS;
    static constexpr int TAB = hc::Core<M, TPF, true, false, true>::TAB;
    static constexpr bool PP =
        (BY_WARPS > 1 ? BY_WARPS : 1) *
            ((size_t)F * row_stride(2 * SLOT, TPF) * sizeof(S) +
             TAB * sizeof(C) + 1024) <= 233472;
    static constexpr int BUF = row_stride((PP ? 2 : 1) * SLOT, TPF);
    using Core = hc::Core<M, TPF, true, PP, true>;
    static constexpr size_t SMEM =
        (size_t)F * BUF * sizeof(S) + TAB * sizeof(C);
    static_assert(F * BUF * sizeof(S) % sizeof(C) == 0, "table alignment");
    static constexpr int BY_SMEM = (int)(233472 / (SMEM + 1024));
    static constexpr int MINB =
        BY_SMEM < BY_WARPS ? (BY_SMEM > 0 ? BY_SMEM : 1)
                           : (BY_WARPS > 0 ? BY_WARPS : 1);
    // revblock differs from natural order from M = 256 on
    static constexpr int CB = M >= 128 ? M / 128 : 1;
    static constexpr int PADR = CB >= 32 ? 1 : 32 / CB;
    static_assert(CB == 1 || M + (CB - 1) * PADR <= SLOT,
                  "the staging fits a slot");
    static __device__ __forceinline__ int stage(int p) {
        return p + (p >> 7) * PADR;
    }
    static unsigned blocks(int64_t batch) {
        return (unsigned)((batch + F - 1) / F);
    }
};

}  // namespace hc
}  // namespace smfft
