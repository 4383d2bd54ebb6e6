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
// write of device memory:
//   * a block holds T transforms of R points in shared memory (T = 8 at R
//     >= 1024, 4 for "exact", and 4096/R below: 64-128 KB at the largest
//     radices), one padded slot of R + 1 points each, so that the
//     column-major staging does not hit one bank;
//   * the load and the store are cooperative: with stride 1 consecutive
//     threads take consecutive points of a row, otherwise consecutive
//     transforms (the T adjacent columns), so every warp reads or writes
//     T * 8 >= 32 contiguous bytes for complex64;
//   * between the load and the store the transform runs through the
//     Stockham core of stockham.cuh (first stage with the scale, radix-8
//     middle stages, last stage), and the twiddle is applied to the last
//     stage's outputs unrounded, from an exact integer exponent and two
//     small float64-computed tables (huge.cuh's root): no sincos of an fp32
//     angle;
//   * the passes of a plan run in place on one intermediate buffer (blocks
//     own disjoint sets of points and read all of theirs before writing);
//   * "exact": fp64 arithmetic, shared memory and tables, and complex128
//     intermediates between the passes (ops/fourstep_fused.py), so the only
//     fp32 rounding is the output's;
//   * 64-bit offsets (b * N passes 2^31 points at N = 2^28, b = 8); the
//     ragged tail of the transforms is masked; the launcher returns
//     cudaGetLastError() right after the launch.

#include "huge.cuh"

namespace {

using namespace smfft;

// One side of a pass: the operand and its index map (0 column of stride s,
// 1 digit-reversed row).
struct Side {
    Cells cells;
    int map;
    int64_t s;
};

// The radices of a digit-reversed row map, d1's first.
struct Digits {
    int nr;
    int64_t r[4];
};

// Block layout of a pass of radix R: T transforms a block, E points a
// thread (32 at R = 2048, 16 below), TPF = R / E threads a transform.
template <int R, bool EXACT>
struct PassGeometry {
    using C = typename std::conditional<EXACT, double2, float2>::type;
    static constexpr int TMIN = EXACT ? 4 : 8;
    static constexpr int T = 4096 / R > TMIN ? 4096 / R : TMIN;
    static constexpr int E = R >= 2048 ? 32 : 16;
    static constexpr int TPF = R / E;
    static constexpr int THREADS = TPF * T;
    static constexpr int LD = R + 1;
    static constexpr size_t SMEM =
        sizeof(C) * LD * T + 3 * T * sizeof(int64_t);
};

__device__ __forceinline__ int64_t first_point(const Side& d,
                                               const Digits& dg, int64_t c,
                                               int r) {
    if (d.map == 0) {
        const int64_t o = c / d.s;
        return o * r * d.s + (c - o * d.s);
    }
    int64_t pos = 0, rest = c;
    for (int i = 0; i < dg.nr; ++i) {
        const int64_t di = rest % dg.r[i];
        rest /= dg.r[i];
        pos = pos * dg.r[i] + di;
    }
    return pos * r;
}

template <int R, int T, int THREADS, typename C>
__global__ void __launch_bounds__(THREADS, 1)
fourstep_pass_kernel(Side in, Side out, Digits dg, int64_t batch, int64_t n,
                     int64_t tw_s, double scale, const C* __restrict__ tw,
                     const C* __restrict__ tw_lo, const C* __restrict__ tw_hi,
                     int lo_bits, int inverse) {
    using Tr = real_t<C>;
    constexpr int TPF = THREADS / T;
    constexpr int E = R / TPF;
    constexpr int LD = R + 1;
    constexpr int RL = Ladder<R>::RL;
    C* smem = shared_buffer<C>();
    int64_t* in_at = reinterpret_cast<int64_t*>(smem + LD * T);
    int64_t* out_at = in_at + T;
    int64_t* tw_mul = out_at + T;
    const Tr sgn = inverse ? Tr(1) : Tr(-1);
    const int64_t per_row = n / R;
    const int64_t first = (int64_t)blockIdx.x * T;
    const int64_t left = batch * per_row - first;
    const int valid = left < T ? (int)left : T;
    const int tid = threadIdx.x;

    // where each transform of the block starts, and its twiddle multiplier
    // (the exponent of W_N per output point k)
    if (tid < valid) {
        const int64_t g = first + tid;
        const int64_t b = g / per_row, c = g - b * per_row;
        in_at[tid] = b * n + first_point(in, dg, c, R);
        out_at[tid] = b * n + first_point(out, dg, c, R);
        tw_mul[tid] = tw_s ? (c % tw_s) * (n / (R * tw_s)) : 0;
    }
    __syncthreads();

    // cooperative load into the padded slots: row-wise when the points are
    // contiguous, else across the T transforms (adjacent columns)
    const int64_t in_stride = in.map == 0 ? in.s : 1;
    {
        C v[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
            const int e = tid + i * THREADS;
            const int f = in_stride == 1 ? e / R : e % T;
            const int j = in_stride == 1 ? e % R : e / T;
            v[i] = f < valid ? in.cells.load<C>(in_at[f] + j * in_stride)
                             : cmake(Tr(0), Tr(0));
        }
#pragma unroll
        for (int i = 0; i < E; ++i) {
            const int e = tid + i * THREADS;
            const int f = in_stride == 1 ? e / R : e % T;
            const int j = in_stride == 1 ? e % R : e / T;
            smem[f * LD + j] = v[i];
        }
    }
    __syncthreads();

    const int f = tid / TPF, t = tid % TPF;
    C* buf = smem + f * LD;
    C u[E / 8][8];
    load_first<R, TPF>(buf, t, u);
    __syncthreads();
    first_stage<R, TPF>(u, buf, t, tw, sgn, Tr(scale));
    middle_stages<R, TPF>(buf, t, tw, sgn);
    C w[E / RL][RL];
    const int64_t mul = f < valid ? tw_mul[f] : 0;
    last_stage_then<R, TPF>(buf, t, tw, sgn, [&](int q, int r, C v) {
        if (mul) {
            const int64_t k = t + q * TPF + r * (R / RL);
            v = cmul(v, root(tw_lo, tw_hi, mul * k, lo_bits));
        }
        w[q][r] = v;
    });
    __syncthreads();  // every read of the last stage is done
#pragma unroll
    for (int q = 0; q < E / RL; ++q)
#pragma unroll
        for (int r = 0; r < RL; ++r) buf[t + q * TPF + r * (R / RL)] = w[q][r];
    __syncthreads();

    const int64_t out_stride = out.map == 0 ? out.s : 1;
#pragma unroll
    for (int i = 0; i < E; ++i) {
        const int e = tid + i * THREADS;
        const int g = out_stride == 1 ? e / R : e % T;
        const int j = out_stride == 1 ? e % R : e / T;
        if (g < valid)
            out.cells.store(out_at[g] + j * out_stride, smem[g * LD + j]);
    }
}

template <int R, bool EXACT>
cudaError_t launch(const Side& in, const Side& out, const Digits& dg,
                   int64_t batch, int64_t n, int64_t tw_s, double scale,
                   const void* tw, const void* lo, const void* hi,
                   int lo_bits, int inverse, cudaStream_t stream) {
    using G = PassGeometry<R, EXACT>;
    using C = typename G::C;
    auto kernel = fourstep_pass_kernel<R, G::T, G::THREADS, C>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    const int64_t blocks = (batch * (n / R) + G::T - 1) / G::T;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, G::THREADS, G::SMEM, stream>>>(
        in, out, dg, batch, n, tw_s, scale, static_cast<const C*>(tw),
        static_cast<const C*>(lo), static_cast<const C*>(hi), lo_bits,
        inverse);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass over batch rows of n points.  in_kind / out_kind: 0 complex64,
// 1 planar fp32 (in_b / out_b the imaginary planes), 2 complex128; in_map /
// out_map: 0 column of stride in_s / out_s, 1 digit-reversed row over the
// nr radices r0..r3.  The pass's radix must divide n; tw_s = 0 omits the
// twiddle.  tw: W_radix^m, m < radix; lo, hi: W_n^j, j < 2^lo_bits, and
// W_n^(i * 2^lo_bits); all three (re, im) float32 pairs, or float64 when
// exact != 0.  Returns a cudaError_t (0 on success).
int smfft_fourstep_pass(void* in_a, void* in_b, int in_kind, int in_map,
                        int64_t in_s, void* out_a, void* out_b, int out_kind,
                        int out_map, int64_t out_s, int nr, int64_t r0,
                        int64_t r1, int64_t r2, int64_t r3, int64_t batch,
                        int64_t n, int64_t radix, int64_t tw_s, double scale,
                        const void* tw, const void* lo, const void* hi,
                        int lo_bits, int inverse, int exact, void* stream) {
    if (batch <= 0) return (int)cudaSuccess;
    if (nr < 0 || nr > 4 || n % radix) return (int)cudaErrorInvalidValue;
    const Side in{{in_a, in_b, in_kind}, in_map, in_s};
    const Side out{{out_a, out_b, out_kind}, out_map, out_s};
    const Digits dg{nr, {r0, r1, r2, r3}};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMFFT_CASE(RR)                                                      \
    case RR:                                                                \
        return exact ? (int)launch<RR, true>(in, out, dg, batch, n, tw_s,   \
                                             scale, tw, lo, hi, lo_bits,    \
                                             inverse, st)                   \
                     : (int)launch<RR, false>(in, out, dg, batch, n, tw_s,  \
                                              scale, tw, lo, hi, lo_bits,   \
                                              inverse, st);
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
