// The Stockham core of power_kernel (spectral.cu) and the helpers of
// real_huge_kernel: in-register DFTs, twiddled butterflies, in-place
// shared-memory stages, the stage ladder, the block geometry per size;
// and what every kernel in csrc/ shares: the complex helpers, the revblock
// index map and its inverse, and the view of the data in device memory.
//
// Contract of the stage functions (N points of one transform in `buf`,
// TPF threads per transform, thread t):
//   * first_stage  takes the E = N/TPF points a thread holds, u[q][r] =
//     point t + q*TPF + r*N/8, and writes the radix-8 stage (p = 1) into
//     buf, then synchronises;
//   * middle_stages runs the radix-8 stages in place in buf;
//   * last_stage   reads the last stage's butterflies from buf and
//     returns them in registers: w[q][r] is output point t + q*TPF +
//     r*N/RL, natural order (last_stage_then hands each point to a
//     function instead, unrounded).  Neither synchronises: a caller that
//     writes buf afterwards synchronises first.
// Every thread of the block calls each function (they contain barriers).
//
// Two number types: C is the arithmetic (float2 for the fp32 tiers,
// double2 for "exact"), S the storage in shared memory (float2, or
// double2 where the transform fits).  Values convert with put(), which
// rounds to fp32 once where a double2 meets a float2.  With C = S = float2
// every conversion is the identity.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace smfft {

template <typename C> struct Scalar;
template <> struct Scalar<float2> { using T = float; };
template <> struct Scalar<double2> { using T = double; };
template <typename C> using real_t = typename Scalar<C>::T;

__device__ __forceinline__ float2 cmake(float x, float y) {
    return make_float2(x, y);
}
__device__ __forceinline__ double2 cmake(double x, double y) {
    return make_double2(x, y);
}

// d = v across the two complex types.
__device__ __forceinline__ void put(float2& d, float2 v) { d = v; }
__device__ __forceinline__ void put(double2& d, double2 v) { d = v; }
__device__ __forceinline__ void put(float2& d, double2 v) {
    d = make_float2((float)v.x, (float)v.y);
}
__device__ __forceinline__ void put(double2& d, float2 v) {
    d = make_double2(v.x, v.y);
}
template <typename To, typename From>
__device__ __forceinline__ To as(From v) {
    To d;
    put(d, v);
    return d;
}

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
    return cmake(a.x + b.x, a.y + b.y);
}

template <typename C>
__device__ __forceinline__ C csub(C a, C b) {
    return cmake(a.x - b.x, a.y - b.y);
}

template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
    return cmake(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// s * i * a, s = -1 forward, +1 inverse (exact).
template <typename C>
__device__ __forceinline__ C mul_si(C a, real_t<C> s) {
    return cmake(-s * a.y, s * a.x);
}

// In-register DFT of R points, natural order in and out, sign s.
template <int R> struct Dft;

template <> struct Dft<2> {
    template <typename C>
    static __device__ __forceinline__ void run(C* u, real_t<C>) {
        const C a = u[0], b = u[1];
        u[0] = cadd(a, b);
        u[1] = csub(a, b);
    }
};

template <> struct Dft<4> {
    template <typename C>
    static __device__ __forceinline__ void run(C* u, real_t<C> s) {
        const C t0 = cadd(u[0], u[2]), t1 = csub(u[0], u[2]);
        const C t2 = cadd(u[1], u[3]);
        const C t3 = mul_si(csub(u[1], u[3]), s);
        u[0] = cadd(t0, t2);
        u[1] = cadd(t1, t3);
        u[2] = csub(t0, t2);
        u[3] = csub(t1, t3);
    }
};

template <> struct Dft<8> {
    template <typename C>
    static __device__ __forceinline__ void run(C* u, real_t<C> s) {
        using T = real_t<C>;
        C e[4] = {u[0], u[2], u[4], u[6]};
        C o[4] = {u[1], u[3], u[5], u[7]};
        Dft<4>::run(e, s);
        Dft<4>::run(o, s);
        // cos(pi/4), rounded once to T: the same fp32 number as the
        // table's W_8
        const T c = static_cast<T>(0.70710678118654752440);
        o[1] = cmul(o[1], cmake(c, s * c));   // W_8^1
        o[2] = mul_si(o[2], s);               // W_8^2
        o[3] = cmul(o[3], cmake(-c, s * c));  // W_8^3
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            u[k] = cadd(e[k], o[k]);
            u[k + 4] = csub(e[k], o[k]);
        }
    }
};

// Twiddle and DFT of one Stockham radix-RS butterfly, in registers.
// p is the length of the sub-transforms already done (1, RS, RS^2, ...);
// butterfly i twiddles its input r by W_N^{r*k*N/(p*RS)}, k = i mod p.
template <int N, int RS, typename C>
__device__ __forceinline__ void butterfly(C (&u)[RS], int i, int p,
                                          const C* __restrict__ tw,
                                          real_t<C> s) {
    if (p > 1) {
        const int k = i & (p - 1);
        const int step = N / (p * RS);
#pragma unroll
        for (int r = 1; r < RS; ++r)
            u[r] = cmul(u[r], __ldg(&tw[r * k * step]));
    }
    Dft<RS>::run(u, s);
}

// Where butterfly i of a stage with sub-length p writes its output r.
__device__ __forceinline__ int stockham_dst(int i, int p, int rs, int r) {
    const int k = i & (p - 1);
    return (i - k) * rs + k + r * p;
}

// One radix-RS stage in place in shared memory: butterfly i reads
// buf[i + r*N/RS], and all reads finish (barrier) before any write.  The
// values wait for the barrier in the storage type and widen to C one
// butterfly at a time, which keeps the "exact" tier's registers at the
// fp32 tier's count where S = float2.
template <int N, int TPF, int RS, typename C, typename S>
__device__ __forceinline__ void smem_stage(S* buf, int t, int p,
                                           const C* __restrict__ tw,
                                           real_t<C> s) {
    constexpr int Q = N / TPF / RS;  // butterflies per thread
    constexpr int STRIDE = N / RS;   // butterflies per stage
    S u[Q][RS];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int r = 0; r < RS; ++r)
            u[q][r] = buf[t + q * TPF + r * STRIDE];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int i = t + q * TPF;
        C v[RS];
#pragma unroll
        for (int r = 0; r < RS; ++r) v[r] = as<C>(u[q][r]);
        butterfly<N, RS>(v, i, p, tw, s);
#pragma unroll
        for (int r = 0; r < RS; ++r) put(buf[stockham_dst(i, p, RS, r)], v[r]);
    }
    __syncthreads();
}

__host__ __device__ constexpr int ilog2(int n) {
    return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// The stage ladder of an N-point transform: a radix-8 first stage
// (p = 1), MID radix-8 middle stages, and a last stage of radix RL = 8, 4
// or 2 (p = N / RL).
template <int N> struct Ladder {
    static constexpr int LOG = ilog2(N);
    static constexpr int R8 = LOG / 3;
    static constexpr int RL = LOG % 3 == 0 ? 8 : (LOG % 3 == 2 ? 4 : 2);
    static constexpr int MID = LOG % 3 == 0 ? R8 - 2 : R8 - 1;
};

// First stage (radix 8, p = 1) from the E points a thread holds, each
// multiplied by `scale` first (exact for 1 and powers of two).
template <int N, int TPF, typename C, typename S, typename V>
__device__ __forceinline__ void first_stage(V (&u)[N / TPF / 8][8], S* buf,
                                            int t, const C* __restrict__ tw,
                                            real_t<C> s, real_t<C> scale) {
    constexpr int Q0 = N / TPF / 8;
#pragma unroll
    for (int q = 0; q < Q0; ++q) {
        C v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            v[r] = as<C>(u[q][r]);
            v[r] = cmake(v[r].x * scale, v[r].y * scale);
        }
        const int i = t + q * TPF;
        butterfly<N, 8>(v, i, 1, tw, s);
#pragma unroll
        for (int r = 0; r < 8; ++r) put(buf[i * 8 + r], v[r]);
    }
    __syncthreads();
}

template <int N, int TPF, typename C, typename S>
__device__ __forceinline__ void middle_stages(S* buf, int t,
                                              const C* __restrict__ tw,
                                              real_t<C> s) {
    int p = 8;
#pragma unroll
    for (int st = 0; st < Ladder<N>::MID; ++st) {
        smem_stage<N, TPF, 8>(buf, t, p, tw, s);
        p *= 8;
    }
}

// last_stage with an epilogue in place of the result array: fn(q, r, v)
// receives output point t + q*TPF + r*N/RL in the arithmetic type C, before
// any rounding to a storage type, one butterfly at a time.
template <int N, int TPF, typename C, typename S, typename Fn>
__device__ __forceinline__ void last_stage_then(const S* buf, int t,
                                                const C* __restrict__ tw,
                                                real_t<C> s, Fn fn) {
    constexpr int RL = Ladder<N>::RL;
    constexpr int QL = N / TPF / RL;
    S raw[QL][RL];
#pragma unroll
    for (int q = 0; q < QL; ++q)
#pragma unroll
        for (int r = 0; r < RL; ++r)
            raw[q][r] = buf[t + q * TPF + r * (N / RL)];
#pragma unroll
    for (int q = 0; q < QL; ++q) {
        C v[RL];
#pragma unroll
        for (int r = 0; r < RL; ++r) v[r] = as<C>(raw[q][r]);
        butterfly<N, RL>(v, t + q * TPF, N / RL, tw, s);
#pragma unroll
        for (int r = 0; r < RL; ++r) fn(q, r, v[r]);
    }
}

template <int N, int TPF, typename C, typename S, typename W>
__device__ __forceinline__ void last_stage(
    const S* buf, int t, const C* __restrict__ tw, real_t<C> s,
    W (&w)[N / TPF / Ladder<N>::RL][Ladder<N>::RL]) {
    last_stage_then<N, TPF>(buf, t, tw, s,
                            [&](int q, int r, C v) { put(w[q][r], v); });
}

// Logical element stored at position pos of a revblock row.
__device__ __forceinline__ int revblock_index(int pos, int c) {
    return (pos & 127) * c + (pos >> 7);
}

// The inverse of revblock_index: the position of logical element k
// (k = k1*c + k2 sits at k2*128 + k1; the identity for c = 1).
__device__ __forceinline__ int revblock_pos(int k, int c) {
    return (k % c) * 128 + k / c;
}

// The block's dynamic shared memory as an array of S.
template <typename S>
__device__ __forceinline__ S* shared_buffer() {
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    return reinterpret_cast<S*>(smem_bytes);
}

// The block layout of an N-point transform on this core (power_kernel
// takes it at N = L = n/2 <= 2048): E = 16 points per thread, TPF = N / E
// threads per transform, F = 4096 / N transforms per block, so a block has
// 256 threads; MINB = 4 blocks per SM, the register budget of 64 a thread.
template <int N>
struct Geometry {
    static_assert(N <= 4096, "16 points a thread, 256 threads a block");
    static constexpr int E = 16;
    static constexpr int F = 4096 / N;
    static constexpr int TPF = N / E;
    static constexpr int THREADS = TPF * F;
    static constexpr size_t SMEM = sizeof(float2) * N * F;
    static constexpr int MINB = 4;
    static unsigned blocks(int64_t batch) {
        return (unsigned)((batch + F - 1) / F);
    }
};

// Lets `kernel` take `smem` bytes of dynamic shared memory: above 48 KB
// only after cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The kernel's view of the data: point g (64-bit) of the batch, either
// interleaved complex64 (one float2 per point at in_re / out_re) or two
// contiguous fp32 planes.
struct Io {
    const float* __restrict__ in_re;
    const float* __restrict__ in_im;
    float* __restrict__ out_re;
    float* __restrict__ out_im;
    bool interleaved;

    __device__ __forceinline__ float2 load(int64_t g) const {
        if (interleaved)
            return __ldg(reinterpret_cast<const float2*>(in_re) + g);
        return make_float2(__ldg(in_re + g), __ldg(in_im + g));
    }
    __device__ __forceinline__ void store(int64_t g, float2 v) const {
        if (interleaved) {
            reinterpret_cast<float2*>(out_re)[g] = v;
        } else {
            out_re[g] = v.x;
            out_im[g] = v.y;
        }
    }
};

}  // namespace smfft
