// What the huge-N kernels (fourstep.cu, real_huge.cu) share: the view of
// one operand in device memory in any of the three element types the
// passes exchange, the view of the real transforms' packed spectra, and
// the exact root W_N^m from two small tables.

#pragma once

#include "stockham.cuh"

namespace smfft {

// One operand: complex64 (kind 0, interleaved float2 at a), two fp32
// planes (kind 1: a real, b imaginary), or complex128 (kind 2, the "exact"
// tier's intermediates, interleaved double2 at a).  Offsets are 64-bit.
// The passes run in place, so the loads are plain (not __ldg): the
// read-only cache may not hold data that the same kernel writes.
struct Cells {
    void* a;
    void* b;
    int kind;

    template <typename V>
    __device__ __forceinline__ V load(int64_t g) const {
        if (kind == 2) return as<V>(static_cast<const double2*>(a)[g]);
        if (kind == 1)
            return as<V>(make_float2(static_cast<const float*>(a)[g],
                                     static_cast<const float*>(b)[g]));
        return as<V>(static_cast<const float2*>(a)[g]);
    }
    template <typename V>
    __device__ __forceinline__ void store(int64_t g, V v) const {
        if (kind == 2) {
            static_cast<double2*>(a)[g] = as<double2>(v);
        } else if (kind == 1) {
            const float2 f = as<float2>(v);
            static_cast<float*>(a)[g] = f.x;
            static_cast<float*>(b)[g] = f.y;
        } else {
            static_cast<float2*>(a)[g] = as<float2>(v);
        }
    }
};

// The spectrum side: rows of L packed bins (slot 0 = (DC, Nyquist)) as a
// planar pair (layout 0), complex64 (1), or numpy complex64 rows of L + 1
// bins with DC and Nyquist in their own real slots (2).
struct Spectrum {
    float* re;
    float* im;
    int layout;
    int64_t L;

    __device__ __forceinline__ int64_t at(int64_t row, int64_t k) const {
        return row * (layout == 2 ? L + 1 : L) + k;
    }
    template <typename C>
    __device__ __forceinline__ C load(int64_t row, int64_t k) const {
        const int64_t g = at(row, k);
        if (layout == 0) return as<C>(make_float2(re[g], im[g]));
        const float2* z = reinterpret_cast<const float2*>(re);
        if (layout == 2 && k == 0)
            return as<C>(make_float2(z[g].x, z[g + L].x));
        return as<C>(z[g]);
    }
    // STREAM: with the streaming hint (st.global.cs), for a spectrum that
    // the kernel writing it does not read again
    template <bool STREAM = false, typename C>
    __device__ __forceinline__ void store(int64_t row, int64_t k,
                                          C v) const {
        const int64_t g = at(row, k);
        const float2 f = as<float2>(v);
        if (layout == 0) {
            put_to<STREAM>(re + g, f.x);
            put_to<STREAM>(im + g, f.y);
            return;
        }
        float2* z = reinterpret_cast<float2*>(re);
        if (layout == 2 && k == 0) {
            put_to<STREAM>(z + g, make_float2(f.x, 0.0f));
            put_to<STREAM>(z + g + L, make_float2(f.y, 0.0f));
            return;
        }
        put_to<STREAM>(z + g, f);
    }
    template <bool STREAM, typename V>
    static __device__ __forceinline__ void put_to(V* p, V v) {
        if constexpr (STREAM)
            __stcs(p, v);
        else
            *p = v;
    }
};

// W_N^m, 0 <= m < N, as hi[m >> lo_bits] * lo[m & (2^lo_bits - 1)]: two
// tables of at most 2^15 entries, each computed in float64 and rounded
// once to the arithmetic type (the JAX package's ops/fourstep.py
// discipline).  The exponent is an exact integer, so no angle is ever
// rounded: an fp32 angle 2 pi m / N would lose ~8 bits at N = 2^28.
template <typename C>
__device__ __forceinline__ C root(const C* __restrict__ lo,
                                  const C* __restrict__ hi, int64_t m,
                                  int lo_bits) {
    return cmul(__ldg(&hi[m >> lo_bits]),
                __ldg(&lo[m & ((int64_t(1) << lo_bits) - 1)]));
}

}  // namespace smfft
