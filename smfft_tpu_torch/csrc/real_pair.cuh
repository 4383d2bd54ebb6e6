// The real transforms' work on one pair of bins (k, L-k), L = n/2, shared
// by real.cu (R2C split), c2r.cu (C2R merge), multiple.cu (the real reuse
// loop: split then merge), conv.cu (split, filter product, merge) and
// real_huge.cu (the huge-N split and merge, W^k from hi/lo tables).  With
// W = W_n = exp(-2 pi i / n) and wn[k] = W^k:
//
//   split (R2C): Z (the L-point spectrum of z[m] = x[2m] + i x[2m+1]) ->
//     E = (Z[k] + conj Z[L-k]) / 2,  O = -i (Z[k] - conj Z[L-k]) / 2,
//     X[k] = E + W^k O,  X[L-k] = conj(E - W^k O),
//     slot 0 = (Re Z0 + Im Z0, Re Z0 - Im Z0) = (DC, Nyquist);
//   merge (C2R, the split's inverse times s, with h = s/2):
//     E = h (X[k] + conj X[L-k]),  O = h (X[k] - conj X[L-k]) W^-k,
//     Z[k] = E + i O,  Z[L-k] = conj(E - i O),
//     Z[0] = (h (DC + Nyquist), h (DC - Nyquist)).
//
// For k = L/2 both outputs are the same bin; a caller stores one of them.

#pragma once

#include "stockham.cuh"

// The half sizes L = n/2 of the real transforms (real.cu, c2r.cu).
#define SMFFT_REAL_SIZES(X) \
    X(32) X(64) X(128) X(256) X(512) X(1024) X(2048) X(4096) X(8192)

namespace smfft {

// Layouts of a packed half spectrum in device memory, as real.cu writes
// and c2r.cu reads them (ops/real.py numbers them the same way).
enum Layout : int { PLANAR = 0, PLANAR_REV = 1, PACKED = 2, NUMPY = 3 };

// (DC, Nyquist) from Z[0].
template <typename C>
__device__ __forceinline__ C split_dc(C a) {
    return cmake(a.x + a.y, a.x - a.y);
}

// X[k], X[L-k] from a = Z[k], b = Z[L-k] and w = W^k, 0 < k <= L/2.
template <typename C>
__device__ __forceinline__ void split_pair_w(C a, C b, C w, C& xk, C& xm) {
    using T = real_t<C>;
    const T h = T(0.5);
    const C e = cmake(h * (a.x + b.x), h * (a.y - b.y));
    const C o = cmake(h * (a.y + b.y), h * (b.x - a.x));
    const C wo = cmul(w, o);
    xk = cadd(e, wo);
    xm = cmake(e.x - wo.x, wo.y - e.y);
}

// split_pair_w with W^k from the table wn.
template <typename C>
__device__ __forceinline__ void split_pair(C a, C b,
                                           const C* __restrict__ wn, int k,
                                           C& xk, C& xm) {
    split_pair_w(a, b, __ldg(&wn[k]), xk, xm);
}

// Z[0] from a = (DC, Nyquist), h = scale / 2.
template <typename C>
__device__ __forceinline__ C merge_dc(C a, real_t<C> h) {
    return cmake(h * (a.x + a.y), h * (a.x - a.y));
}

// Z[k], Z[L-k] from a = X[k], b = X[L-k] and w = W^k, 0 < k <= L/2, h =
// scale / 2.
template <typename C>
__device__ __forceinline__ void merge_pair_w(C a, C b, C w, real_t<C> h,
                                             C& zk, C& zm) {
    const C e = cmake(h * (a.x + b.x), h * (a.y - b.y));
    const C d = cmake(h * (a.x - b.x), h * (a.y + b.y));
    const C o = cmul(d, cmake(w.x, -w.y));  // * W^-k
    zk = cmake(e.x - o.y, e.y + o.x);
    zm = cmake(e.x + o.y, o.x - e.y);
}

// merge_pair_w with W^k from the table wn.
template <typename C>
__device__ __forceinline__ void merge_pair(C a, C b,
                                           const C* __restrict__ wn, int k,
                                           real_t<C> h, C& zk, C& zm) {
    merge_pair_w(a, b, __ldg(&wn[k]), h, zk, zm);
}

}  // namespace smfft
