// The Hermitian split and merge of the huge-N real transforms: one
// elementwise kernel for Hopper (sm_90a), in an fp32 and an "exact" (fp64
// arithmetic) instantiation, with four modes chosen at run time.
//
// real_huge_kernel replaces the TPU kernels
//   smfft_tpu/ops/real_fused.py::_build_split       (B24, "halfc", both
//                                                    directions)
//   smfft_tpu/ops/real_fused.py::_build_pair_split  (B25; where the last
//                                                    pass's radix is at
//                                                    most 256 the split
//                                                    is that pass's own,
//                                                    fourstep.cu)
//   smfft_tpu/ops/real_fused.py::_build_pair_merge  (B26)
// Around it, ops/real_fused.py runs the huge-N C2C passes (fourstep.cu):
//   * pair split (mode 0): Z = FFT_n(x_p + i x_q) for two real rows p, q
//     -> the packed half-spectra X_p[k] = (Z[k] + conj Z[n-k]) / 2 and
//     X_q[k] = -i (Z[k] - conj Z[n-k]) / 2, k < L = n/2, slot 0 = (DC,
//     Nyquist) = (Re Z[0], Re Z[L]) and (Im Z[0], Im Z[L]); Z row r gives
//     spectrum rows r and r + q_off;
//   * pair merge (mode 1): the inverse, two packed half-spectra -> scale *
//     the full Z (Z[k] = X_p[k] + i X_q[k], Z[n-k] = conj X_p[k] + i conj
//     X_q[k]), whose inverse FFT holds x_p in its real part and x_q in its
//     imaginary part;
//   * halfc split (mode 2): Z = FFT_L(z), z[t] = x[2t] + i x[2t+1] -> X[k]
//     = E + W_n^k O and X[L-k] (real_pair.cuh's split_pair);
//   * halfc merge (mode 3): the inverse times scale (merge_pair).
// The spectrum side is a planar pair, packed complex64 (slot 0 = DC + i
// Nyquist) or numpy complex64 (L + 1 bins a row), so the public layouts
// come out of the kernel with no conversion pass; the Z side is complex64,
// or complex128 for the "exact" tier.
//
// What bounds it on the H100: bytes.  Each thread owns one bin pair (k and
// its mirror n-k or L-k), reads both and writes both: one read and one
// write of the data (16 bytes a complex point each way), where the TPU pass
// reads the mirror block again (1.5 passes) and reverses it with a
// permutation matmul.  The mirror's reads run backwards through memory,
// which still fills whole sectors across a warp.  W_n^k comes from the
// exact hi/lo tables of huge.cuh (a full table at n = 2^29 would hold 2^28
// entries, 2 GB).  64-bit offsets; grid-stride loop; the launcher returns
// cudaGetLastError() right after the launch.

#include "huge.cuh"
#include "real_pair.cuh"

namespace {

using namespace smfft;

template <typename C>
__global__ void __launch_bounds__(256)
real_huge_kernel(int mode, Cells z, Spectrum x, int64_t rows, int64_t n,
                 int64_t q_off, int64_t x_rows, double scale,
                 const C* __restrict__ lo, const C* __restrict__ hi,
                 int lo_bits) {
    using T = real_t<C>;
    const int64_t L = n / 2;
    const bool pair = mode < 2;
    const int64_t zlen = pair ? n : L;      // Z points a row
    const int64_t per = pair ? L : L / 2 + 1;
    const int64_t items = rows * per;
    const T s = T(scale);
    for (int64_t it = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         it < items; it += (int64_t)gridDim.x * blockDim.x) {
        const int64_t r = it / per, k = it - r * per;
        const int64_t zr = r * zlen;
        if (mode == 0) {
            const C a = z.load<C>(zr + k);
            const C m = z.load<C>(zr + (k ? n - k : L));
            C p, q;
            if (k == 0) {
                p = cmake(a.x, m.x);
                q = cmake(a.y, m.y);
            } else {
                const T h = T(0.5);
                p = cmake(h * (a.x + m.x), h * (a.y - m.y));
                q = cmake(h * (a.y + m.y), h * (m.x - a.x));
            }
            x.store(r, k, p);
            if (r + q_off < x_rows) x.store(r + q_off, k, q);
        } else if (mode == 1) {
            const C p = x.load<C>(r, k);
            const C q = r + q_off < x_rows ? x.load<C>(r + q_off, k)
                                           : cmake(T(0), T(0));
            if (k == 0) {
                z.store(zr, cmake(s * p.x, s * q.x));
                z.store(zr + L, cmake(s * p.y, s * q.y));
            } else {
                z.store(zr + k, cmake(s * (p.x - q.y), s * (p.y + q.x)));
                z.store(zr + n - k, cmake(s * (p.x + q.y), s * (q.x - p.y)));
            }
        } else if (k == 0) {
            if (mode == 2)
                x.store(r, 0, split_dc(z.load<C>(zr)));
            else
                z.store(zr, merge_dc(x.load<C>(r, 0), T(0.5) * s));
        } else {
            const C w = root(lo, hi, k, lo_bits);  // W_n^k
            C ok, om;
            if (mode == 2) {
                split_pair_w(z.load<C>(zr + k), z.load<C>(zr + L - k), w,
                             ok, om);
                x.store(r, k, ok);
                if (k != L - k) x.store(r, L - k, om);
            } else {
                merge_pair_w(x.load<C>(r, k), x.load<C>(r, L - k), w,
                             T(0.5) * s, ok, om);
                z.store(zr + k, ok);
                if (k != L - k) z.store(zr + L - k, om);
            }
        }
    }
}

template <typename C>
cudaError_t launch(int mode, const Cells& z, const Spectrum& x, int64_t rows,
                   int64_t n, int64_t q_off, int64_t x_rows, double scale,
                   const void* lo, const void* hi, int lo_bits,
                   cudaStream_t stream) {
    const int64_t per = mode < 2 ? n / 2 : n / 4 + 1;
    const int64_t want = (rows * per + 255) / 256;
    const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
    real_huge_kernel<C><<<blocks, 256, 0, stream>>>(
        mode, z, x, rows, n, q_off, x_rows, scale, static_cast<const C*>(lo),
        static_cast<const C*>(hi), lo_bits);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0 pair split, 1 pair merge, 2 halfc split, 3 halfc merge, for real
// length n (L = n/2).  z: rows of n (pair) or L (halfc) complex points of
// kind z_kind (0 complex64, 2 complex128); x: spectrum rows of layout
// x_layout (0 planar pair x_re / x_im, 1 packed complex64, 2 numpy
// complex64), x_rows of them, the q rows of a pair q_off after the p rows.
// rows: the rows of z.  lo, hi: W_n^j, j < 2^lo_bits, and W_n^(i *
// 2^lo_bits), (re, im) float32 pairs, or float64 when exact != 0.  Returns
// a cudaError_t (0 on success).
int smfft_real_huge(int mode, void* z_a, int z_kind, void* x_re, void* x_im,
                    int x_layout, int64_t rows, int64_t n, int64_t q_off,
                    int64_t x_rows, double scale, const void* lo,
                    const void* hi, int lo_bits, int exact, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (mode < 0 || mode > 3 || n < 4 || n % 4)
        return (int)cudaErrorInvalidValue;
    const Cells z{z_a, nullptr, z_kind};
    const Spectrum x{static_cast<float*>(x_re), static_cast<float*>(x_im),
                     x_layout, n / 2};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (exact)
        return (int)launch<double2>(mode, z, x, rows, n, q_off, x_rows,
                                    scale, lo, hi, lo_bits, st);
    return (int)launch<float2>(mode, z, x, rows, n, q_off, x_rows, scale, lo,
                               hi, lo_bits, st);
}

}  // extern "C"
