// The periodicity search's harmonic sum of each DM trial's spectrum: the
// interbinned power series and its statistics, then, for every
// fundamental, the power summed over its harmonics to its best SNR.  Two
// kernels for Hopper (sm_90a), each with a float64 instantiation
// ("exact").
//
// They replace no TPU kernel: the JAX package has no harmonic sum.  They
// follow AstroAccelerate's periodicity search (Adamek & Armour, "A GPU
// implementation of the harmonic sum algorithm", ADASS XXVIII), with
// interbinning as in Ransom, Eikenberry & Middleditch 2002 (AJ 124, 1788).
// For a spectrum X of L bins (numpy's rfft layout) and M = 2L - 1:
//
//   Q[2k]     = |X_k|^2,                        k = 0 .. L-1,
//   Q[2k + 1] = (pi^2 / 16) |X_k - X_{k+1}|^2,  k = 0 .. L-2,
//   mu, sigma = the mean and population deviation of Q's M points,
//   S_H(i)    = sum_{h=1..H} Q[h i],  H = 1 .. H_max(i),
//   H_max(0)  = harmonics, H_max(i) = min(harmonics, (M - 1) / i),
//   snr[i]    = max_H (S_H(i) - H mu) / (sqrt(H) sigma),
//   count[i]  = the smallest H that attains it.
//
// interbin_kernel: each trial's bins are cut into PARTS runs, one block
// each; a thread writes the pair (Q[2k], Q[2k + 1]) as one 8-byte (16-byte
// "exact") word, so a trial's row of q is 2L points, the last (past M)
// written 0.  A block writes the float64 sum and sum of squares of its
// run's points, so the statistics of 2^23 points keep float32 accuracy,
// and nothing is accumulated across blocks: no buffer needs zeroing and
// the sums do not depend on the order blocks run in.
//
// harmonic_sum_kernel: a block of 256 threads takes TILE consecutive
// fundamentals of one trial, PER_THREAD a thread at a stride of 256.  Its
// first warp adds the trial's PARTS partial sums (one a lane) into mu and
// 1/sigma.  A thread reads its harmonics Q[h i] through the read-only
// path, BATCH loads in flight before their sums, adds them in the tier's
// precision and keeps the largest (S_H - H mu) / sqrt(H) (1/sqrt(H) from a
// table in shared memory), scaled by 1/sigma at the end; snr is stored
// with the streaming hint and the count, where asked for, as a byte.
//
// What bounds it on the H100: the gather.  For h >= 8 neighbouring
// threads' harmonics lie in sectors of their own, so the reads move some
// 19 times Q's size from L2 to the SMs.  Blocks are numbered trial by
// trial, so a trial's Q (32 MiB at 2^23) is read from L2 while its
// fundamentals are summed.  At 128 trials of 2^23 samples on an H100 SXM
// the sum takes 14.9 ms and the interbinning 4.2: 13 % of the spectrum
// read and the SNR written at peak bandwidth.  Writing the decimated
// copies Q[h i] beside Q instead, so that both passes stream, took longer
// (11.4 and 12.7 ms) with four times Q's memory.
//
// Positions within a row are 32-bit (M < 2^31), offsets of rows 64-bit;
// each launcher returns cudaGetLastError() right after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// partial sums a trial: one a lane of the harmonic kernel's first warp
constexpr int PARTS = 32;
constexpr int THREADS = 256;
// fundamentals a thread of the harmonic kernel, and a block's
constexpr int PER_THREAD = 8;
constexpr int TILE = THREADS * PER_THREAD;
constexpr int MAX_HARMONICS = 32;
// harmonics whose loads are issued before their sums
constexpr int BATCH = 8;
constexpr double PI2_16 = 0.61685027506808491368;  // pi^2 / 16

template <bool EXACT>
struct Tier {
    using R = float;
    using R2 = float2;
};
template <>
struct Tier<true> {
    using R = double;
    using R2 = double2;
};

__device__ __forceinline__ float2 pair(float a, float b) {
    return make_float2(a, b);
}
__device__ __forceinline__ double2 pair(double a, double b) {
    return make_double2(a, b);
}

template <bool EXACT>
__global__ void __launch_bounds__(THREADS)
interbin_kernel(const float2* __restrict__ x,
                typename Tier<EXACT>::R2* __restrict__ q,
                double* __restrict__ part, int64_t bins) {
    using R = typename Tier<EXACT>::R;
    __shared__ double2 warp_sums[THREADS / 32];
    const int64_t t = blockIdx.x / PARTS;
    const int p = blockIdx.x % PARTS;
    const int64_t run = (bins + PARTS - 1) / PARTS;
    const int64_t k0 = p * run;
    const int64_t k1 = k0 + run < bins ? k0 + run : bins;
    const float2* row = x + t * bins;
    typename Tier<EXACT>::R2* out = q + t * bins;
    double s = 0.0, ss = 0.0;
    for (int64_t k = k0 + threadIdx.x; k < k1; k += THREADS) {
        const float2 a = __ldg(row + k);
        const R re = a.x, im = a.y;
        const R p0 = re * re + im * im;
        R p1 = R(0);
        if (k + 1 < bins) {
            const float2 b = __ldg(row + k + 1);
            const R dr = re - R(b.x), di = im - R(b.y);
            p1 = R(PI2_16) * (dr * dr + di * di);
            s += double(p1);
            ss += double(p1) * double(p1);
        }
        s += double(p0);
        ss += double(p0) * double(p0);
        out[k] = pair(p0, p1);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, d);
        ss += __shfl_down_sync(0xffffffffu, ss, d);
    }
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane == 0) warp_sums[warp] = make_double2(s, ss);
    __syncthreads();
    if (threadIdx.x == 0) {
        double2 sum = warp_sums[0];
        for (int w = 1; w < THREADS / 32; ++w) {
            sum.x += warp_sums[w].x;
            sum.y += warp_sums[w].y;
        }
        part[2 * (t * PARTS + p)] = sum.x;
        part[2 * (t * PARTS + p) + 1] = sum.y;
    }
}

template <bool EXACT>
__global__ void __launch_bounds__(THREADS)
harmonic_sum_kernel(const typename Tier<EXACT>::R* __restrict__ q,
                    const double* __restrict__ part, float* __restrict__ snr,
                    uint8_t* __restrict__ count, int64_t bins, int64_t tiles,
                    int harmonics) {
    using R = typename Tier<EXACT>::R;
    __shared__ R rsqrt_h[MAX_HARMONICS + 1];
    __shared__ R stats[2];
    const int m = int(2 * bins - 1);
    const int64_t t = blockIdx.x / tiles;
    const int first = int(blockIdx.x % tiles) * TILE;
    if (threadIdx.x >= 32 && threadIdx.x <= 32 + MAX_HARMONICS) {
        const int h = threadIdx.x - 32;
        rsqrt_h[h] = h ? R(1) / sqrt(R(h)) : R(0);
    }
    if (threadIdx.x < 32) {
        double s = part[2 * (t * PARTS + threadIdx.x)];
        double ss = part[2 * (t * PARTS + threadIdx.x) + 1];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            s += __shfl_down_sync(0xffffffffu, s, d);
            ss += __shfl_down_sync(0xffffffffu, ss, d);
        }
        if (threadIdx.x == 0) {
            const double mu = s / double(m);
            const double var = ss / double(m) - mu * mu;
            stats[0] = R(mu);
            stats[1] = R(1.0 / sqrt(var > 0.0 ? var : 0.0));
        }
    }
    __syncthreads();
    const R mu = stats[0], inv_sigma = stats[1];
    const R* row = q + t * 2 * bins;
#pragma unroll 1
    for (int j = 0; j < PER_THREAD; ++j) {
        const int i = first + j * THREADS + threadIdx.x;
        if (i >= m) break;
        const int most = i ? (m - 1) / i : harmonics;
        const int hmax = most < harmonics ? most : harmonics;
        R s = R(0), best = R(0);
        int arg = 0;
#pragma unroll 1
        for (int h0 = 1; h0 <= hmax; h0 += BATCH) {
            R v[BATCH];
#pragma unroll
            for (int b = 0; b < BATCH; ++b)
                v[b] = h0 + b <= hmax ? __ldg(row + (h0 + b) * i) : R(0);
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int h = h0 + b;
                if (h <= hmax) {
                    s += v[b];
                    const R d = (s - R(h) * mu) * rsqrt_h[h];
                    if (arg == 0 || d > best) {
                        best = d;
                        arg = h;
                    }
                }
            }
        }
        __stcs(snr + t * m + i, float(best * inv_sigma));
        if (count) count[t * m + i] = uint8_t(arg);
    }
}

template <bool EXACT>
cudaError_t launch_interbin(const float2* x, void* q, double* part,
                            int64_t rows, int64_t bins, cudaStream_t stream) {
    interbin_kernel<EXACT><<<unsigned(rows * PARTS), THREADS, 0, stream>>>(
        x, static_cast<typename Tier<EXACT>::R2*>(q), part, bins);
    return cudaGetLastError();
}

template <bool EXACT>
cudaError_t launch_harmonic_sum(const void* q, const double* part,
                                float* snr, uint8_t* count, int64_t rows,
                                int64_t bins, int harmonics,
                                cudaStream_t stream) {
    const int64_t tiles = (2 * bins - 1 + TILE - 1) / TILE;
    harmonic_sum_kernel<EXACT><<<unsigned(rows * tiles), THREADS, 0,
                                 stream>>>(
        static_cast<const typename Tier<EXACT>::R*>(q), part, snr, count,
        bins, tiles, harmonics);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Spectra x (rows, bins) complex64, 8-byte aligned, 2 <= bins < 2^30 -> q
// (rows, 2 bins) float32 (float64 when exact != 0): Q[2k] = |X_k|^2,
// Q[2k + 1] = (pi^2/16) |X_k - X_{k+1}|^2, the last point 0; and part
// (rows, 32) pairs of float64: each run's sum and sum of squares of its Q
// points.  Returns a cudaError_t (0 on success).
int smfft_interbin(const void* x, void* q, void* part, int64_t rows,
                   int64_t bins, int exact, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (bins < 2 || 2 * bins > INT32_MAX || rows * PARTS > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const float2* xf = static_cast<const float2*>(x);
    double* pd = static_cast<double*>(part);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(exact ? launch_interbin<true>(xf, q, pd, rows, bins, st)
                       : launch_interbin<false>(xf, q, pd, rows, bins, st));
}

// q and part from smfft_interbin with the same bins and tier -> snr (rows,
// 2 bins - 1) float32: each fundamental's best SNR over 1 .. harmonics
// harmonics (1 <= harmonics <= 32); and, where count is not null, count
// (rows, 2 bins - 1) uint8: the smallest number of harmonics that attains
// it.  Returns a cudaError_t.
int smfft_harmonic_sum(const void* q, const void* part, void* snr,
                       void* count, int64_t rows, int64_t bins, int harmonics,
                       int exact, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    const int64_t tiles = (2 * bins - 1 + TILE - 1) / TILE;
    if (bins < 2 || 2 * bins > INT32_MAX || harmonics < 1
        || harmonics > MAX_HARMONICS || rows * tiles > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const double* pd = static_cast<const double*>(part);
    float* sf = static_cast<float*>(snr);
    uint8_t* cu = static_cast<uint8_t*>(count);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(exact ? launch_harmonic_sum<true>(q, pd, sf, cu, rows, bins,
                                                   harmonics, st)
                       : launch_harmonic_sum<false>(q, pd, sf, cu, rows, bins,
                                                    harmonics, st));
}

}  // extern "C"
