// Native harness core — the TPU framework's analogue of the reference's
// C/C++ host-side L4 layer (data generation, golden comparison, timing
// statistics; reference SMFFT_CooleyTukey_C2C/FFT.c:14-77,
// SMFFT_Stockham_R2C_C2R/FFT.c:67-185).
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11 in
// this environment).  All buffers are caller-allocated numpy arrays.
//
// Re-implemented from the reference's *behavior*, not its code:
//  * smfft_generate_uniform  — seeded uniform complex/real fixtures
//    (deterministic, unlike the reference's time(NULL) seeding, FFT.c:139)
//  * smfft_generate_two_tone — the reference's dead Generate_signal
//    (FFT.c:14-21) resurrected: two sinusoids at f1, f2 with amplitudes
//    a1, a2, as a deterministic fixture.
//  * smfft_compare           — element-wise max(re, im) error with the
//    reference's hybrid metric: absolute difference, decade-normalized
//    when |value| > 10 (get_error, FFT.c:23-49); returns error count above
//    tolerance plus total/mean/max statistics (Compare_data, FFT.c:52-77).
//  * smfft_compare_r2c       — layout-aware compare of the packed R2C
//    output (slot 0 = DC + i*Nyquist) against a full (N/2+1) golden
//    spectrum (Compare_R2C_output, FFT.c:126-159).

#include <cmath>
#include <cstdint>
#include <cstdlib>

extern "C" {

// xorshift128+ — small, fast, deterministic PRNG for fixtures.
static inline uint64_t xs128p(uint64_t* s) {
    uint64_t x = s[0];
    uint64_t const y = s[1];
    s[0] = y;
    x ^= x << 23;
    s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s[1] + y;
}

static inline float uniform01(uint64_t* s) {
    return (float)((xs128p(s) >> 11) * (1.0 / 9007199254740992.0));
}

void smfft_generate_uniform(float* out, int64_t count, uint64_t seed,
                            float lo, float hi) {
    uint64_t s[2] = {seed ^ 0x9E3779B97F4A7C15ull, seed * 2654435761ull + 1};
    xs128p(s); xs128p(s);
    for (int64_t i = 0; i < count; ++i)
        out[i] = lo + (hi - lo) * uniform01(s);
}

void smfft_generate_two_tone(float* out, int64_t n_ffts, int64_t n,
                             float f1, float a1, float f2, float a2) {
    const double twopi = 6.283185307179586476925286766559;
    for (int64_t b = 0; b < n_ffts; ++b)
        for (int64_t i = 0; i < n; ++i)
            out[b * n + i] =
                (float)(a1 * std::sin(twopi * f1 * (double)i / (double)n) +
                        a2 * std::sin(twopi * f2 * (double)i / (double)n));
}

// The reference's hybrid error metric (get_error, FFT.c:23-49): absolute
// difference; when the golden magnitude exceeds 10, normalize by the
// magnitude's decade (10^floor(log10|v|)) — "absolute below 10, decade-
// relative above".
static inline double hybrid_error(double got, double want) {
    double err = std::fabs(want - got);
    double mag = std::fabs(want);
    if (mag > 10.0) {
        double decade = std::pow(10.0, std::floor(std::log10(mag)));
        err /= decade;
    }
    return err;
}

typedef struct {
    double total_error;
    double mean_error;
    double max_error;
    int64_t error_count;  // elements with hybrid error > tolerance
} smfft_compare_stats;

// Interleaved complex compare (re, im pairs), max over components per
// element — Compare_data semantics (FFT.c:52-77).
void smfft_compare(const float* got, const float* want, int64_t n_elems,
                   double tolerance, smfft_compare_stats* stats) {
    double total = 0.0, maxe = 0.0;
    int64_t count = 0;
    for (int64_t i = 0; i < n_elems; ++i) {
        double er = hybrid_error(got[2 * i], want[2 * i]);
        double ei = hybrid_error(got[2 * i + 1], want[2 * i + 1]);
        double e = er > ei ? er : ei;
        total += e;
        if (e > maxe) maxe = e;
        if (e > tolerance) ++count;
    }
    stats->total_error = total;
    stats->mean_error = n_elems ? total / (double)n_elems : 0.0;
    stats->max_error = maxe;
    stats->error_count = count;
}

// Packed R2C layout compare (Compare_R2C_output, FFT.c:126-159):
// got is (n_ffts, L) complex packed with got[b][0] = (DC, Nyquist);
// want is (n_ffts, L+1) complex golden (numpy rfft layout).
void smfft_compare_r2c(const float* got, const float* want, int64_t n_ffts,
                       int64_t l, double tolerance,
                       smfft_compare_stats* stats) {
    double total = 0.0, maxe = 0.0;
    int64_t count = 0, n_checked = 0;
    for (int64_t b = 0; b < n_ffts; ++b) {
        const float* g = got + b * 2 * l;
        const float* w = want + b * 2 * (l + 1);
        // slot 0: DC (vs want[0].re) and Nyquist (vs want[L].re)
        double e0 = hybrid_error(g[0], w[0]);
        double e1 = hybrid_error(g[1], w[2 * l]);
        double e = e0 > e1 ? e0 : e1;
        total += e; if (e > maxe) maxe = e; if (e > tolerance) ++count;
        ++n_checked;
        for (int64_t k = 1; k < l; ++k) {
            double er = hybrid_error(g[2 * k], w[2 * k]);
            double ei = hybrid_error(g[2 * k + 1], w[2 * k + 1]);
            e = er > ei ? er : ei;
            total += e; if (e > maxe) maxe = e; if (e > tolerance) ++count;
            ++n_checked;
        }
    }
    stats->total_error = total;
    stats->mean_error = n_checked ? total / (double)n_checked : 0.0;
    stats->max_error = maxe;
    stats->error_count = count;
}

// Real-signal compare with independent normalizations — Compare_C2R_output
// semantics (FFT.c:161-185): got scaled by 1/got_scale, want by 1/want_scale.
void smfft_compare_real(const float* got, const float* want, int64_t n,
                        double got_scale, double want_scale, double tolerance,
                        smfft_compare_stats* stats) {
    double total = 0.0, maxe = 0.0;
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        double e = hybrid_error((double)got[i] / got_scale,
                                (double)want[i] / want_scale);
        total += e;
        if (e > maxe) maxe = e;
        if (e > tolerance) ++count;
    }
    stats->total_error = total;
    stats->mean_error = n ? total / (double)n : 0.0;
    stats->max_error = maxe;
    stats->error_count = count;
}

}  // extern "C"
