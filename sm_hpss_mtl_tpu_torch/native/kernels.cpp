// Native host-side data-pipeline kernels of the PyTorch port.
//
// A copy of the JAX package's native/kernels.cpp below this comment block,
// held to it by tests/test_torch_native.py.  C++ counterpart of the
// reference's Cython module tools.pyx (extract_patches, removeSilence,
// scale_data, get_data_statistics), plus the Gaussian noise sampler of
// the host batcher.  These run on the host CPU inside the data loader;
// results equal the numpy twins (ops/patches.py, ops/silence.py,
// ops/stats.py, data/batcher.py::scale_frames), which the tests enforce.
//
// Exposed through a plain C ABI for ctypes.  Built at first use by
// sm_hpss_mtl_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
// -std=c++17) into build/torch_native/ at the repository root.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

// xoshiro256++ (Blackman/Vigna, public domain), splitmix64-seeded.
inline uint64_t rotl64(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }

struct Xoshiro256 {
    uint64_t s[4];
    explicit Xoshiro256(uint64_t seed) {
        uint64_t z = seed;
        for (int i = 0; i < 4; ++i) {
            z += 0x9e3779b97f4a7c15ULL;
            uint64_t t = z;
            t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
            t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
            s[i] = t ^ (t >> 31);
        }
    }
    inline uint64_t next() {
        const uint64_t r = rotl64(s[0] + s[3], 23) + s[0];
        const uint64_t t = s[1] << 17;
        s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
        s[2] ^= t; s[3] = rotl64(s[3], 45);
        return r;
    }
};

// Marsaglia-Tsang ziggurat for the standard normal, 128 layers (the
// classic r4_nor construction).  ~3x faster than Box-Muller on scalar
// cores because >98% of draws are one table compare + multiply; only
// wedge/tail draws touch exp/log.
float g_zig_wn[128], g_zig_fn[128];
uint32_t g_zig_kn[128];
bool g_zig_ready = false;

void zig_init() {
    double m = 2147483648.0, dn = 3.442619855899, tn = dn,
           vn = 9.91256303526217e-3;
    const double q = vn / std::exp(-0.5 * dn * dn);
    g_zig_kn[0] = (uint32_t)((dn / q) * m);
    g_zig_kn[1] = 0;
    g_zig_wn[0] = (float)(q / m);
    g_zig_wn[127] = (float)(dn / m);
    g_zig_fn[0] = 1.0f;
    g_zig_fn[127] = (float)std::exp(-0.5 * dn * dn);
    for (int i = 126; i >= 1; --i) {
        dn = std::sqrt(-2.0 * std::log(vn / dn + std::exp(-0.5 * dn * dn)));
        g_zig_kn[i + 1] = (uint32_t)((dn / tn) * m);
        tn = dn;
        g_zig_fn[i] = (float)std::exp(-0.5 * dn * dn);
        g_zig_wn[i] = (float)(dn / m);
    }
    g_zig_ready = true;
}

inline float zig_uni(Xoshiro256& rng) {
    return (float)((rng.next() >> 40) * (1.0 / 16777216.0));
}

float zig_nfix(Xoshiro256& rng, int32_t hz, int iz) {
    const float r = 3.442620f;
    float x, y;
    for (;;) {
        x = hz * g_zig_wn[iz];
        if (iz == 0) {  // tail
            do {
                x = -std::log(zig_uni(rng) + 5.96e-8f) * (1.0f / r);
                y = -std::log(zig_uni(rng) + 5.96e-8f);
            } while (y + y < x * x);
            return hz > 0 ? r + x : -r - x;
        }
        if (g_zig_fn[iz] + zig_uni(rng) * (g_zig_fn[iz - 1] - g_zig_fn[iz])
                < std::exp(-0.5f * x * x))
            return x;
        hz = (int32_t)(uint32_t)rng.next();
        iz = hz & 127;
        if ((uint32_t)(hz < 0 ? -(int64_t)hz : hz) < g_zig_kn[iz])
            return hz * g_zig_wn[iz];
    }
}

}  // namespace

extern "C" {

// In-place x[i] += scale * N(0,1) over n floats — the reference's
// Gaussian batch augmentation (Proposed_Work_Results.py:239-242) without
// numpy's float64 Generator cost (measured ~3x faster than
// rng.standard_normal(float32) on this host, and no f64 upcast of the
// batch).  Deterministic for a given seed; the stream is this module's
// own, not numpy's.
void add_gaussian_noise_f32(float* x, int64_t n, float scale,
                            uint64_t seed) {
    if (!g_zig_ready) zig_init();
    Xoshiro256 rng(seed);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t hz = (int32_t)(uint32_t)rng.next();
        const int iz = hz & 127;
        const float g =
            ((uint32_t)(hz < 0 ? -(int64_t)hz : hz) < g_zig_kn[iz])
                ? hz * g_zig_wn[iz]
                : zig_nfix(rng, hz, iz);
        x[i] += scale * g;
    }
}

// Sliding-window patch extraction over the time axis of a (D, T)
// featuregram laid out row-major.  Start indices: 0, shift, 2*shift, ...
// n_patches windows of width patch_size (caller applies the short-clip
// tiling rule and computes n_patches).  out: (n_patches, D, patch_size).
void extract_patches_f32(const float* fv, int64_t D, int64_t T,
                         int64_t patch_size, int64_t shift,
                         int64_t n_patches, float* out) {
    for (int64_t p = 0; p < n_patches; ++p) {
        const int64_t start = p * shift;
        float* dst = out + p * D * patch_size;
        for (int64_t d = 0; d < D; ++d) {
            std::memcpy(dst + d * patch_size, fv + d * T + start,
                        sizeof(float) * patch_size);
        }
    }
}

// Per-row standardization over time: (x - mean) / std, std==0 -> 1
// (sklearn StandardScaler semantics used by get_feature_patches).
void standardize_rows_f32(float* fv, int64_t D, int64_t T) {
    for (int64_t d = 0; d < D; ++d) {
        float* row = fv + d * T;
        double mean = 0.0;
        for (int64_t t = 0; t < T; ++t) mean += row[t];
        mean /= (double)T;
        double var = 0.0;
        for (int64_t t = 0; t < T; ++t) {
            const double c = row[t] - mean;
            var += c * c;
        }
        var /= (double)T;
        double scale = std::sqrt(var);
        if (scale == 0.0) scale = 1.0;
        for (int64_t t = 0; t < T; ++t)
            row[t] = (float)((row[t] - mean) / scale);
    }
}

// Frame-level corpus scaling: (fv - mean) / (std + 1e-10) per row
// (tools.pyx:138-166).
void scale_frames_f32(const float* fv, const float* mean, const float* stdev,
                      int64_t D, int64_t T, float* out) {
    for (int64_t d = 0; d < D; ++d) {
        const double m = mean[d];
        const double s = (double)stdev[d] + 1e-10;
        const float* src = fv + d * T;
        float* dst = out + d * T;
        for (int64_t t = 0; t < T; ++t)
            dst[t] = (float)((src[t] - m) / s);
    }
}

// Silence-marker pipeline (tools.pyx:83-123 semantics): threshold at
// alpha*max(energy), 5-tap median smooth (zero-padded edges, matching
// scipy.signal.medfilt), then run-length scan.  Writes qualifying
// silent-segment sample spans [k, l) into segments (2*max_segments ints)
// and the per-frame marker; returns the segment count.
int64_t silence_segments(const double* energy, int64_t n_frames,
                         int64_t n_samples, double fs,
                         int64_t frame_size, int64_t frame_shift,
                         double alpha, double beta,
                         int64_t* segments, int64_t max_segments,
                         int64_t* frame_marker) {
    double emax = 0.0;
    for (int64_t i = 0; i < n_frames; ++i) emax = std::max(emax, energy[i]);
    const double thresh = alpha * emax;
    for (int64_t i = 0; i < n_frames; ++i)
        frame_marker[i] = energy[i] >= thresh ? 1 : 0;

    // medfilt(k=5) with zero padding: output = median of the 5-window.
    // For 0/1 data the median is (sum >= 3).
    int64_t* smoothed = new int64_t[n_frames];
    for (int64_t i = 0; i < n_frames; ++i) {
        int64_t s = 0;
        for (int64_t j = i - 2; j <= i + 2; ++j)
            if (j >= 0 && j < n_frames) s += frame_marker[j];
        smoothed[i] = s >= 3 ? 1 : 0;
    }
    std::memcpy(frame_marker, smoothed, sizeof(int64_t) * n_frames);
    delete[] smoothed;

    int64_t n_seg = 0;
    int64_t i = 0;
    while (i < n_frames) {
        while (frame_marker[i] == 1) {
            if (i == n_frames - 1) break;
            ++i;
        }
        int64_t j = i;
        while (frame_marker[j] == 0) {
            if (j == n_frames - 1) break;
            ++j;
        }
        const int64_t k = std::max(frame_shift * (i - 1) + frame_size,
                                   (int64_t)1);
        const int64_t l = std::min(frame_shift * (j - 1) + frame_size,
                                   n_samples);
        if ((double)(l - k) / fs > beta && n_seg < max_segments) {
            segments[2 * n_seg] = k;
            segments[2 * n_seg + 1] = l;
            ++n_seg;
        }
        i = j + 1;
    }
    return n_seg;
}

// Per-patch moment statistics over (N, F, T) patches.
// axis=0: per-column stats -> out (N, T); axis=1: per-row -> out (N, F).
// stat: 0=mean, 1=variance, 2=skew, 3=kurtosis (biased, Fisher), with
// zero-variance slices yielding 0 (ops/stats.py semantics).
void patch_statistics_f64(const double* fv, int64_t N, int64_t F, int64_t T,
                          int32_t stat, int32_t axis, double* out) {
    const int64_t outer = axis == 0 ? T : F;   // output length per patch
    const int64_t inner = axis == 0 ? F : T;   // reduced length
    for (int64_t n = 0; n < N; ++n) {
        const double* patch = fv + n * F * T;
        for (int64_t o = 0; o < outer; ++o) {
            double mean = 0.0;
            for (int64_t r = 0; r < inner; ++r) {
                const double v = axis == 0 ? patch[r * T + o]
                                           : patch[o * T + r];
                mean += v;
            }
            mean /= (double)inner;
            double m2 = 0.0, m3 = 0.0, m4 = 0.0;
            for (int64_t r = 0; r < inner; ++r) {
                const double v = (axis == 0 ? patch[r * T + o]
                                            : patch[o * T + r]) - mean;
                const double v2 = v * v;
                m2 += v2;
                m3 += v2 * v;
                m4 += v2 * v2;
            }
            m2 /= inner; m3 /= inner; m4 /= inner;
            double val;
            switch (stat) {
                case 0: val = mean; break;
                case 1: val = m2; break;
                case 2: val = m2 > 1e-12 ? m3 / std::pow(m2, 1.5) : 0.0; break;
                default: val = m2 > 1e-12 ? m4 / (m2 * m2) - 3.0 : 0.0; break;
            }
            out[n * outer + o] = val;
        }
    }
}

}  // extern "C"
