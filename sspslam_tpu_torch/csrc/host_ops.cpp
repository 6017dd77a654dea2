// Native host-side runtime kernels for sspslam_tpu_torch: a copy of the
// JAX package's sspslam_tpu/native/host_ops.cpp.
//
// The device hot loop is the Simulator's step on the card; this library
// supplies the native host runtime around it: data-pipeline preprocessing
// (trajectory resampling, landmark visibility precomputation, quasi-random
// sequence generation) and offline analysis kernels (blocked argmax
// similarity decoding, IIR filtering) that would otherwise bottleneck
// single-core NumPy on long (2e5-step) recordings.
//
// Exposed through a plain C ABI and loaded with ctypes
// (sspslam_tpu_torch/native/__init__.py, which builds it with g++ at first
// use); every entry point has a NumPy fallback.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <limits>

extern "C" {

// Roberts' R_d low-discrepancy sequence: out is (n, d) row-major.
void rd_sampling(int64_t n, int64_t d, double seed, double* out) {
    // g solves g^(d+1) = g + 1
    double g = 2.0;
    for (int i = 0; i < 40; ++i) g = std::pow(1.0 + g, 1.0 / (d + 1));
    double* alpha = new double[d];
    for (int64_t j = 0; j < d; ++j)
        alpha[j] = std::fmod(std::pow(1.0 / g, (double)(j + 1)), 1.0);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t j = 0; j < d; ++j)
            out[i * d + j] = std::fmod(seed + alpha[j] * (double)(i + 1), 1.0);
    delete[] alpha;
}

// Linear trajectory resampling from dt0 to dt1. in: (n0, dim); out: (n1, dim)
// with n1 = floor(n0 * dt0 / dt1).
void stretch_trajectory(const double* in, int64_t n0, int64_t dim,
                        double dt0, double dt1, double* out, int64_t n1) {
    const double total = (double)n0 * dt0;
    for (int64_t i = 0; i < n1; ++i) {
        double t = (n1 <= 1) ? 0.0 : total * (double)i / (double)(n1 - 1);
        double pos = (n0 <= 1) ? 0.0 : t / total * (double)(n0 - 1);
        int64_t lo = (int64_t)pos;
        if (lo >= n0 - 1) lo = n0 - 2;
        if (lo < 0) lo = 0;
        double frac = pos - (double)lo;
        for (int64_t j = 0; j < dim; ++j) {
            double a = in[lo * dim + j];
            double b = in[(lo + 1) * dim + j];
            out[i * dim + j] = a + frac * (b - a);
        }
    }
}

// Nearest landmark within view radius per timestep.
// vecs: (T, L, D) row-major vectors agent->landmark; ids: (T,) output with
// the nearest in-view landmark index or -1; dists: (T,) nearest distance.
void nearest_landmark(const double* vecs, int64_t T, int64_t L, int64_t D,
                      double view_rad, int64_t* ids, double* dists) {
    for (int64_t t = 0; t < T; ++t) {
        double best = std::numeric_limits<double>::infinity();
        int64_t best_l = -1;
        const double* row = vecs + t * L * D;
        for (int64_t l = 0; l < L; ++l) {
            double s = 0.0;
            for (int64_t k = 0; k < D; ++k) {
                double v = row[l * D + k];
                s += v * v;
            }
            if (s < best) { best = s; best_l = l; }
        }
        double dist = std::sqrt(best);
        dists[t] = dist;
        ids[t] = (dist <= view_rad) ? best_l : -1;
    }
}

// Blocked argmax similarity decode: for each row of data (T, d), find the
// bank row (M, d) with maximal dot product. float32, cache-blocked over the
// bank so long recordings decode at memory speed.
void argmax_decode(const float* data, int64_t T, int64_t d,
                   const float* bank, int64_t M, int64_t* out_idx) {
    const int64_t BT = 64;  // data rows per block
    float* best = new float[BT];
    int64_t* besti = new int64_t[BT];
    for (int64_t t0 = 0; t0 < T; t0 += BT) {
        int64_t bt = std::min(BT, T - t0);
        for (int64_t i = 0; i < bt; ++i) {
            best[i] = -std::numeric_limits<float>::infinity();
            besti[i] = 0;
        }
        for (int64_t m = 0; m < M; ++m) {
            const float* brow = bank + m * d;
            for (int64_t i = 0; i < bt; ++i) {
                const float* drow = data + (t0 + i) * d;
                float s = 0.f;
                for (int64_t k = 0; k < d; ++k) s += drow[k] * brow[k];
                if (s > best[i]) { best[i] = s; besti[i] = m; }
            }
        }
        for (int64_t i = 0; i < bt; ++i) out_idx[t0 + i] = besti[i];
    }
    delete[] best;
    delete[] besti;
}

// One-pole lowpass filter along axis 0: y[t] = a*y[t-1] + (1-a)*x[t].
// x, y: (T, d) float32; in-place safe when x == y.
void lowpass_filter(const float* x, int64_t T, int64_t d, float a, float* y) {
    const float b = 1.0f - a;
    for (int64_t k = 0; k < d; ++k) y[k] = b * x[k];
    for (int64_t t = 1; t < T; ++t) {
        const float* xr = x + t * d;
        const float* yp = y + (t - 1) * d;
        float* yr = y + t * d;
        for (int64_t k = 0; k < d; ++k) yr[k] = a * yp[k] + b * xr[k];
    }
}

// LIF rate curve: r = amp / (tau_ref + tau_rc * log1p(1/(J-1))) for J > 1.
void lif_rates(const float* J, int64_t n, float tau_rc, float tau_ref,
               float amplitude, float* out) {
    for (int64_t i = 0; i < n; ++i) {
        float j = J[i];
        if (j > 1.0f + 1e-9f) {
            out[i] = amplitude /
                     (tau_ref + tau_rc * std::log1p(1.0f / (j - 1.0f)));
        } else {
            out[i] = 0.0f;
        }
    }
}

}  // extern "C"
