// Native DSM registration: multiscale NaN-aware NCC + z-affine.
//
// Parity target: the reference's numba-jitted kernels (eval/dsmr.py):
//   downsample2x_ (:15-43), mean_std_base (:94-134), compute_ncc (:147-163),
//   recursive_ncc (:166-179), apply_shift_ (:183-194).
// C++/OpenMP replaces numba, which the package does not depend on; built by
// g++ at first use and exposed via ctypes (eogs2_tpu_torch/native). The
// vectorized numpy implementation (eval/registration.py) is its plain
// version, which the tests hold it against.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

static inline double valnan(const double* u, int64_t h, int64_t w, int64_t j,
                            int64_t i) {
  if (i >= 0 && j >= 0 && i < w && j < h) return u[j * w + i];
  return std::numeric_limits<double>::quiet_NaN();
}

// NaN-mean 2x downsample. out must be [ceil(h/2), ceil(w/2)].
void downsample2x(const double* u, int64_t h, int64_t w, double* out) {
  int64_t oh = (h + 1) / 2, ow = (w + 1) / 2;
#pragma omp parallel for
  for (int64_t j = 0; j < oh; ++j) {
    for (int64_t i = 0; i < ow; ++i) {
      double v = 0.0;
      int cnt = 0;
      for (int l = 0; l < 2; ++l)
        for (int k = 0; k < 2; ++k) {
          int64_t jj = 2 * j + l, ii = 2 * i + k;
          if (ii < w && jj < h) {
            double t = u[jj * w + ii];
            if (std::isfinite(t)) {
              v += t;
              ++cnt;
            }
          }
        }
      out[j * ow + i] =
          cnt > 0 ? v / cnt : std::numeric_limits<double>::quiet_NaN();
    }
  }
}

// Joint stats of u and v shifted by (dx,dy): means, stds, cross-corr.
void mean_std(const double* u, const double* v, int64_t h, int64_t w, int dx,
              int dy, double* out5) {
  double muu = 0, muv = 0;
  int64_t count = 0;
#pragma omp parallel for reduction(+ : muu, muv, count)
  for (int64_t j = 0; j < h; ++j) {
    for (int64_t i = 0; i < w; ++i) {
      double vu = u[j * w + i];
      int64_t jj = j + dy, ii = i + dx;
      if (ii >= 0 && ii < w && jj >= 0 && jj < h) {
        double vv = v[jj * w + ii];
        if (std::isfinite(vu) && std::isfinite(vv)) {
          muu += vu;
          muv += vv;
          ++count;
        }
      }
    }
  }
  if (count == 0) {
    for (int k = 0; k < 5; ++k)
      out5[k] = std::numeric_limits<double>::quiet_NaN();
    return;
  }
  muu /= count;
  muv /= count;
  double sigu = 0, sigv = 0, xcorr = 0;
#pragma omp parallel for reduction(+ : sigu, sigv, xcorr)
  for (int64_t j = 0; j < h; ++j) {
    for (int64_t i = 0; i < w; ++i) {
      double vu = u[j * w + i] - muu;
      int64_t jj = j + dy, ii = i + dx;
      if (ii >= 0 && ii < w && jj >= 0 && jj < h) {
        double vv = v[jj * w + ii] - muv;
        if (std::isfinite(vu) && std::isfinite(vv)) {
          sigu += vu * vu;
          sigv += vv * vv;
          xcorr += vu * vv;
        }
      }
    }
  }
  out5[0] = muu;
  out5[1] = muv;
  out5[2] = std::sqrt(sigu / count);
  out5[3] = std::sqrt(sigv / count);
  out5[4] = xcorr / count;
}

static double ncc(const double* u, const double* v, int64_t h, int64_t w,
                  int dx, int dy) {
  double s[5];
  mean_std(u, v, h, w, dx, dy, s);
  return s[4] / (s[2] * s[3] + 1e-8);
}

// Exhaustive +-irange NCC search around (initdx, initdy).
void compute_ncc(const double* u, const double* v, int64_t h, int64_t w,
                 int irange, int initdx, int initdy, int* best) {
  int n = 2 * irange + 1;
  std::vector<double> scores((size_t)n * n);
#pragma omp parallel for collapse(2)
  for (int yi = 0; yi < n; ++yi) {
    for (int xi = 0; xi < n; ++xi) {
      scores[(size_t)yi * n + xi] =
          ncc(u, v, h, w, initdx - irange + xi, initdy - irange + yi);
    }
  }
  double maxv = -std::numeric_limits<double>::infinity();
  best[0] = initdx;
  best[1] = initdy;
  for (int yi = 0; yi < n; ++yi)
    for (int xi = 0; xi < n; ++xi)
      if (scores[(size_t)yi * n + xi] > maxv) {
        maxv = scores[(size_t)yi * n + xi];
        best[0] = initdx - irange + xi;
        best[1] = initdy - irange + yi;
      }
}

// Multiscale recursion (allocates pyramid internally).
void recursive_ncc(const double* u, const double* v, int64_t h, int64_t w,
                   int irange, int dx, int dy, int* best) {
  if (h > 100 && w > 100) {
    int64_t oh = (h + 1) / 2, ow = (w + 1) / 2;
    std::vector<double> su((size_t)oh * ow), sv((size_t)oh * ow);
    downsample2x(u, h, w, su.data());
    downsample2x(v, h, w, sv.data());
    int sub[2];
    recursive_ncc(su.data(), sv.data(), oh, ow, irange, dx / 2, dy / 2, sub);
    dx = sub[0] * 2;
    dy = sub[1] * 2;
  }
  compute_ncc(u, v, h, w, irange, dx, dy, best);
}

// Full compute_shift: returns (dx, dy, a, b) in out4.
void compute_shift(const double* ref, const double* sec, int64_t h, int64_t w,
                   int scaling, double* out4) {
  int best[2] = {0, 0};
  recursive_ncc(ref, sec, h, w, 5, 0, 0, best);
  double s[5];
  mean_std(ref, sec, h, w, best[0], best[1], s);
  double a = scaling ? s[2] / s[3] : 1.0;
  double b = s[0] - s[1] * a;
  out4[0] = best[0];
  out4[1] = best[1];
  out4[2] = a;
  out4[3] = b;
}

// out[j,i] = a * valnan(v, i+dx, j+dy) + b + c*i + d*j
void apply_shift(const double* v, int64_t h, int64_t w, int dx, int dy,
                 double a, double b, double c, double d, double* out) {
#pragma omp parallel for
  for (int64_t j = 0; j < h; ++j)
    for (int64_t i = 0; i < w; ++i)
      out[j * w + i] = a * valnan(v, h, w, j + dy, i + dx) + b + c * i + d * j;
}

}  // extern "C"
