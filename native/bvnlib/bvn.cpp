// Host-side double-precision bivariate-normal probabilities (C++).
//
// First-party native implementation of the Drezner–Wesolowsky / Genz
// algorithm for rectangular bivariate normal probabilities — the role the
// reference fills with Alan Genz's Fortran MVNDST reached through
// scipy.stats.mvn.mvnun (ParasitoidModel.py:22,340; removed from modern
// SciPy).  The device compute path never calls this (ops/bvn.py integrates
// on-device); this library serves host tooling: the high-precision oracle
// behind the device integrator's tests, the reference-oracle shim used for
// parity testing, and fast host-side kernel previews (viz/explore.py).
//
// Method (Drezner & Wesolowsky 1990; Genz 2004 "Numerical computation of
// rectangular bivariate and trivariate normal and t probabilities"):
// Gauss–Legendre quadrature of the correlation integral for |r| <= 0.925,
// complementary asymptotic-series form for |r| > 0.925.  Abs. error ~1e-14.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr double kSqrt2Pi = 2.5066282746310005024157652848110;

// Phi(x): standard normal CDF via erfc for full double accuracy.
inline double phi(double x) { return 0.5 * std::erfc(-x * M_SQRT1_2); }

// 20-point Gauss–Legendre nodes/weights on [-1, 1] (symmetric halves).
constexpr int kGL = 20;
const double kGLx[kGL] = {
    -0.9931285991850949, -0.9639719272779138, -0.9122344282513259,
    -0.8391169718222188, -0.7463319064601508, -0.6360536807265150,
    -0.5108670019508271, -0.3737060887154195, -0.2277858511416451,
    -0.0765265211334973,  0.0765265211334973,  0.2277858511416451,
     0.3737060887154195,  0.5108670019508271,  0.6360536807265150,
     0.7463319064601508,  0.8391169718222188,  0.9122344282513259,
     0.9639719272779138,  0.9931285991850949};
const double kGLw[kGL] = {
    0.0176140071391521, 0.0406014298003869, 0.0626720483341091,
    0.0832767415767048, 0.1019301198172404, 0.1181945319615184,
    0.1316886384491766, 0.1420961093183820, 0.1491729864726037,
    0.1527533871307258, 0.1527533871307258, 0.1491729864726037,
    0.1420961093183820, 0.1316886384491766, 0.1181945319615184,
    0.1019301198172404, 0.0832767415767048, 0.0626720483341091,
    0.0406014298003869, 0.0176140071391521};

// P(X > h, Y > k) for standard bivariate normal with correlation r.
double bvn_upper_scalar(double h, double k, double r) {
  if (std::isinf(h) && h > 0) return 0.0;
  if (std::isinf(k) && k > 0) return 0.0;
  if (std::isinf(h) && h < 0) return phi(-k);
  if (std::isinf(k) && k < 0) return phi(-h);

  double bvn = 0.0;
  if (std::fabs(r) < 0.925) {
    if (r == 0.0) return phi(-h) * phi(-k);
    const double hk = h * k;
    const double hs = 0.5 * (h * h + k * k);
    const double asr = std::asin(r);
    for (int i = 0; i < kGL; ++i) {
      const double sn = std::sin(asr * 0.5 * (1.0 + kGLx[i]));
      bvn += kGLw[i] * std::exp((sn * hk - hs) / (1.0 - sn * sn));
    }
    return bvn * asr / (2.0 * kTwoPi) + phi(-h) * phi(-k);
  }

  // |r| >= 0.925: complementary form.
  double kk = (r < 0.0) ? -k : k;
  double hk = h * kk;
  if (std::fabs(r) < 1.0) {
    const double a_sq = (1.0 - r) * (1.0 + r);
    const double a = std::sqrt(a_sq);
    const double bs = (h - kk) * (h - kk);
    const double c = (4.0 - hk) / 8.0;
    const double d = (12.0 - hk) / 16.0;
    double asr = -(bs / a_sq + hk) / 2.0;
    if (asr > -100.0)
      bvn = a * std::exp(asr) *
            (1.0 - c * (bs - a_sq) * (1.0 - d * bs / 5.0) / 3.0 +
             c * d * a_sq * a_sq / 5.0);
    if (-hk < 100.0) {
      const double b = std::sqrt(bs);
      bvn -= std::exp(-hk / 2.0) * kSqrt2Pi * phi(-b / a) * b *
             (1.0 - c * bs * (1.0 - d * bs / 5.0) / 3.0);
    }
    const double a_half = a / 2.0;
    for (int i = 0; i < kGL; ++i) {
      const double x = a_half * (1.0 + kGLx[i]);
      const double xs = x * x;
      const double asr1 = -(bs / xs + hk) / 2.0;
      if (asr1 > -100.0) {
        const double rs = std::sqrt(1.0 - xs);
        const double sp = 1.0 + c * xs * (1.0 + d * xs);
        const double ep =
            std::exp(-hk * (1.0 - rs) / (2.0 * (1.0 + rs))) / rs;
        bvn += a_half * kGLw[i] * std::exp(asr1) * (ep - sp);
      }
    }
    bvn = -bvn / kTwoPi;
  }
  if (r > 0.0) return bvn + phi(-std::max(h, kk));
  double out = -bvn;
  if (kk > h) out += phi(kk) - phi(h);
  return out;
}

}  // namespace

extern "C" {

// P(X > h, Y > k), standard bivariate normal, correlation r.
double pt_bvn_upper(double h, double k, double r) {
  return bvn_upper_scalar(h, k, r);
}

// P(low <= (X, Y) <= upp) for N(mu, [[sx^2, rho sx sy], [., sy^2]]) —
// the mvnun equivalent (same call meaning as ParasitoidModel.py:340).
double pt_bvn_rect(double lox, double loy, double upx, double upy,
                   double mux, double muy, double sx, double sy,
                   double rho) {
  const double lx = (lox - mux) / sx, ux = (upx - mux) / sx;
  const double ly = (loy - muy) / sy, uy = (upy - muy) / sy;
  return bvn_upper_scalar(lx, ly, rho) - bvn_upper_scalar(ux, ly, rho) -
         bvn_upper_scalar(lx, uy, rho) + bvn_upper_scalar(ux, uy, rho);
}

// Fill out[(2K+1)*(2K+1)] row-major with cell masses of N(mu, S) over a
// (2K+1)^2 window of square cells of side `cell`, centered on the center
// cell: row 0 = +y edge, col 0 = -x edge (the reference cdf_mat layout,
// ParasitoidModel.py:377-378).  Computes the (n+1)^2 corner lattice of
// upper-orthant values once and differences it — O(n^2) bvn evaluations.
void pt_bvn_cell_masses(double mux, double muy, double sx, double sy,
                        double rho, double cell, int32_t K, double* out) {
  const int n = 2 * K + 1;
  const int ne = n + 1;
  // corner lattice U[xe_i][ye_j] = P(X > xe_i, Y > ye_j), standardized
  double* U = new double[ne * ne];
  for (int i = 0; i < ne; ++i) {
    const double xe = ((i - K - 0.5) * cell - mux) / sx;
    for (int j = 0; j < ne; ++j) {
      const double ye = ((K + 0.5 - j) * cell - muy) / sy;
      U[i * ne + j] = bvn_upper_scalar(xe, ye, rho);
    }
  }
  // cell (row i, col j): x in [xe_j, xe_{j+1}], y in [ye_{i+1}, ye_i]
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      const double a = U[j * ne + (i + 1)];        // x>xe_j,   y>ye_{i+1}
      const double b = U[(j + 1) * ne + (i + 1)];  // x>xe_j+1, y>ye_{i+1}
      const double c = U[j * ne + i];              // x>xe_j,   y>ye_i
      const double d = U[(j + 1) * ne + i];        // x>xe_j+1, y>ye_i
      out[i * n + j] = (a - b) - (c - d);
    }
  }
  delete[] U;
}


}  // extern "C"
