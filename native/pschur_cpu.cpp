// Native CPU reference implementation of the real periodic Schur
// decomposition: periodic Hessenberg reduction (MB03VD shape, reference
// /root/reference/src/PeriodicSchurDecompositions.jl:213-259) followed by the
// Francis double-shift periodic QR iteration (MB03WD shape, reference
// :322-1096).  Scalar sequential C++ — the honest "what a good CPU
// implementation of the reference's algorithm does" baseline that bench.py
// times against the JAX pipeline, and a fast exact float64 host backend.
//
// This is an independent rewrite of the same algorithm the JAX cores in
// ../periodicschurdecompositions_jax/ops/{hessenberg,pqr_real}.py
// implement (no code from /root/reference is copied); the scalar control
// flow (shrinking windows, early exits) is the natural CPU formulation that
// the JAX cores replace with masked static-shape sweeps.
//
// Layout: row-major n x n matrices, p of them contiguous: A[f][r][c] =
// A[(size_t)f*n*n + (size_t)r*n + c].
//
// Build: g++ -O3 -march=native -shared -fPIC -o libpschur_cpu.so pschur_cpu.cpp

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

using std::fabs;
using std::sqrt;

inline double* mat(double* base, int f, int n) {
  return base + (size_t)f * n * n;
}

// ---------------------------------------------------------------------------
// Householder reflector (xLARFG semantics): given x[0..q-1], find w (w[0]=1),
// tau, beta with (I - tau w w^T) x = beta e1.
inline void larfg(int q, const double* x, double* w, double& tau,
                  double& beta) {
  double alpha = x[0];
  double xn2 = 0.0;
  for (int t = 1; t < q; ++t) xn2 += x[t] * x[t];
  w[0] = 1.0;
  if (xn2 == 0.0) {
    tau = 0.0;
    beta = alpha;
    for (int t = 1; t < q; ++t) w[t] = 0.0;
    return;
  }
  double b = -copysign(std::hypot(alpha, sqrt(xn2)), alpha);
  tau = (b - alpha) / b;
  double inv = 1.0 / (alpha - b);
  for (int t = 1; t < q; ++t) w[t] = x[t] * inv;
  beta = b;
}

// Apply (I - tau w w^T) from the LEFT to rows r0..r0+q-1, cols [c0, c1).
inline void refl_left(double* M, int n, int r0, int q, int c0, int c1,
                      const double* w, double tau) {
  if (tau == 0.0 || c0 >= c1) return;
  // s[c] = sum_t w[t] * M[r0+t][c]
  static thread_local std::vector<double> s;
  s.assign(c1 - c0, 0.0);
  for (int t = 0; t < q; ++t) {
    const double wt = w[t];
    const double* row = M + (size_t)(r0 + t) * n + c0;
    double* sp = s.data();
    for (int c = 0; c < c1 - c0; ++c) sp[c] += wt * row[c];
  }
  for (int t = 0; t < q; ++t) {
    const double wt_tau = tau * w[t];
    double* row = M + (size_t)(r0 + t) * n + c0;
    const double* sp = s.data();
    for (int c = 0; c < c1 - c0; ++c) row[c] -= wt_tau * sp[c];
  }
}

// Apply (I - tau w w^T) from the RIGHT to cols c0..c0+q-1, rows [r0, r1).
inline void refl_right(double* M, int n, int c0, int q, int r0, int r1,
                       const double* w, double tau) {
  if (tau == 0.0 || r0 >= r1) return;
  for (int r = r0; r < r1; ++r) {
    double* row = M + (size_t)r * n + c0;
    double s = 0.0;
    for (int t = 0; t < q; ++t) s += w[t] * row[t];
    s *= tau;
    for (int t = 0; t < q; ++t) row[t] -= s * w[t];
  }
}

// Apply a small q x q matrix G from the LEFT to rows r0.., cols [c0, c1):
// rows <- G * rows.
inline void mat_left(double* M, int n, int r0, int q, int c0, int c1,
                     const double* G) {
  if (c0 >= c1) return;
  double tmp[3];
  for (int c = c0; c < c1; ++c) {
    for (int a = 0; a < q; ++a) {
      double s = 0.0;
      for (int t = 0; t < q; ++t) s += G[a * q + t] * M[(size_t)(r0 + t) * n + c];
      tmp[a] = s;
    }
    for (int a = 0; a < q; ++a) M[(size_t)(r0 + a) * n + c] = tmp[a];
  }
}

// Apply a small q x q matrix G from the RIGHT to cols c0.., rows [r0, r1):
// cols <- cols * G.
inline void mat_right(double* M, int n, int c0, int q, int r0, int r1,
                      const double* G) {
  double tmp[3];
  for (int r = r0; r < r1; ++r) {
    double* row = M + (size_t)r * n + c0;
    for (int a = 0; a < q; ++a) {
      double s = 0.0;
      for (int t = 0; t < q; ++t) s += row[t] * G[t * q + a];
      tmp[a] = s;
    }
    for (int a = 0; a < q; ++a) row[a] = tmp[a];
  }
}

// G = I - tau w w^T (q x q, symmetric).
inline void refl_to_mat(int q, const double* w, double tau, double* G) {
  for (int a = 0; a < q; ++a)
    for (int b = 0; b < q; ++b)
      G[a * q + b] = (a == b ? 1.0 : 0.0) - tau * w[a] * w[b];
}

// ---------------------------------------------------------------------------
// dlanv2 semantics (standardize a real 2x2; reference src/rschur2x2.jl:9-96
// contract).  Returns the rotation (cs, sn) and eigenvalue pairs.
void lanv2(double& a, double& b, double& c, double& d, double& cs, double& sn,
           double& w1r, double& w1i, double& w2r, double& w2i) {
  const double eps = 2.220446049250313e-16;
  if (c == 0.0) {
    cs = 1.0; sn = 0.0;
  } else if (b == 0.0) {
    cs = 0.0; sn = 1.0;
    double t = d; d = a; a = t;
    b = -c; c = 0.0;
  } else if ((a - d) == 0.0 && ((b < 0) != (c < 0))) {
    cs = 1.0; sn = 0.0;
  } else {
    double temp = a - d;
    double pp = 0.5 * temp;
    double bcmax = std::max(fabs(b), fabs(c));
    double bcmis = std::min(fabs(b), fabs(c)) *
                   (b >= 0 ? 1.0 : -1.0) * (c >= 0 ? 1.0 : -1.0);
    double scale = std::max(fabs(pp), bcmax);
    double z = (pp / scale) * pp + (bcmax / scale) * bcmis;
    if (z >= 4.0 * eps) {
      // real eigenvalues
      double zz = pp + copysign(sqrt(scale) * sqrt(z), pp);
      a = d + zz;
      d -= (bcmax / zz) * bcmis;
      double tau = std::hypot(c, zz);
      cs = zz / tau;
      sn = c / tau;
      b -= c;
      c = 0.0;
    } else {
      // complex or almost-equal real eigenvalues
      double sigma = b + c;
      double tau = std::hypot(sigma, temp);
      cs = sqrt(0.5 * (1.0 + fabs(sigma) / tau));
      sn = -(pp / (tau * cs)) * (sigma >= 0 ? 1.0 : -1.0);
      double aa = a * cs + b * sn, bb = -a * sn + b * cs;
      double cc = c * cs + d * sn, dd = -c * sn + d * cs;
      a = aa * cs + cc * sn;
      b = bb * cs + dd * sn;
      c = -aa * sn + cc * cs;
      d = -bb * sn + dd * cs;
      double mid = 0.5 * (a + d);
      a = mid; d = mid;
      if (c != 0.0) {
        if (b != 0.0) {
          if ((b < 0) == (c < 0)) {
            double sab = sqrt(fabs(b)), sac = sqrt(fabs(c));
            double p2 = copysign(sab * sac, c);
            double t2 = 1.0 / sqrt(fabs(b + c));
            a = mid + p2; d = mid - p2;
            b -= c; c = 0.0;
            double cs1 = sab * t2, sn1 = sac * t2;
            double csr = cs * cs1 - sn * sn1, snr = cs * sn1 + sn * cs1;
            cs = csr; sn = snr;
          }
        } else {
          b = -c; c = 0.0;
          double t = cs; cs = -sn; sn = t;
        }
      }
    }
  }
  w1r = a; w2r = d;
  if (c == 0.0) {
    w1i = 0.0; w2i = 0.0;
  } else {
    w1i = sqrt(fabs(b)) * sqrt(fabs(c));
    w2i = -w1i;
  }
}

// Givens rotation zeroing y against x: c x + s y = r.
inline void givens(double x, double y, double& c, double& s) {
  if (y == 0.0) { c = 1.0; s = 0.0; return; }
  double r = std::hypot(x, y);
  c = x / r;
  s = y / r;
}

// ---------------------------------------------------------------------------
// Periodic Hessenberg reduction (column sweep), Q accumulated.
// Convention: Q[l]^T A[l] Q[(l+1)%p] = H[l], H[0] Hessenberg, H[1:] upper tri.
void phessenberg(int p, int n, double* A, double* Q, int want_q) {
  std::vector<double> w(n), x(n);
  if (want_q) {
    for (int f = 0; f < p; ++f) {
      double* Qf = mat(Q, f, n);
      std::memset(Qf, 0, sizeof(double) * n * n);
      for (int r = 0; r < n; ++r) Qf[(size_t)r * n + r] = 1.0;
    }
  }
  for (int i = 0; i < n - 1; ++i) {
    // factors p-1 .. 1: triangularize column i (annihilate rows i+1..)
    for (int f = p - 1; f >= 1; --f) {
      double* Af = mat(A, f, n);
      int q = n - i;
      for (int t = 0; t < q; ++t) x[t] = Af[(size_t)(i + t) * n + i];
      double tau, beta;
      larfg(q, x.data(), w.data(), tau, beta);
      refl_left(Af, n, i, q, i, n, w.data(), tau);
      // exact column image
      Af[(size_t)i * n + i] = beta;
      for (int t = 1; t < q; ++t) Af[(size_t)(i + t) * n + i] = 0.0;
      refl_right(mat(A, f - 1, n), n, i, q, 0, n, w.data(), tau);
      if (want_q) refl_right(mat(Q, f, n), n, i, q, 0, n, w.data(), tau);
    }
    // factor 0: Hessenberg column i (annihilate rows i+2..)
    if (i + 2 < n) {
      double* A0 = mat(A, 0, n);
      int q = n - i - 1;
      for (int t = 0; t < q; ++t) x[t] = A0[(size_t)(i + 1 + t) * n + i];
      double tau, beta;
      larfg(q, x.data(), w.data(), tau, beta);
      refl_left(A0, n, i + 1, q, i, n, w.data(), tau);
      A0[(size_t)(i + 1) * n + i] = beta;
      for (int t = 1; t < q; ++t) A0[(size_t)(i + 1 + t) * n + i] = 0.0;
      int fr = (p > 1) ? p - 1 : 0;
      refl_right(mat(A, fr, n), n, i + 1, q, 0, n, w.data(), tau);
      if (want_q) refl_right(mat(Q, 0, n), n, i + 1, q, 0, n, w.data(), tau);
    }
  }
  // scrub structural zeros
  for (int f = 1; f < p; ++f) {
    double* Af = mat(A, f, n);
    for (int r = 1; r < n; ++r)
      for (int c = 0; c < r; ++c) Af[(size_t)r * n + c] = 0.0;
  }
  double* A0 = mat(A, 0, n);
  for (int r = 2; r < n; ++r)
    for (int c = 0; c < r - 1; ++c) A0[(size_t)r * n + c] = 0.0;
}

// ---------------------------------------------------------------------------
// Band entries of the product  ℍ = H[0] H[1] ... H[p-1]  over rows [l, i]:
// hdiag[r] = ℍ[r,r], hsub[r] = ℍ[r,r-1], hsup[r] = ℍ[r,r+1]
// (same recurrence as ops/pqr_real._band_products; reference :477-528).
void band_products(int p, int n, const double* H, int l, int i,
                   double* hdiag, double* hsub, double* hsup,
                   std::vector<double>& P1, std::vector<double>& P2,
                   std::vector<double>& P3) {
  int lo = std::max(l - 1, 0), hi = std::min(i + 2, n - 1);
  P1.assign(n, 1.0);
  P2.assign(n, 0.0);
  P3.assign(n, 0.0);
  for (int f = 1; f < p; ++f) {
    const double* Hf = mat(const_cast<double*>(H), f, n);
    for (int r = lo; r <= hi; ++r) {
      double D = Hf[(size_t)r * n + r];
      double U = (r + 1 < n) ? Hf[(size_t)r * n + r + 1] : 0.0;
      double V = (r + 2 < n) ? Hf[(size_t)r * n + r + 2] : 0.0;
      double D1 = (r + 1 < n) ? Hf[(size_t)(r + 1) * n + r + 1] : 0.0;
      double U1 = (r + 2 < n) ? Hf[(size_t)(r + 1) * n + r + 2] : 0.0;
      double D2 = (r + 2 < n) ? Hf[(size_t)(r + 2) * n + r + 2] : 0.0;
      P3[r] = P1[r] * V + P2[r] * U1 + P3[r] * D2;
      P2[r] = P1[r] * U + P2[r] * D1;
      P1[r] = P1[r] * D;
    }
  }
  const double* H0 = H;
  for (int r = lo; r <= hi; ++r) {
    double d0 = H0[(size_t)r * n + r];
    double u0 = (r + 1 < n) ? H0[(size_t)r * n + r + 1] : 0.0;
    double s0 = (r >= 1) ? H0[(size_t)r * n + r - 1] : 0.0;
    double P1m = (r >= 1) ? P1[r - 1] : 1.0;
    double P2m = (r >= 1) ? P2[r - 1] : 0.0;
    double P3m = (r >= 1) ? P3[r - 1] : 0.0;
    hsub[r] = s0 * P1m;
    hdiag[r] = s0 * P2m + d0 * P1[r];
    hsup[r] = s0 * P3m + d0 * P2[r] + (r + 1 < n ? u0 * P1[r + 1] : 0.0);
  }
}

// ---------------------------------------------------------------------------
// Real periodic QR iteration on (H, Z); returns 0 on convergence.
int pqr_real(int p, int n, double* H, double* Z, double* wr, double* wi,
             int maxitfac, int want_z) {
  const double ulp = 2.220446049250313e-16;
  const double unfl = 2.2250738585072014e-308;
  const double smlnum = unfl * (n / ulp);
  const double ulpx = pow(ulp, 1.0 + 4.0 / 16.0);  // Ahues-Tisseur tightened
  const double dat1 = 0.75, dat2 = -0.4375;
  const int maxit = maxitfac * n;

  if (n == 1) {
    double lam = 1.0;
    for (int f = 0; f < p; ++f) lam *= H[f];
    wr[0] = lam;
    wi[0] = 0.0;
    return 0;
  }

  // deflation thresholds for triangular diagonals (reference :379-388)
  std::vector<double> hnorms(p);
  for (int f = 0; f < p; ++f) {
    double mx = 0.0;
    const double* Hf = mat(H, f, n);
    for (int c = 0; c < n; ++c) {
      double s = 0.0;
      for (int r = 0; r < n; ++r) s += fabs(Hf[(size_t)r * n + c]);
      mx = std::max(mx, s);
    }
    hnorms[f] = ulp * n * mx;
  }

  std::vector<double> hdiag(n), hsub(n), hsup(n), P1, P2, P3;
  double w3[3], G3[9], G2[4], x3[3];

  int i = n - 1, l = 0, its = 1, jiter = 0;
  while (i >= 0) {
    if (jiter++ >= maxit) return 1;
    band_products(p, n, H, l, i, hdiag.data(), hsub.data(), hsup.data(),
                  P1, P2, P3);

    // ---- deflation scan: bottom-most negligible ℍ[k, k-1], k in [l+1, i]
    int lnew = l;
    if (i > l) {
      for (int k = i; k >= l + 1; --k) {
        double hh11 = hdiag[k - 1], hh12 = hsup[k - 1];
        double hh21 = hsub[k], hh22 = hdiag[k];
        double tst1 = fabs(hh11) + fabs(hh22);
        if (fabs(hh21) <= smlnum) { lnew = k; break; }
        if (fabs(hh21) <= ulp * tst1) {
          double ab = std::max(fabs(hh21), fabs(hh12));
          double ba = std::min(fabs(hh21), fabs(hh12));
          double aa = std::max(fabs(hh22), fabs(hh11 - hh22));
          double bb = std::min(fabs(hh22), fabs(hh11 - hh22));
          double s = aa + ab;
          if (ba * (ab / s) <= std::max(smlnum, ulpx * (bb * (aa / s)))) {
            lnew = k;
            break;
          }
        }
      }
    } else {
      lnew = i;
    }

    // ---- subdiagonal repair (reference :589-665): ℍ[lnew, lnew-1] is
    // negligible but H0's subdiagonal entry is not -> RQ-type chain.
    if (lnew > 0 && p > 1) {
      double* H0 = mat(H, 0, n);
      double t1r = fabs(H0[(size_t)(lnew - 1) * n + lnew - 1]) +
                   fabs(H0[(size_t)lnew * n + lnew]);
      if (fabs(H0[(size_t)lnew * n + lnew - 1]) >
          std::max(ulp * t1r, smlnum)) {
        for (int k = i; k >= lnew; --k) {
          for (int f = 0; f < p - 1; ++f) {
            double* Hf = mat(H, f, n);
            double x0 = Hf[(size_t)k * n + k];
            double x1 = Hf[(size_t)k * n + k - 1];
            double xv[2] = {x0, x1};
            double w2v[2], tau, beta;
            larfg(2, xv, w2v, tau, beta);
            double wv[2] = {w2v[1], 1.0};
            // columns (k-1, k), rows [0, k): right-reflector on the pair
            double M2[4] = {1.0 - tau * wv[0] * wv[0], -tau * wv[0] * wv[1],
                            -tau * wv[1] * wv[0], 1.0 - tau * wv[1] * wv[1]};
            Hf[(size_t)k * n + k - 1] = 0.0;
            Hf[(size_t)k * n + k] = beta;
            mat_right(Hf, n, k - 1, 2, 0, k, M2);
            mat_left(mat(H, f + 1, n), n, k - 1, 2, k - 1, n, M2);
            if (want_z) mat_right(mat(Z, f + 1, n), n, k - 1, 2, 0, n, M2);
          }
          if (k < i) {
            double* Hl = mat(H, p - 1, n);
            double x0 = Hl[(size_t)(k + 1) * n + k + 1];
            double x1 = Hl[(size_t)(k + 1) * n + k];
            double xv[2] = {x0, x1};
            double w2v[2], tau, beta;
            larfg(2, xv, w2v, tau, beta);
            double wv[2] = {w2v[1], 1.0};
            double M2[4] = {1.0 - tau * wv[0] * wv[0], -tau * wv[0] * wv[1],
                            -tau * wv[1] * wv[0], 1.0 - tau * wv[1] * wv[1]};
            Hl[(size_t)(k + 1) * n + k] = 0.0;
            Hl[(size_t)(k + 1) * n + k + 1] = beta;
            mat_right(Hl, n, k, 2, 0, k + 1, M2);
            mat_left(mat(H, 0, n), n, k, 2, k, n, M2);
            if (want_z) mat_right(mat(Z, 0, n), n, k, 2, 0, n, M2);
          }
        }
        mat(H, p - 1, n)[(size_t)lnew * n + lnew - 1] = 0.0;
      }
    }
    if (lnew > 0) mat(H, 0, n)[(size_t)lnew * n + lnew - 1] = 0.0;

    if (lnew >= i - 1) {
      // ======================= deflate 1 or 2 ==========================
      if (lnew == i) {
        wr[i] = hdiag[i];
        wi[i] = 0.0;
      } else {
        // explicit 2x2 product block
        double hp11 = 1.0, hp12 = 0.0, hp22 = 1.0;
        for (int f = 1; f < p; ++f) {
          const double* Hf = mat(H, f, n);
          double d1 = Hf[(size_t)(i - 1) * n + i - 1];
          double d2 = Hf[(size_t)i * n + i];
          double u = Hf[(size_t)(i - 1) * n + i];
          hp12 = hp11 * u + hp12 * d2;
          hp11 *= d1;
          hp22 *= d2;
        }
        double* H0 = mat(H, 0, n);
        double a11 = H0[(size_t)(i - 1) * n + i - 1];
        double a12 = H0[(size_t)(i - 1) * n + i];
        double a21 = H0[(size_t)i * n + i - 1];
        double a22 = H0[(size_t)i * n + i];
        double bh11 = a11 * hp11, bh12 = a11 * hp12 + a12 * hp22;
        double bh21 = a21 * hp11, bh22 = a21 * hp12 + a22 * hp22;
        double aa = bh11, bb = bh12, cc = bh21, dd = bh22, cs0, sn0;
        double w1r, w1i, w2r, w2i;
        lanv2(aa, bb, cc, dd, cs0, sn0, w1r, w1i, w2r, w2i);
        bool lam_real = (cc == 0.0);
        wr[i - 1] = w1r; wi[i - 1] = w1i;
        wr[i] = w2r; wi[i] = w2i;

        // negligible-diagonal detection in the triangular factors
        int jmin = -1, jmax = -1;
        for (int f = 1; f < p; ++f) {
          const double* Hf = mat(H, f, n);
          if (fabs(Hf[(size_t)(i - 1) * n + i - 1]) <= hnorms[f] && jmin < 0)
            jmin = f;
          if (fabs(Hf[(size_t)i * n + i]) <= hnorms[f]) jmax = f;
        }
        if (jmin >= 0 && jmax >= 0) {
          if (jmin <= p - jmax) jmax = -1; else jmin = -1;
        }

        if (jmin >= 1) {
          // chain A (reference :959-977)
          for (int f = 0; f <= jmin - 2; ++f) {
            double* Hf = mat(H, f, n);
            double xv[2] = {Hf[(size_t)i * n + i], Hf[(size_t)i * n + i - 1]};
            double w2v[2], tau, beta;
            larfg(2, xv, w2v, tau, beta);
            double wv[2] = {w2v[1], 1.0};
            double M2[4] = {1.0 - tau * wv[0] * wv[0], -tau * wv[0] * wv[1],
                            -tau * wv[1] * wv[0], 1.0 - tau * wv[1] * wv[1]};
            Hf[(size_t)i * n + i - 1] = 0.0;
            Hf[(size_t)i * n + i] = beta;
            mat_right(Hf, n, i - 1, 2, 0, i, M2);
            mat_left(mat(H, f + 1, n), n, i - 1, 2, i - 1, n, M2);
            if (want_z) mat_right(mat(Z, f + 1, n), n, i - 1, 2, 0, n, M2);
          }
        } else {
          // chain B: rotation + retriangularization (<=20 iterations)
          double aA1 = std::hypot(w1r, w1i), aA2 = std::hypot(w2r, w2i);
          double amx = std::max(aA1, aA2), amn = std::min(aA1, aA2);
          bool prod0 = (w1r == 0 && w1i == 0) || (w2r == 0 && w2i == 0);
          bool replaceG = ((jmax >= 1) && lam_real) || prod0 ||
                          (!prod0 && lam_real && amn < ulp * amx);
          for (int t = 0; t < 20; ++t) {
            double c, s;
            if (replaceG) {
              givens(H0[(size_t)(i - 1) * n + i - 1],
                     H0[(size_t)i * n + i - 1], c, s);
            } else {
              c = cs0; s = sn0;
            }
            // rows (i-1, i) of H0 from the left by [[c, s], [-s, c]]
            double L2[4] = {c, s, -s, c};
            mat_left(H0, n, i - 1, 2, i - 1, n, L2);
            // cols (i-1, i) of H[p-1] (or H0 if p == 1) by the adjoint
            double R2[4] = {c, -s, s, c};
            mat_right(mat(H, p > 1 ? p - 1 : 0, n), n, i - 1, 2, 0, i + 1, R2);
            if (want_z) mat_right(mat(Z, 0, n), n, i - 1, 2, 0, n, R2);
            for (int f = p - 1; f >= 1; --f) {
              if (f < jmax + 1) continue;
              double* Hf = mat(H, f, n);
              double xv[2] = {Hf[(size_t)(i - 1) * n + i - 1],
                              Hf[(size_t)i * n + i - 1]};
              double w2v[2], tau, beta;
              larfg(2, xv, w2v, tau, beta);
              refl_to_mat(2, w2v, tau, G2);
              Hf[(size_t)(i - 1) * n + i - 1] = beta;
              Hf[(size_t)i * n + i - 1] = 0.0;
              mat_left(Hf, n, i - 1, 2, i, n, G2);
              mat_right(mat(H, f - 1, n), n, i - 1, 2, 0, i + 1, G2);
              if (want_z) mat_right(mat(Z, f, n), n, i - 1, 2, 0, n, G2);
            }
            double sub = fabs(H0[(size_t)i * n + i - 1]);
            if (!replaceG || sub < std::max(smlnum, ulp * amx)) break;
            replaceG = true;
          }
          if (jmax >= 0 || bh21 == 0.0) H0[(size_t)i * n + i - 1] = 0.0;
          if (jmax >= 1) mat(H, jmax, n)[(size_t)i * n + i - 1] = 0.0;
        }

        // eigenvalue-order check after replacement rotations
        double l1 = mat(H, 0, n)[(size_t)(i - 1) * n + i - 1];
        double l2v = mat(H, 0, n)[(size_t)i * n + i];
        for (int f = 1; f < p; ++f) {
          l1 *= mat(H, f, n)[(size_t)(i - 1) * n + i - 1];
          l2v *= mat(H, f, n)[(size_t)i * n + i];
        }
        if (lam_real && fabs(l1 - w1r) > fabs(l1 - w2r)) {
          std::swap(wr[i - 1], wr[i]);
        }
      }
      i = lnew - 1;
      l = 0;
      its = 1;
      continue;
    }

    // ========================= bulge chase =============================
    l = lnew;
    bool exc1 = (its == 10);
    bool exc2 = (its % 10 == 0) && !exc1;
    bool exc = exc1 || exc2;
    double rt1r, rt1i, rt2r, rt2i;
    double h44E = 0, h33E = 0, h43h34E = 0;
    if (exc) {
      double sE = exc1 ? fabs(hsub[std::min(l + 1, n - 1)]) +
                             fabs(hsub[std::min(l + 2, n - 1)])
                       : fabs(hsub[i]) + fabs(hsub[i - 1]);
      h44E = dat1 * sE + (exc1 ? hdiag[l] : hdiag[i]);
      h33E = h44E;
      h43h34E = dat2 * sE * sE;
    }
    {
      double h44 = hdiag[i], h33 = hdiag[i - 1];
      double h43 = hsub[i], h34 = hsup[i - 1];
      double ssh = fabs(h33) + fabs(h34) + fabs(h43) + fabs(h44);
      if (ssh == 0.0) {
        rt1r = rt1i = rt2r = rt2i = 0.0;
      } else {
        double h33n = h33 / ssh, h44n = h44 / ssh;
        double h34n = h34 / ssh, h43n = h43 / ssh;
        double trc = (h33n + h44n) * 0.5;
        double disc = (h33n - trc) * (h44n - trc) - h34n * h43n;
        double rtdisc = sqrt(fabs(disc));
        if (disc >= 0) {
          rt1r = trc * ssh;
          rt1i = rtdisc * ssh;
          rt2r = rt1r;
          rt2i = -rt1i;
        } else {
          double r1 = trc + rtdisc, r2 = trc - rtdisc;
          double pick = (fabs(r1 - h44n) <= fabs(r2 - h44n)) ? r1 : r2;
          rt1r = rt2r = pick * ssh;
          rt1i = rt2i = 0.0;
        }
      }
    }
    int m = l;
    double v0[3];
    {
      double h11 = hdiag[m], h12 = hsup[m];
      double h21 = hsub[std::min(m + 1, n - 1)];
      double h22 = hdiag[std::min(m + 1, n - 1)];
      double hsub_m2 = hsub[std::min(m + 2, n - 1)];
      double v1, v2, v3;
      if (exc) {
        double h44s = h44E - h11, h33s = h33E - h11;
        double h21s = (h21 == 0.0) ? 1.0 : h21;
        v1 = (h33s * h44s - h43h34E) / h21s + h12;
        v2 = h22 - h11 - h33s - h44s;
        v3 = hsub_m2;
      } else {
        double sv = fabs(h11 - rt2r) + fabs(rt2i) + fabs(h21);
        if (sv == 0.0) sv = 1.0;
        double h21s = h21 / sv;
        v1 = h21s * h12 + (h11 - rt1r) * ((h11 - rt2r) / sv) -
             rt1i * (rt2i / sv);
        v2 = h21s * (h11 + h22 - rt1r - rt2r);
        v3 = h21s * hsub_m2;
      }
      double snorm = fabs(v1) + fabs(v2) + fabs(v3);
      if (snorm == 0.0) snorm = 1.0;
      v0[0] = v1 / snorm;
      v0[1] = v2 / snorm;
      v0[2] = v3 / snorm;
    }

    for (int k = m; k <= i - 1; ++k) {
      int nr = std::min(3, i - k + 1);
      int hi_r = std::min(k + 3, i) + 1;
      double* H0 = mat(H, 0, n);
      if (k > m) {
        for (int t = 0; t < nr; ++t) x3[t] = H0[(size_t)(k + t) * n + k - 1];
      } else {
        for (int t = 0; t < nr; ++t) x3[t] = v0[t];
      }
      double tau, beta;
      larfg(nr, x3, w3, tau, beta);
      refl_to_mat(nr, w3, tau, G3);
      if (k > m) {
        H0[(size_t)k * n + k - 1] = beta;
        for (int t = 1; t < nr; ++t) H0[(size_t)(k + t) * n + k - 1] = 0.0;
      }
      mat_left(H0, n, k, nr, k, n, G3);
      mat_right(mat(H, p > 1 ? p - 1 : 0, n), n, k, nr, 0, hi_r, G3);
      if (want_z) mat_right(mat(Z, 0, n), n, k, nr, 0, n, G3);
      for (int f = p - 1; f >= 1; --f) {
        double* Hf = mat(H, f, n);
        for (int t = 0; t < nr; ++t) x3[t] = Hf[(size_t)(k + t) * n + k];
        larfg(nr, x3, w3, tau, beta);
        refl_to_mat(nr, w3, tau, G3);
        Hf[(size_t)k * n + k] = beta;
        for (int t = 1; t < nr; ++t) Hf[(size_t)(k + t) * n + k] = 0.0;
        mat_left(Hf, n, k, nr, k + 1, n, G3);
        mat_right(mat(H, f - 1, n), n, k, nr, 0, hi_r, G3);
        if (want_z) mat_right(mat(Z, f, n), n, k, nr, 0, n, G3);
        if (nr == 3) {
          // second (2-element) re-triangularization
          double xv[2] = {Hf[(size_t)(k + 1) * n + k + 1],
                          Hf[(size_t)(k + 2) * n + k + 1]};
          double w2v[2], tau2, beta2;
          larfg(2, xv, w2v, tau2, beta2);
          refl_to_mat(2, w2v, tau2, G2);
          Hf[(size_t)(k + 1) * n + k + 1] = beta2;
          Hf[(size_t)(k + 2) * n + k + 1] = 0.0;
          mat_left(Hf, n, k + 1, 2, k + 2, n, G2);
          mat_right(mat(H, f - 1, n), n, k + 1, 2, 0, hi_r, G2);
          if (want_z) mat_right(mat(Z, f, n), n, k + 1, 2, 0, n, G2);
        }
      }
    }
    its += 1;
  }

  // scrub: subdiagonals of real eigenvalues, triangular lower parts
  double* H0 = mat(H, 0, n);
  for (int r = 1; r < n; ++r)
    if (wi[r - 1] == 0.0) H0[(size_t)r * n + r - 1] = 0.0;
  for (int f = 1; f < p; ++f) {
    double* Hf = mat(H, f, n);
    for (int r = 1; r < n; ++r)
      for (int c = 0; c < r; ++c) Hf[(size_t)r * n + c] = 0.0;
  }
  return 0;
}

}  // namespace

// ===========================================================================
// Complex single-shift periodic QZ (MB03BZ shape) for NONSINGULAR windows.
//
// Independent C++ rewrite of the algorithm the JAX core
// ../periodicschurdecompositions_jax/ops/pqz_complex.py implements
// (reference behavior: /root/reference/src/generalized.jl:166-931) for the
// AED window analyses (ops/aed.py): input H[0] upper Hessenberg,
// H[1..p-1] upper triangular, signature S[l] in {+1,-1}, S[0] = +1.
// SCOPE: the common nonsingular fast path only — a negligible diagonal in
// any triangular factor (the deflate_pos/neg + controlled-zero-shift
// machinery) returns rc=2 and the caller falls back to the jitted exact
// core; non-convergence returns rc=1.  Eigenvalues in the decomposed
// (alpha, beta in {0,1} -- always 1 here, 2^scale) form.

#include <complex>

namespace pqzcx {

using cd = std::complex<double>;

inline cd* cmat(cd* H, int f, int n) { return H + (size_t)f * n * n; }

// Complex Givens with real c >= 0: [c s; -conj(s) c] [f; g] = [r; 0].
// g == 0 -> (1, 0, f); f == 0 -> (0, conj(g)/|g|, |g|).
inline void zgivens(cd f, cd g, double& c, cd& s, cd& r) {
  if (g == cd(0.0, 0.0)) { c = 1.0; s = cd(0.0, 0.0); r = f; return; }
  if (f == cd(0.0, 0.0)) {
    double ag = std::abs(g);
    c = 0.0; s = std::conj(g) / ag; r = cd(ag, 0.0); return;
  }
  double sc = std::max(std::max(fabs(f.real()), fabs(f.imag())),
                       std::max(fabs(g.real()), fabs(g.imag())));
  cd fs = f / sc, gs = g / sc;
  double d2 = std::norm(fs) + std::norm(gs);
  double d = sqrt(d2), af = std::abs(fs);
  c = af / d;
  cd fsign = fs / af;
  r = fsign * d * sc;
  s = fsign * std::conj(gs) / d;
}

// rows k, k+1 of Hf, columns [lo, hi): left rotation [c s; -conj(s) c]
inline void zrowrot(cd* Hf, int n, int k, double c, cd s, int lo, int hi) {
  cd* r0 = Hf + (size_t)k * n;
  cd* r1 = Hf + (size_t)(k + 1) * n;
  for (int j = lo; j < hi; ++j) {
    cd a = r0[j], b = r1[j];
    r0[j] = c * a + s * b;
    r1[j] = -std::conj(s) * a + c * b;
  }
}

// cols k, k+1 of Hf, rows [lo, hi): right multiply by rmat_adj(c, s) =
// [[c, -s], [conj(s), c]]  (new_c0 = c*c0 + conj(s)*c1; new_c1 = -s*c0 + c*c1)
inline void zcolrot(cd* Hf, int n, int k, double c, cd s, int lo, int hi) {
  for (int i = lo; i < hi; ++i) {
    cd* row = Hf + (size_t)i * n;
    cd a = row[k], b = row[k + 1];
    row[k] = c * a + std::conj(s) * b;
    row[k + 1] = -s * a + c * b;
  }
}

inline void renorm(cd& alpha, int& scale) {
  double mag = std::abs(alpha);
  if (mag == 0.0) { scale = 0; return; }
  int e;
  std::frexp(mag, &e);           // mag = m * 2^e, m in [0.5, 1)
  alpha = std::ldexp(1.0, 1 - e) * alpha;
  scale += e - 1;
}

// tiny deterministic PRNG for the exceptional shifts
inline double xrand(unsigned long long& st) {
  st ^= st << 13; st ^= st >> 7; st ^= st << 17;
  return (double)(st % 2000001) / 1000000.0 - 1.0;
}

int pqz_complex(int p, int n, cd* H, const int* S, cd* Z, cd* alpha,
                double* beta, int* scal, int maxitfac, int want_z) {
  const double ulp = 2.220446049250313e-16;
  const double unfl = 2.2250738585072014e-308;
  const double smlnum = unfl * ((double)n / ulp);
  const double safmin = unfl;
  const long maxit = (long)maxitfac * n;
  unsigned long long rng = 0x9E3779B97F4A7C15ull;

  int ilast = n - 1;
  long iiter = 0;
  for (long jiter = 0; jiter < maxit && ilast >= 0; ++jiter) {
    cd* H0 = cmat(H, 0, n);
    // ---- test 1: bottom-most negligible Hessenberg subdiagonal --------
    int jlo = 0;
    for (int j = ilast; j >= 1; --j) {
      double tol = std::max(ulp * (std::abs(H0[(size_t)(j - 1) * n + j - 1])
                                   + std::abs(H0[(size_t)j * n + j])),
                            smlnum);
      if (std::abs(H0[(size_t)j * n + j - 1]) <= tol) {
        H0[(size_t)j * n + j - 1] = cd(0.0, 0.0);
        jlo = j;
        break;                    // largest such j (scan from ilast down)
      }
    }
    if (ilast == 0 || jlo == ilast) {
      // ---- split a 1x1 at ilast (safeprod over the cycle diagonal) ----
      cd a(1.0, 0.0); double b = 1.0; int sc = 0;
      for (int l = 0; l < p; ++l) {
        cd d = cmat(H, l, n)[(size_t)ilast * n + ilast];
        if (S[l] > 0) a *= d;
        else {
          if (d == cd(0.0, 0.0)) { b = 0.0; }
          else a /= d;
        }
        renorm(a, sc);
      }
      alpha[ilast] = a; beta[ilast] = b; scal[ilast] = sc;
      --ilast; iiter = 0;
      continue;
    }
    // ---- tests 2/3: negligible triangular diagonal -> fall back -------
    for (int l = 1; l < p; ++l) {
      cd* Hl = cmat(H, l, n);
      for (int j = jlo; j <= ilast; ++j) {
        double t;
        if (j == ilast) t = std::abs(Hl[(size_t)(j - 1) * n + j]);
        else if (j == jlo) t = std::abs(Hl[(size_t)j * n + j + 1]);
        else t = std::abs(Hl[(size_t)(j - 1) * n + j])
               + std::abs(Hl[(size_t)j * n + j + 1]);
        if (std::abs(Hl[(size_t)j * n + j]) <= std::max(ulp * t, smlnum))
          return 2;               // singular-factor machinery: jitted path
      }
    }
    // ---- single-shift QZ sweep ---------------------------------------
    ++iiter;
    int ifirst = jlo;
    double c; cd s, r;
    if (iiter % 10 == 0) {        // exceptional: random rotation
      cd f(xrand(rng), xrand(rng)), g(xrand(rng), xrand(rng));
      zgivens(f, g, c, s, r);
    } else {
      zgivens(cd(1.0, 0.0), cd(1.0, 0.0), c, s, r);
      for (int l = p - 1; l >= 1; --l) {
        cd hf = cmat(H, l, n)[(size_t)ifirst * n + ifirst];
        cd hl = cmat(H, l, n)[(size_t)ilast * n + ilast];
        if (S[l] > 0) zgivens(hf * c, hl * std::conj(s), c, s, r);
        else { zgivens(hl * c, -hf * std::conj(s), c, s, r); s = -s; }
      }
      cd h0f = H0[(size_t)ifirst * n + ifirst];
      cd h0l = H0[(size_t)ilast * n + ilast];
      cd h0sub = H0[(size_t)(ifirst + 1) * n + ifirst];
      zgivens(h0f * c - h0l * std::conj(s), h0sub * c, c, s, r);
    }
    for (int k = ifirst; k <= ilast - 1; ++k) {
      if (k > ifirst) {
        cd f = H0[(size_t)k * n + k - 1];
        cd g = H0[(size_t)(k + 1) * n + k - 1];
        zgivens(f, g, c, s, r);
        H0[(size_t)k * n + k - 1] = r;
        H0[(size_t)(k + 1) * n + k - 1] = cd(0.0, 0.0);
      }
      zrowrot(H0, n, k, c, s, k, n);
      if (want_z) zcolrot(cmat(Z, 0, n), n, k, c, s, 0, n);
      for (int l = p - 1; l >= 1; --l) {
        cd* Hl = cmat(H, l, n);
        if (S[l] > 0) {
          zcolrot(Hl, n, k, c, s, 0, k + 2);
          cd f = Hl[(size_t)k * n + k], g = Hl[(size_t)(k + 1) * n + k];
          double cn; cd sn;
          zgivens(f, g, cn, sn, r);
          Hl[(size_t)k * n + k] = r;
          Hl[(size_t)(k + 1) * n + k] = cd(0.0, 0.0);
          zrowrot(Hl, n, k, cn, sn, k + 1, n);
          c = cn; s = sn;
        } else {
          zrowrot(Hl, n, k, c, s, k, n);
          // annihilate Hl[k+1][k] from the RIGHT: rotation from the row
          // pair (Hl[k+1][k+1], Hl[k+1][k]) -- python: givens(row[k+1],
          // row[k]); then columns (k, k+1) get lmat(cn, sn); sn = -sn
          cd f = Hl[(size_t)(k + 1) * n + k + 1];
          cd g = Hl[(size_t)(k + 1) * n + k];
          double cn; cd sn;
          zgivens(f, g, cn, sn, r);
          Hl[(size_t)(k + 1) * n + k + 1] = r;
          Hl[(size_t)(k + 1) * n + k] = cd(0.0, 0.0);
          // columns (k, k+1), rows [0, k+1): right-multiply by
          // lmat(cn, sn) = [[cn, sn], [-conj(sn), cn]]:
          // new_c0 = cn*c0 - conj(sn)*c1 ; new_c1 = sn*c0 + cn*c1
          for (int i = 0; i < k + 1; ++i) {
            cd* row = Hl + (size_t)i * n;
            cd a = row[k], bb = row[k + 1];
            row[k] = cn * a - std::conj(sn) * bb;
            row[k + 1] = sn * a + cn * bb;
          }
          c = cn; s = -sn;
        }
        if (want_z) zcolrot(cmat(Z, l, n), n, k, c, s, 0, n);
      }
      int hi = std::min(k + 3, n);
      zcolrot(H0, n, k, c, s, 0, hi);
    }
  }
  if (ilast >= 0) return 1;       // budget exhausted

  // ---- postprocess: real-nonnegative triangular diagonals ------------
  for (int l = p - 1; l >= 1; --l) {
    cd* Hl = cmat(H, l, n);
    cd* Hm = cmat(H, l - 1, n);
    for (int j = 0; j < n; ++j) {
      cd d = Hl[(size_t)j * n + j];
      double ad = std::abs(d);
      if (ad <= safmin) continue;
      cd z = std::conj(d) / ad;
      if (S[l] > 0) {             // scale row j of Hl by z
        for (int col = 0; col < n; ++col) Hl[(size_t)j * n + col] *= z;
      } else {                    // scale col j of Hl by z
        for (int row = 0; row < n; ++row) Hl[(size_t)row * n + j] *= z;
      }
      Hl[(size_t)j * n + j] = cd(ad, 0.0);
      cd sf = (S[l] > 0) ? z : std::conj(z);
      if (want_z) {               // Z[l] col j *= conj(sf)
        cd* Zl = cmat(Z, l, n);
        for (int row = 0; row < n; ++row)
          Zl[(size_t)row * n + j] *= std::conj(sf);
      }
      if (S[l - 1] > 0) {         // neighbor: col j *= conj(sf)
        for (int row = 0; row < n; ++row)
          Hm[(size_t)row * n + j] *= std::conj(sf);
      } else {                    // neighbor: row j *= sf
        for (int col = 0; col < n; ++col)
          Hm[(size_t)j * n + col] *= sf;
      }
    }
  }
  return 0;
}

}  // namespace pqzcx

// ===========================================================================
// Real generalized periodic QZ (MB03BD scope) for NONSINGULAR windows.
//
// Independent C++ rewrite of the algorithm the JAX core
// ../periodicschurdecompositions_jax/ops/pqz_real.py implements
// (reference behavior: /root/reference/src/rgeneralized.jl:49-1083) for the
// AED window analyses (ops/aed.py real-generalized variant): input H[0]
// upper Hessenberg, H[1..p-1] upper triangular, signature S[l] in {+1,-1},
// S[0] = +1, p >= 2.  Same re-designed shift scheme as the JAX core: exact
// trailing-2x2 window-product Wilkinson shifts + exact leading-3x3 opening
// vector, random exceptional rotations every 10 sweeps, trailing 2x2 attack
// via the real single-shift 2x2 periodic QZ (MB03BF semantics).
// SCOPE: nonsingular fast path only — a negligible triangular diagonal
// (deflate_pos/neg + controlled-zero-shift machinery) returns rc=2 and the
// caller falls back to the jitted exact core; non-convergence returns rc=1.
// Eigenvalues in the decomposed (alpha_r + i alpha_i, beta in {0,1},
// 2^scale) form with standardized conjugate pairs.

namespace pqzrg {

using std::fabs;
using std::sqrt;

inline double* rmat_(double* H, int f, int n) { return H + (size_t)f * n * n; }

// givens_real semantics (ops/rotations.py:62-84): [c s; -s c][f; g] = [r, 0]
// with c >= 0; g == 0 -> (1, 0, f); f == 0 -> (0, sign(g), |g|).
inline void givensr(double f, double g, double& c, double& s, double& r) {
  if (g == 0.0) { c = 1.0; s = 0.0; r = f; return; }
  if (f == 0.0) { c = 0.0; s = (g >= 0.0) ? 1.0 : -1.0; r = fabs(g); return; }
  double scale = std::max(fabs(f), fabs(g));
  double fs = f / scale, gs = g / scale;
  double d = scale * sqrt(fs * fs + gs * gs);
  r = (f >= 0.0) ? d : -d;
  c = fabs(f) / d;
  s = g / r;
}

// rows (i, i+1) of M, columns [lo, hi): left-multiply by lmat(c, s) =
// [[c, s], [-s, c]].
inline void rot_rows(double* M, int n, int i, double c, double s,
                     int lo, int hi) {
  double* r0 = M + (size_t)i * n;
  double* r1 = M + (size_t)(i + 1) * n;
  for (int j = lo; j < hi; ++j) {
    double a = r0[j], b = r1[j];
    r0[j] = c * a + s * b;
    r1[j] = -s * a + c * b;
  }
}

// cols (j, j+1) of M, rows [lo, hi): right-multiply by rmat_adj(c, s) =
// [[c, -s], [s, c]].
inline void rot_cols(double* M, int n, int j, double c, double s,
                     int lo, int hi) {
  for (int i = lo; i < hi; ++i) {
    double* row = M + (size_t)i * n;
    double a = row[j], b = row[j + 1];
    row[j] = c * a + s * b;
    row[j + 1] = -s * a + c * b;
  }
}

inline void renorm_sc(double* P, int m, int& e) {
  double mx = 0.0;
  for (int t = 0; t < m; ++t) mx = std::max(mx, fabs(P[t]));
  if (mx == 0.0) return;
  int ee;
  std::frexp(mx, &ee);
  double f = std::ldexp(1.0, 1 - ee);
  for (int t = 0; t < m; ++t) P[t] *= f;
  e += ee - 1;
}

inline double xrand(unsigned long long& st) {
  st ^= st << 13; st ^= st >> 7; st ^= st << 17;
  return (double)(st % 2000001) / 1000000.0 - 1.0;
}

// lanv2 lives in the anonymous namespace above; re-declare a local copy to
// keep this namespace self-contained (identical dlanv2 contract).
void lanv2rg(double& a, double& b, double& c, double& d, double& cs,
             double& sn, double& w1r, double& w1i, double& w2r, double& w2i) {
  const double eps = 2.220446049250313e-16;
  if (c == 0.0) {
    cs = 1.0; sn = 0.0;
  } else if (b == 0.0) {
    cs = 0.0; sn = 1.0;
    double t = d; d = a; a = t;
    b = -c; c = 0.0;
  } else if ((a - d) == 0.0 && ((b < 0) != (c < 0))) {
    cs = 1.0; sn = 0.0;
  } else {
    double temp = a - d;
    double pp = 0.5 * temp;
    double bcmax = std::max(fabs(b), fabs(c));
    double bcmis = std::min(fabs(b), fabs(c)) *
                   (b >= 0 ? 1.0 : -1.0) * (c >= 0 ? 1.0 : -1.0);
    double scale = std::max(fabs(pp), bcmax);
    double z = (pp / scale) * pp + (bcmax / scale) * bcmis;
    if (z >= 4.0 * eps) {
      double zz = pp + copysign(sqrt(scale) * sqrt(z), pp);
      a = d + zz;
      d -= (bcmax / zz) * bcmis;
      double tau = std::hypot(c, zz);
      cs = zz / tau;
      sn = c / tau;
      b -= c;
      c = 0.0;
    } else {
      double sigma = b + c;
      double tau = std::hypot(sigma, temp);
      cs = sqrt(0.5 * (1.0 + fabs(sigma) / tau));
      sn = -(pp / (tau * cs)) * (sigma >= 0 ? 1.0 : -1.0);
      double aa = a * cs + b * sn, bb = -a * sn + b * cs;
      double cc = c * cs + d * sn, dd = -c * sn + d * cs;
      a = aa * cs + cc * sn;
      b = bb * cs + dd * sn;
      c = -aa * sn + cc * cs;
      d = -bb * sn + dd * cs;
      double mid = 0.5 * (a + d);
      a = mid; d = mid;
      if (c != 0.0) {
        if (b != 0.0) {
          if ((b < 0) == (c < 0)) {
            double sab = sqrt(fabs(b)), sac = sqrt(fabs(c));
            double p2 = copysign(sab * sac, c);
            double t2 = 1.0 / sqrt(fabs(b + c));
            a = mid + p2; d = mid - p2;
            b -= c; c = 0.0;
            double cs1 = sab * t2, sn1 = sac * t2;
            double csr = cs * cs1 - sn * sn1, snr = cs * sn1 + sn * cs1;
            cs = csr; sn = snr;
          }
        } else {
          b = -c; c = 0.0;
          double t = cs; cs = -sn; sn = t;
        }
      }
    }
  }
  w1r = a; w2r = d;
  if (c == 0.0) {
    w1i = 0.0; w2i = 0.0;
  } else {
    w1i = sqrt(fabs(b)) * sqrt(fabs(c));
    w2i = -w1i;
  }
}

// --------------------------------------------------------------------------
// 2x2 cycle machinery (mirrors ops/pqz_real.py:57-193)

// Opening rotation for the single-shift 2x2 periodic QZ sweep; B is p 2x2
// blocks with the Hessenberg block LAST (row-major 4 doubles each).
void qzrot2x2(int p, const double* B, const int* S2, double& c_out,
              double& s_out) {
  const double* Hl = B + (size_t)(p - 1) * 4;
  double c1, s1, r, c2, s2, rr;
  givensr(Hl[0], Hl[2], c1, s1, r);
  givensr(r, 1.0, c2, s2, rr);
  for (int l = p - 2; l >= 0; --l) {
    Hl = B + (size_t)l * 4;
    if (S2[l] > 0) {
      double al = c2 * (c1 * Hl[0] + s1 * Hl[1]);
      double be = s1 * c2 * Hl[3];
      double ga = s2 * Hl[3];
      givensr(al, be, c1, s1, r);
      givensr(r, ga, c2, s2, rr);
    } else {
      double al = c1 * s2 * Hl[0];
      double ga = s1 * Hl[0];
      double be = s2 * (c1 * Hl[1] + s1 * Hl[3]);
      double de = c1 * Hl[3] - s1 * Hl[1];
      givensr(de, ga, c1, s1, rr);
      al = c1 * al + s1 * be;
      be = c2 * Hl[3];
      givensr(be, al, c2, s2, r);
    }
  }
  Hl = B + (size_t)(p - 1) * 4;
  double al = s2 * Hl[3] - c1 * c2;
  double be = -s1 * c2;
  givensr(al, be, c1, s1, rr);
  c_out = c1; s_out = s1;
}

// Real single-shift 2x2 periodic QZ (MB03BF semantics); returns true when
// the Hessenberg block's subdiagonal became negligible (two real eigvals).
bool rp2x2ssr(int p, double* B, const int* S2, int maxit) {
  const double ulp = 2.220446049250313e-16;
  for (int t = 0; t < maxit; ++t) {
    double* Hp = B + (size_t)(p - 1) * 4;
    if (fabs(Hp[2]) < ulp * std::max(std::max(fabs(Hp[0]), fabs(Hp[1])),
                                     fabs(Hp[3])))
      return true;
    double c, s, r;
    qzrot2x2(p, B, S2, c, s);
    // B[p-1] = B[p-1] @ rmat_adj(c, s)
    {
      double a = Hp[0], b = Hp[1], cc = Hp[2], d = Hp[3];
      Hp[0] = c * a + s * b;  Hp[1] = -s * a + c * b;
      Hp[2] = c * cc + s * d; Hp[3] = -s * cc + c * d;
    }
    for (int l = 0; l < p - 1; ++l) {
      double* Hl = B + (size_t)l * 4;
      if (S2[l] > 0) {
        // Hl = lmat(c, s) @ Hl, then re-triangularize from the right
        double a = Hl[0], b = Hl[1], cc = Hl[2], d = Hl[3];
        Hl[0] = c * a + s * cc;  Hl[1] = c * b + s * d;
        Hl[2] = -s * a + c * cc; Hl[3] = -s * b + c * d;
        givensr(Hl[3], -Hl[2], c, s, r);
        double h00 = Hl[0], h01 = Hl[1];
        Hl[0] = c * h00 + s * h01;
        Hl[1] = c * h01 - s * h00;
        Hl[2] = 0.0;
        Hl[3] = r;
      } else {
        // Hl = Hl @ rmat_adj(c, s), then re-triangularize from the left
        double a = Hl[0], b = Hl[1], cc = Hl[2], d = Hl[3];
        Hl[0] = c * a + s * b;  Hl[1] = -s * a + c * b;
        Hl[2] = c * cc + s * d; Hl[3] = -s * cc + c * d;
        givensr(Hl[0], Hl[2], c, s, r);
        double h01 = Hl[1], h11 = Hl[3];
        Hl[0] = r;
        Hl[1] = c * h01 + s * h11;
        Hl[2] = 0.0;
        Hl[3] = c * h11 - s * h01;
      }
    }
    // B[p-1] = lmat(c, s) @ B[p-1]
    {
      double a = Hp[0], b = Hp[1], cc = Hp[2], d = Hp[3];
      Hp[0] = c * a + s * cc;  Hp[1] = c * b + s * d;
      Hp[2] = -s * a + c * cc; Hp[3] = -s * b + c * d;
    }
  }
  double* Hp = B + (size_t)(p - 1) * 4;
  return fabs(Hp[2]) < ulp * std::max(std::max(fabs(Hp[0]), fabs(Hp[1])),
                                      fabs(Hp[3]));
}

// Eigenvalues of the signed product of p 2x2 window blocks (scaled signed
// product standardized by dlanv2; mirrors ops/pqz_real.py:151-193).
void eig2x2_product(int p, const double* W, const int* S, double& w1r,
                    double& w1i, double& w2r, double& w2i, int& s1,
                    int& s2, double& beta) {
  double P[4] = {1.0, 0.0, 0.0, 1.0};
  int e = 0;
  beta = 1.0;
  for (int l = 0; l < p; ++l) {
    const double* Wl = W + (size_t)l * 4;
    double M[4];
    if (S[l] > 0) {
      // full block: the Hessenberg window (l == 0) carries its subdiagonal
      M[0] = Wl[0]; M[1] = Wl[1]; M[2] = Wl[2]; M[3] = Wl[3];
    } else {
      double a = Wl[0], b = Wl[1], d = Wl[3];
      if (a == 0.0 || d == 0.0) beta = 0.0;
      double as = (a == 0.0) ? 1.0 : a;
      double ds = (d == 0.0) ? 1.0 : d;
      M[0] = 1.0 / as; M[1] = -b / (as * ds); M[2] = 0.0; M[3] = 1.0 / ds;
    }
    double Q[4];
    Q[0] = P[0] * M[0] + P[1] * M[2];
    Q[1] = P[0] * M[1] + P[1] * M[3];
    Q[2] = P[2] * M[0] + P[3] * M[2];
    Q[3] = P[2] * M[1] + P[3] * M[3];
    std::memcpy(P, Q, sizeof(Q));
    renorm_sc(P, 4, e);
  }
  double a = P[0], b = P[1], c = P[2], d = P[3], cs, sn;
  lanv2rg(a, b, c, d, cs, sn, w1r, w1i, w2r, w2i);
  // norm_one: mantissa to [1, 2), per-eigenvalue scale
  auto norm_one = [&](double& wr, double& wi, int& sc) {
    double m = std::hypot(wr, wi);
    if (m == 0.0) { sc = 0; return; }
    int ee;
    std::frexp(m, &ee);
    double f = std::ldexp(1.0, 1 - ee);
    wr *= f; wi *= f;
    sc = ee - 1;
  };
  norm_one(w1r, w1i, s1);
  norm_one(w2r, w2i, s2);
  s1 += e;
  s2 += e;
}

// --------------------------------------------------------------------------
// shared single-rotation "510" chain (mirrors ops/pqz_real.py:367-388)
void chain510(int p, int n, double* H, const int* S, double* Z, int j,
              double c1, double s1, int want_z) {
  double r;
  double* H0 = rmat_(H, 0, n);
  rot_rows(H0, n, j, c1, s1, j, n);
  if (want_z) rot_cols(rmat_(Z, 0, n), n, j, c1, s1, 0, n);
  for (int l = p - 1; l >= 1; --l) {
    double* Hl = rmat_(H, l, n);
    if (S[l] > 0) {
      rot_cols(Hl, n, j, c1, s1, 0, j + 2);
      givensr(Hl[(size_t)j * n + j], Hl[(size_t)(j + 1) * n + j], c1, s1, r);
      Hl[(size_t)j * n + j] = r;
      Hl[(size_t)(j + 1) * n + j] = 0.0;
      rot_rows(Hl, n, j, c1, s1, j + 1, n);
    } else {
      rot_rows(Hl, n, j, c1, s1, j, n);
      givensr(Hl[(size_t)(j + 1) * n + j + 1],
              -Hl[(size_t)(j + 1) * n + j], c1, s1, r);
      Hl[(size_t)(j + 1) * n + j + 1] = r;
      Hl[(size_t)(j + 1) * n + j] = 0.0;
      rot_cols(Hl, n, j, c1, s1, 0, j + 1);
    }
    if (want_z) rot_cols(rmat_(Z, l, n), n, j, c1, s1, 0, n);
  }
  rot_cols(H0, n, j, c1, s1, 0, n);
}

// upper-triangular 3x3 inverse with guarded diagonals
// (mirrors ops/pqz_real.py:_tri3inv)
inline void tri3inv(const double* B, double* I) {
  double a = B[0], b = B[1], c = B[2];
  double d = B[4], ee = B[5];
  double f = B[8];
  double a_ = (a == 0.0) ? 1.0 : a;
  double d_ = (d == 0.0) ? 1.0 : d;
  double f_ = (f == 0.0) ? 1.0 : f;
  I[0] = 1.0 / a_; I[1] = -b / (a_ * d_); I[2] = (b * ee - c * d) / (a_ * d_ * f_);
  I[3] = 0.0;      I[4] = 1.0 / d_;       I[5] = -ee / (d_ * f_);
  I[6] = 0.0;      I[7] = 0.0;            I[8] = 1.0 / f_;
}

// opening rotations for the double-implicit-shift sweep
// (mirrors ops/pqz_real.py:_opening_rotations, minus the PRNG plumbing)
void opening_rotations(int p, int n, const double* H, const int* S, int j,
                       int ilast, long iiter, unsigned long long& rng,
                       double& c1, double& s1, double& c2, double& s2) {
  double r2;
  if (iiter % 10 == 0) {
    double rr0 = xrand(rng), rr1 = xrand(rng);
    double rr2 = xrand(rng), rr3 = xrand(rng);
    double r;
    givensr(rr0, rr1, c1, s1, r);
    givensr(rr2, rr3, c2, s2, r);
    return;
  }
  // leading 3x3 triangular-chain product (factors 1..p-1), scaled
  double T3[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  int eT = 0;
  for (int l = 1; l < p; ++l) {
    const double* Hl = H + (size_t)l * n * n;
    double blk[9], M[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        blk[a * 3 + b] = (b >= a) ? Hl[(size_t)(j + a) * n + (j + b)] : 0.0;
    if (S[l] > 0) std::memcpy(M, blk, sizeof(blk));
    else tri3inv(blk, M);
    double Q[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        double sacc = 0.0;
        for (int t = 0; t < 3; ++t) sacc += T3[a * 3 + t] * M[t * 3 + b];
        Q[a * 3 + b] = sacc;
      }
    std::memcpy(T3, Q, sizeof(Q));
    renorm_sc(T3, 9, eT);
  }
  const double* H0 = H;
  double H0w[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      H0w[a * 3 + b] = H0[(size_t)(j + a) * n + (j + b)];
  H0w[6] = 0.0;  // (2, 0) is outside the Hessenberg band
  double y1[3], t1[3], y2[3];
  for (int a = 0; a < 3; ++a)
    y1[a] = T3[a * 3] * H0w[0] + T3[a * 3 + 1] * H0w[3] + T3[a * 3 + 2] * H0w[6];
  for (int a = 0; a < 3; ++a)
    t1[a] = H0w[a * 3] * y1[0] + H0w[a * 3 + 1] * y1[1] + H0w[a * 3 + 2] * y1[2];
  for (int a = 0; a < 3; ++a)
    y2[a] = T3[a * 3] * t1[0] + T3[a * 3 + 1] * t1[1] + T3[a * 3 + 2] * t1[2];

  // exact trailing 2x2 of the rotated product, scaled
  int it = ilast - 1;
  double B2[4] = {1, 0, 0, 1};
  int eB = 0;
  for (int l = 1; l < p; ++l) {
    const double* Hl = H + (size_t)l * n * n;
    double a = Hl[(size_t)it * n + it];
    double b = Hl[(size_t)it * n + it + 1];
    double d = Hl[(size_t)(it + 1) * n + it + 1];
    double M[4];
    if (S[l] > 0) { M[0] = a; M[1] = b; M[2] = 0.0; M[3] = d; }
    else {
      double a_ = (a == 0.0) ? 1.0 : a;
      double d_ = (d == 0.0) ? 1.0 : d;
      M[0] = 1.0 / a_; M[1] = -b / (a_ * d_); M[2] = 0.0; M[3] = 1.0 / d_;
    }
    double Q[4];
    Q[0] = B2[0] * M[0] + B2[1] * M[2];
    Q[1] = B2[0] * M[1] + B2[1] * M[3];
    Q[2] = B2[2] * M[0] + B2[3] * M[2];
    Q[3] = B2[2] * M[1] + B2[3] * M[3];
    std::memcpy(B2, Q, sizeof(Q));
    renorm_sc(B2, 4, eB);
  }
  {
    double a = H0[(size_t)it * n + it];
    double b = H0[(size_t)it * n + it + 1];
    double cc = H0[(size_t)(it + 1) * n + it];
    double d = H0[(size_t)(it + 1) * n + it + 1];
    double Q[4];
    Q[0] = B2[0] * a + B2[1] * cc;
    Q[1] = B2[0] * b + B2[1] * d;
    Q[2] = B2[2] * a + B2[3] * cc;
    Q[3] = B2[2] * b + B2[3] * d;
    std::memcpy(B2, Q, sizeof(Q));
    renorm_sc(B2, 4, eB);
  }
  double trc = B2[0] + B2[3];
  double det = B2[0] * B2[3] - B2[1] * B2[2];
  double d_exp = (double)std::max(std::min(eB - eT, 500), -500);
  double f = std::exp2(d_exp);
  double v[3];
  v[0] = y2[0] - trc * f * y1[0] + det * f * f;
  v[1] = y2[1] - trc * f * y1[1];
  v[2] = y2[2] - trc * f * y1[2];
  givensr(v[1], v[2], c2, s2, r2);
  double rr;
  givensr(v[0], r2, c1, s1, rr);
}

// --------------------------------------------------------------------------
int pqz_real_gen(int p, int n, double* H, const int* S, double* Z,
                 double* alr, double* ali, double* beta, int* scal,
                 int maxitfac, int want_z, int* niter_out = nullptr) {
  const double ulp = 2.220446049250313e-16;
  const double unfl = 2.2250738585072014e-308;
  const double smlnum = unfl * ((double)n / ulp);
  const long maxit = (long)maxitfac * n;
  unsigned long long rng = 0xD1B54A32D192ED03ull;
  if (p < 2 || S[0] <= 0) return 2;  // caller falls back

  double* H0 = rmat_(H, 0, n);
  std::vector<double> W(4 * p), B(4 * p);
  std::vector<int> S2(p);

  int ilast = n - 1;
  long iiter = 0;
  long jiter = 0;
  for (; jiter < maxit && ilast >= 0; ++jiter) {
    // ---- test 1: bottom-most negligible Hessenberg subdiagonal ---------
    int jlo = 0;
    for (int j = ilast; j >= 1; --j) {
      double tol = std::max(ulp * (fabs(H0[(size_t)(j - 1) * n + j - 1]) +
                                   fabs(H0[(size_t)j * n + j])),
                            smlnum);
      if (fabs(H0[(size_t)j * n + j - 1]) <= tol) {
        H0[(size_t)j * n + j - 1] = 0.0;
        jlo = j;
        break;
      }
    }
    if (ilast == 0 || jlo == ilast) {
      // ---- split a 1x1 at ilast (signed safeprod over the diagonal) ----
      double a = 1.0, b = 1.0;
      int sc = 0;
      for (int l = 0; l < p; ++l) {
        double d = rmat_(H, l, n)[(size_t)ilast * n + ilast];
        if (S[l] > 0) a *= d;
        else {
          if (d == 0.0) b = 0.0;
          else a /= d;
        }
        renorm_sc(&a, 1, sc);
      }
      alr[ilast] = a; ali[ilast] = 0.0; beta[ilast] = b; scal[ilast] = sc;
      --ilast; iiter = 0;
      continue;
    }
    // ---- tests 2/3: negligible triangular diagonal -> fall back --------
    for (int l = 1; l < p; ++l) {
      const double* Hl = rmat_(H, l, n);
      for (int j = jlo; j <= ilast; ++j) {
        double t;
        if (j == ilast) t = fabs(Hl[(size_t)(j - 1) * n + j]);
        else if (j == jlo) t = fabs(Hl[(size_t)j * n + j + 1]);
        else t = fabs(Hl[(size_t)(j - 1) * n + j]) +
                 fabs(Hl[(size_t)j * n + j + 1]);
        if (fabs(Hl[(size_t)j * n + j]) <= std::max(ulp * t, smlnum)) {
          if (niter_out) *niter_out = (int)jiter;
          return 2;  // singular-factor machinery: jitted path
        }
      }
    }
    if (jlo == ilast - 1) {
      // ---- trailing 2x2 attack (mirrors act_attack) --------------------
      int j = ilast - 1;
      for (int l = 0; l < p; ++l) {
        const double* Hl = rmat_(H, l, n);
        W[(size_t)l * 4 + 0] = Hl[(size_t)j * n + j];
        W[(size_t)l * 4 + 1] = Hl[(size_t)j * n + j + 1];
        W[(size_t)l * 4 + 2] = Hl[(size_t)(j + 1) * n + j];
        W[(size_t)l * 4 + 3] = Hl[(size_t)(j + 1) * n + j + 1];
      }
      for (int t = 0; t < p; ++t) {
        int src = (t + 1) % p;  // Hessenberg block last
        std::memcpy(&B[(size_t)t * 4], &W[(size_t)src * 4],
                    4 * sizeof(double));
        S2[t] = S[src];
      }
      bool done2 = rp2x2ssr(p, B.data(), S2.data(), 40);
      if (done2) {
        // perfect-shift cascade (reference :695-709 semantics)
        double c1 = 1.0, s1 = 1.0, r;
        for (int l = p - 1; l >= 1; --l) {
          double rbl = B[(size_t)(l - 1) * 4 + 3];
          double hjj = rmat_(H, l, n)[(size_t)j * n + j];
          if (S[l] > 0) givensr(c1 * hjj, s1 * rbl, c1, s1, r);
          else givensr(c1 * rbl, s1 * hjj, c1, s1, r);
        }
        double rb = B[(size_t)(p - 1) * 4 + 3];
        givensr(c1 * H0[(size_t)j * n + j] - rb * s1,
                c1 * H0[(size_t)(j + 1) * n + j], c1, s1, r);
        chain510(p, n, H, S, Z, j, c1, s1, want_z);
        // the split 1x1s deflate via test 1 on the next iterations
      } else {
        double w1r, w1i, w2r, w2i, bflag;
        int s1c, s2c;
        eig2x2_product(p, W.data(), S, w1r, w1i, w2r, w2i, s1c, s2c, bflag);
        double wi_abs = fabs(w1i);
        alr[j] = w1r; alr[j + 1] = w1r;
        ali[j] = wi_abs; ali[j + 1] = -wi_abs;
        beta[j] = bflag; beta[j + 1] = bflag;
        scal[j] = s1c; scal[j + 1] = s2c;
        ilast -= 2;
        iiter = 0;
      }
      continue;
    }
    // ---- double-implicit-shift sweep (mirrors act_sweep) ---------------
    ++iiter;
    int ifirst = jlo;
    double c1, s1, c2, s2, r;
    opening_rotations(p, n, H, S, ifirst, ilast, iiter, rng, c1, s1, c2, s2);
    {
      // opening (reference :890-943); j = ifirst
      int j = ifirst;
      rot_cols(H0, n, j + 1, c2, s2, 0, ilast + 1);
      rot_cols(H0, n, j, c1, s1, 0, ilast + 1);
      if (want_z) {
        rot_cols(rmat_(Z, 1 % p, n), n, j + 1, c2, s2, 0, n);
        rot_cols(rmat_(Z, 1 % p, n), n, j, c1, s1, 0, n);
      }
      double c2l = c2, s2l = s2, c1l = c1, s1l = s1;
      for (int l = 1; l < p; ++l) {
        double* Hl = rmat_(H, l, n);
        if (S[l] > 0) {
          rot_rows(Hl, n, j + 1, c2l, s2l, j, n);
          givensr(Hl[(size_t)(j + 2) * n + j + 2],
                  -Hl[(size_t)(j + 2) * n + j + 1], c2l, s2l, r);
          Hl[(size_t)(j + 2) * n + j + 2] = r;
          Hl[(size_t)(j + 2) * n + j + 1] = 0.0;
          rot_cols(Hl, n, j + 1, c2l, s2l, 0, j + 2);
          rot_rows(Hl, n, j, c1l, s1l, j, n);
          givensr(Hl[(size_t)(j + 1) * n + j + 1],
                  -Hl[(size_t)(j + 1) * n + j], c1l, s1l, r);
          Hl[(size_t)(j + 1) * n + j + 1] = r;
          Hl[(size_t)(j + 1) * n + j] = 0.0;
          rot_cols(Hl, n, j, c1l, s1l, 0, j + 1);
        } else {
          rot_cols(Hl, n, j + 1, c2l, s2l, 0, j + 3);
          givensr(Hl[(size_t)(j + 1) * n + j + 1],
                  Hl[(size_t)(j + 2) * n + j + 1], c2l, s2l, r);
          Hl[(size_t)(j + 1) * n + j + 1] = r;
          Hl[(size_t)(j + 2) * n + j + 1] = 0.0;
          rot_rows(Hl, n, j + 1, c2l, s2l, j + 2, n);
          rot_cols(Hl, n, j, c1l, s1l, 0, j + 2);
          givensr(Hl[(size_t)j * n + j], Hl[(size_t)(j + 1) * n + j],
                  c1l, s1l, r);
          Hl[(size_t)j * n + j] = r;
          Hl[(size_t)(j + 1) * n + j] = 0.0;
          rot_rows(Hl, n, j, c1l, s1l, j + 1, n);
        }
        if (want_z) {
          int ln = (l + 1) % p;
          rot_cols(rmat_(Z, ln, n), n, j + 1, c2l, s2l, 0, n);
          rot_cols(rmat_(Z, ln, n), n, j, c1l, s1l, 0, n);
        }
      }
      rot_rows(H0, n, j + 1, c2l, s2l, j, n);
      rot_rows(H0, n, j, c1l, s1l, j, n);
    }
    // chase (reference :953-1014)
    for (int j = ifirst + 1; j <= ilast - 2; ++j) {
      double col0 = H0[(size_t)j * n + j - 1];
      double col1 = H0[(size_t)(j + 1) * n + j - 1];
      double col2 = H0[(size_t)(j + 2) * n + j - 1];
      double r2v, r1v;
      givensr(col1, col2, c2, s2, r2v);
      givensr(col0, r2v, c1, s1, r1v);
      H0[(size_t)j * n + j - 1] = r1v;
      H0[(size_t)(j + 1) * n + j - 1] = 0.0;
      H0[(size_t)(j + 2) * n + j - 1] = 0.0;
      rot_rows(H0, n, j + 1, c2, s2, j, n);
      rot_rows(H0, n, j, c1, s1, j, n);
      if (want_z) {
        rot_cols(rmat_(Z, 0, n), n, j + 1, c2, s2, 0, n);
        rot_cols(rmat_(Z, 0, n), n, j, c1, s1, 0, n);
      }
      for (int l = p - 1; l >= 1; --l) {
        double* Hl = rmat_(H, l, n);
        if (S[l] > 0) {
          rot_cols(Hl, n, j + 1, c2, s2, 0, j + 3);
          givensr(Hl[(size_t)(j + 1) * n + j + 1],
                  Hl[(size_t)(j + 2) * n + j + 1], c2, s2, r);
          Hl[(size_t)(j + 1) * n + j + 1] = r;
          Hl[(size_t)(j + 2) * n + j + 1] = 0.0;
          rot_rows(Hl, n, j + 1, c2, s2, j + 2, n);
          rot_cols(Hl, n, j, c1, s1, 0, j + 2);
          givensr(Hl[(size_t)j * n + j], Hl[(size_t)(j + 1) * n + j],
                  c1, s1, r);
          Hl[(size_t)j * n + j] = r;
          Hl[(size_t)(j + 1) * n + j] = 0.0;
          rot_rows(Hl, n, j, c1, s1, j + 1, n);
        } else {
          rot_rows(Hl, n, j + 1, c2, s2, j, n);
          givensr(Hl[(size_t)(j + 2) * n + j + 2],
                  -Hl[(size_t)(j + 2) * n + j + 1], c2, s2, r);
          Hl[(size_t)(j + 2) * n + j + 1] = 0.0;
          Hl[(size_t)(j + 2) * n + j + 2] = r;
          rot_cols(Hl, n, j + 1, c2, s2, 0, j + 2);
          rot_rows(Hl, n, j, c1, s1, j, n);
          givensr(Hl[(size_t)(j + 1) * n + j + 1],
                  -Hl[(size_t)(j + 1) * n + j], c1, s1, r);
          Hl[(size_t)(j + 1) * n + j] = 0.0;
          Hl[(size_t)(j + 1) * n + j + 1] = r;
          rot_cols(Hl, n, j, c1, s1, 0, j + 1);
        }
        if (want_z) {
          rot_cols(rmat_(Z, l, n), n, j + 1, c2, s2, 0, n);
          rot_cols(rmat_(Z, l, n), n, j, c1, s1, 0, n);
        }
      }
      int lm = std::min(j + 3, n - 1);
      rot_cols(H0, n, j + 1, c2, s2, 0, lm + 1);
      rot_cols(H0, n, j, c1, s1, 0, lm + 1);
    }
    // closing rotation at j = ilast-1 (reference :1015-1048)
    {
      int j = ilast - 1;
      double r1v;
      givensr(H0[(size_t)j * n + j - 1], H0[(size_t)(j + 1) * n + j - 1],
              c1, s1, r1v);
      H0[(size_t)j * n + j - 1] = r1v;
      H0[(size_t)(j + 1) * n + j - 1] = 0.0;
      chain510(p, n, H, S, Z, j, c1, s1, want_z);
    }
  }
  if (niter_out) *niter_out = (int)jiter;
  if (ilast >= 0) return 1;  // budget exhausted

  // scrub: zero subdiagonals under real eigenvalues; triangularize others
  for (int rr = 1; rr < n; ++rr)
    if (ali[rr - 1] == 0.0) H0[(size_t)rr * n + rr - 1] = 0.0;
  for (int f = 1; f < p; ++f) {
    double* Hf = rmat_(H, f, n);
    for (int rr = 1; rr < n; ++rr)
      for (int cc = 0; cc < rr; ++cc) Hf[(size_t)rr * n + cc] = 0.0;
  }
  return 0;
}

}  // namespace pqzrg

extern "C" {

// Full real periodic Schur pipeline: reduction + iteration.
// A: (p, n, n) row-major in/out (out: quasi-triangular T stack).
// Z: (p, n, n) out (orthogonal factors; Z[l]^T A[l] Z[l+1] = T[l]).
// wr, wi: (n,) eigenvalue parts.  Returns 0 on success, 1 on
// non-convergence.
int pschur_real_cpu(int p, int n, double* A, double* Z, double* wr,
                    double* wi, int maxitfac, int want_z) {
  phessenberg(p, n, A, Z, want_z);
  return pqr_real(p, n, A, Z, wr, wi, maxitfac, want_z);
}

// Reduction only (for tests).
void phessenberg_cpu(int p, int n, double* A, double* Q, int want_q) {
  phessenberg(p, n, A, Q, want_q);
}


// Complex periodic QZ of a Hessenberg+triangular cycle (AED windows).
// H: (p, n, n) row-major complex128 (interleaved) in/out; S: (p,) int
// (+1 direct / -1 or 0 inverted); Z: (p, n, n) complex128 out (identity-
// initialized here); alpha complex128 (n,), beta double (n,), scal int (n,).
// Returns 0 ok, 1 non-convergence, 2 singular-factor case (caller falls
// back to the full-machinery path).
// Real generalized periodic QZ of a Hessenberg+triangular signed cycle
// (rg AED windows).  H: (p, n, n) row-major double in/out (out: quasi-
// triangular T stack, 2x2 blocks on H[0] for complex pairs); S: (p,) int
// (+1 direct / -1 or 0 inverted, S[0] must be +1); Z: (p, n, n) out
// (identity-initialized here); alr/ali/beta double (n,), scal int (n,).
// Returns 0 ok, 1 non-convergence, 2 singular-factor case (caller falls
// back to the full-machinery jitted path).
int pqz_real_gen_cpu(int p, int n, double* H, const int* S, double* Z,
                     double* alr, double* ali, double* beta, int* scal,
                     int maxitfac, int want_z) {
  if (want_z) {
    for (int l = 0; l < p; ++l) {
      double* Zl = Z + (size_t)l * n * n;
      std::memset(Zl, 0, sizeof(double) * n * n);
      for (int i = 0; i < n; ++i) Zl[(size_t)i * n + i] = 1.0;
    }
  }
  if (n == 1) {
    double a = 1.0, b = 1.0;
    int sc = 0;
    for (int l = 0; l < p; ++l) {
      double d = H[(size_t)l * 1 * 1];
      if (S[l] > 0) a *= d;
      else {
        if (d == 0.0) b = 0.0;
        else a /= d;
      }
      pqzrg::renorm_sc(&a, 1, sc);
    }
    alr[0] = a; ali[0] = 0.0; beta[0] = b; scal[0] = sc;
    return 0;
  }
  return pqzrg::pqz_real_gen(p, n, H, S, Z, alr, ali, beta, scal,
                             maxitfac, want_z);
}

// Variant reporting the iteration count (adversarial shift-scheme
// validation harness, benchmarks/probe_rg_hostile.py).
int pqz_real_gen_niter_cpu(int p, int n, double* H, const int* S, double* Z,
                           double* alr, double* ali, double* beta, int* scal,
                           int maxitfac, int want_z, int* niter) {
  *niter = 0;
  if (want_z) {
    for (int l = 0; l < p; ++l) {
      double* Zl = Z + (size_t)l * n * n;
      std::memset(Zl, 0, sizeof(double) * n * n);
      for (int i = 0; i < n; ++i) Zl[(size_t)i * n + i] = 1.0;
    }
  }
  if (n == 1) {
    // same signed-safeprod fill as pqz_real_gen_cpu (a bare `return 0`
    // here used to report success with alpha=beta=0)
    double a = 1.0, b = 1.0;
    int sc = 0;
    for (int l = 0; l < p; ++l) {
      double d = H[(size_t)l * 1 * 1];
      if (S[l] > 0) a *= d;
      else {
        if (d == 0.0) b = 0.0;
        else a /= d;
      }
      pqzrg::renorm_sc(&a, 1, sc);
    }
    alr[0] = a; ali[0] = 0.0; beta[0] = b; scal[0] = sc;
    return 0;
  }
  return pqzrg::pqz_real_gen(p, n, H, S, Z, alr, ali, beta, scal,
                             maxitfac, want_z, niter);
}

int pqz_complex_cpu(int p, int n, double* H, const int* S, double* Z,
                    double* alpha, double* beta, int* scal, int maxitfac,
                    int want_z) {
  using pqzcx::cd;
  cd* Hc = reinterpret_cast<cd*>(H);
  cd* Zc = reinterpret_cast<cd*>(Z);
  if (want_z) {
    for (int l = 0; l < p; ++l)
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          Zc[(size_t)l * n * n + (size_t)i * n + j] =
              (i == j) ? cd(1.0, 0.0) : cd(0.0, 0.0);
  }
  return pqzcx::pqz_complex(p, n, Hc, S, Zc,
                            reinterpret_cast<cd*>(alpha), beta, scal,
                            maxitfac, want_z);
}

}  // extern "C"
