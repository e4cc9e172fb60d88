// Symmetric 8x8 matrix functions, one matrix a thread, shared by the
// feature kernel (csrc/logcov_feats.cu, both modes) and the Clenshaw kernel
// (csrc/logm_clenshaw.cu).
//
// A matrix is held packed (its upper triangle, row-major, 36 words) in the
// thread's column of a shared array, word q at slot[q * kStride] with the
// block's threads on neighbouring words, so every access, permuted or not,
// is free of bank conflicts. The pieces:
//   - load_permuted / store_permuted: the channels in ascending order of
//     the diagonal (a sorting network), gathered into float64 registers,
//     and the result scattered back into the channels' order;
//   - tridiagonalize: T = Q^T A Q by 6 Householder reflectors in float64,
//     the reflectors rounded to float32 for back_transform (r <- Q r Q^T);
//   - tridiagonal_eigen: T = Z diag(lambda) Z^T by the implicit-shift QL
//     iteration (Numerical Recipes' tqli) in float64, the rotations
//     accumulated into Z in float32, at most kMaxSweeps sweeps an
//     eigenvalue, so a NaN or Inf input ends in bounded time;
//   - chebyshev_series: sum_k c_k T_k(x) at the 8 eigenvalues by the scalar
//     Clenshaw recurrence in float64;
//   - chebyshev_sym8: the whole route, p(A) = Q Z diag(p(x)) Z^T Q^T with
//     x = (2 lambda - shift) * scale.
// Nothing crosses lanes and nothing synchronises.
// Why float64: on [lo, hi] = [0.002, 8] the map onto [-1, 1] has
// d lambda / dx = 4, so an error of eps ||x|| (6e-8 in float32) in an
// eigenvalue near lo moves its log by about 1.2e-4, the size of the float32
// matrix recurrence's whole error against float64. Z may be float32: an
// error of eps in an eigenvector moves r by about eps max |p|.

#pragma once

namespace nsd {

constexpr int kSymC = 8;
constexpr int kSymPairs = kSymC * (kSymC + 1) / 2;  // 36
constexpr int kReflectorWords = 27;                 // hv[k][k+1..7], k = 0..5
constexpr int kMaxSweeps = 30;                      // QL sweeps an eigenvalue (tqli's cap)

// (i, j), i <= j -> row-major upper-triangle index
__host__ __device__ constexpr int sym_pidx(int i, int j) {
  return i * kSymC - i * (i - 1) / 2 + (j - i);
}

// either order of (i, j)
__host__ __device__ constexpr int sym_at(int i, int j) {
  return i <= j ? sym_pidx(i, j) : sym_pidx(j, i);
}

// perm[0..7]: the channels in ascending order of the diagonal d (Batcher's
// 19-comparator network, in registers).
__device__ __forceinline__ void ascending_order(const float (&d)[kSymC], int (&perm)[kSymC]) {
  float key[kSymC];
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
    key[i] = d[i];
    perm[i] = i;
  }
  constexpr int kNet[19][2] = {{0, 2}, {1, 3}, {4, 6}, {5, 7}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {0, 1}, {2, 3},
                               {4, 5}, {6, 7}, {2, 4}, {3, 5}, {1, 4}, {3, 6}, {1, 2}, {3, 4}, {5, 6}};
#pragma unroll
  for (int c = 0; c < 19; ++c) {
    const int i = kNet[c][0], j = kNet[c][1];
    const bool swap = key[j] < key[i];
    const float ki = key[i], kj = key[j];
    const int pi = perm[i], pj = perm[j];
    key[i] = swap ? kj : ki;
    key[j] = swap ? ki : kj;
    perm[i] = swap ? pj : pi;
    perm[j] = swap ? pi : pj;
  }
}

// The packed matrix in slot with its channels in ascending order of the
// diagonal (perm[i] is the channel at row i), in float64: a small channel
// then enters the reduction first, where no larger entry has been folded
// into it, which keeps an eigenvalue near lo accurate.
template <int kStride>
__device__ __forceinline__ void load_permuted(const float* slot, int (&perm)[kSymC], double (&a)[kSymPairs]) {
  float diag[kSymC];
#pragma unroll
  for (int i = 0; i < kSymC; ++i) diag[i] = slot[sym_pidx(i, i) * kStride];
  ascending_order(diag, perm);
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
#pragma unroll
    for (int j = i; j < kSymC; ++j) a[sym_pidx(i, j)] = slot[sym_at(perm[i], perm[j]) * kStride];
  }
}

// r (rows in the order perm) back into the channels' order in slot.
template <int kStride>
__device__ __forceinline__ void store_permuted(float* slot, const int (&perm)[kSymC], const float (&r)[kSymPairs]) {
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
#pragma unroll
    for (int j = i; j < kSymC; ++j) slot[sym_at(perm[i], perm[j]) * kStride] = r[sym_pidx(i, j)];
  }
}

// Householder reduction of the symmetric a (upper triangle) to tridiagonal
// T = Q^T a Q, Q = H_0 ... H_5, H_k = I - beta_k v_k v_k^T with v_k nonzero
// on k+1..7 only, in float64: on a graded matrix (a railed or a cold
// channel) a float32 update a - v w^T - w v^T rounds the small entries
// against the large ones, which moves an eigenvalue near lo by about
// eps ||A||. Returns T's diagonal d and off-diagonal e[0..6] in float64 and
// the reflectors rounded to float32; a is consumed.
__device__ __forceinline__ void tridiagonalize(double (&a)[kSymPairs], float (&hv)[kSymC - 2][kSymC],
                                               float (&hb)[kSymC - 2], double (&d)[kSymC],
                                               double (&e)[kSymC - 1]) {
#pragma unroll
  for (int k = 0; k < kSymC - 2; ++k) {
    const double x0 = a[sym_pidx(k, k + 1)];
    double sigma = 0.0;
#pragma unroll
    for (int i = k + 2; i < kSymC; ++i) sigma = fma(a[sym_pidx(k, i)], a[sym_pidx(k, i)], sigma);
    // sigma == 0: the column is already reduced; beta = 0 leaves a alone
    const bool reflect = sigma > 0.0;
    const double alpha = reflect ? -copysign(sqrt(fma(x0, x0, sigma)), x0) : x0;
    double v[kSymC];
    v[k + 1] = x0 - alpha;
#pragma unroll
    for (int i = k + 2; i < kSymC; ++i) v[i] = a[sym_pidx(k, i)];
    const double beta = reflect ? 2.0 / fma(v[k + 1], v[k + 1], sigma) : 0.0;
    hb[k] = static_cast<float>(beta);
    e[k] = alpha;
#pragma unroll
    for (int i = k + 1; i < kSymC; ++i) hv[k][i] = static_cast<float>(v[i]);
    // trailing block B (rows and columns k+1..7): B - v w^T - w v^T with
    // p = beta B v, w = p - (beta / 2) (p^T v) v
    double p[kSymC], w[kSymC];
    double pv = 0.0;
#pragma unroll
    for (int i = k + 1; i < kSymC; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int j = k + 1; j < kSymC; ++j) acc = fma(a[sym_at(i, j)], v[j], acc);
      p[i] = beta * acc;
      pv = fma(p[i], v[i], pv);
    }
    const double half_bpv = 0.5 * beta * pv;
#pragma unroll
    for (int i = k + 1; i < kSymC; ++i) w[i] = p[i] - half_bpv * v[i];
#pragma unroll
    for (int i = k + 1; i < kSymC; ++i) {
#pragma unroll
      for (int j = i; j < kSymC; ++j) a[sym_pidx(i, j)] -= v[i] * w[j] + w[i] * v[j];
    }
  }
  e[kSymC - 2] = a[sym_pidx(kSymC - 2, kSymC - 1)];
#pragma unroll
  for (int i = 0; i < kSymC; ++i) d[i] = a[sym_pidx(i, i)];
}

// r <- Q r Q^T = H_0 (H_1 (... (H_5 r H_5) ...) H_1) H_0, each two-sided
// update r - v w^T - w v^T with p = beta r v, w = p - (beta / 2) (p^T v) v,
// v zero on 0..k.
__device__ __forceinline__ void back_transform(const float (&hv)[kSymC - 2][kSymC], const float (&hb)[kSymC - 2],
                                               float (&r)[kSymPairs]) {
#pragma unroll
  for (int k = kSymC - 3; k >= 0; --k) {
    float p[kSymC], w[kSymC];
    float pv = 0.0f;
#pragma unroll
    for (int i = 0; i < kSymC; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = k + 1; j < kSymC; ++j) acc = fmaf(r[sym_at(i, j)], hv[k][j], acc);
      p[i] = hb[k] * acc;
      if (i > k) pv = fmaf(p[i], hv[k][i], pv);
    }
    const float half_bpv = 0.5f * hb[k] * pv;
#pragma unroll
    for (int i = 0; i < kSymC; ++i) w[i] = i > k ? p[i] - half_bpv * hv[k][i] : p[i];
#pragma unroll
    for (int i = 0; i < kSymC; ++i) {
#pragma unroll
      for (int j = i; j < kSymC; ++j) {
        const float vi = i > k ? hv[k][i] : 0.0f;
        const float vj = j > k ? hv[k][j] : 0.0f;
        r[sym_pidx(i, j)] -= vi * w[j] + w[i] * vj;
      }
    }
  }
}

// The reflectors into the slot's words (27 of hv, then the 6 of hb) while
// the eigen solve and the series hold their registers, and back. The
// accesses are volatile, so the compiler cannot keep the stored values in
// registers instead (with the packed permutation of chebyshev_sym8: 168
// registers a thread on sm_90a, 196 without either).
template <int kStride>
__device__ __forceinline__ void stash_reflectors(float* slot, const float (&hv)[kSymC - 2][kSymC],
                                                 const float (&hb)[kSymC - 2]) {
  volatile float* vs = slot;
  int q = 0;
#pragma unroll
  for (int k = 0; k < kSymC - 2; ++k) {
#pragma unroll
    for (int i = k + 1; i < kSymC; ++i) vs[(q++) * kStride] = hv[k][i];
  }
#pragma unroll
  for (int k = 0; k < kSymC - 2; ++k) vs[(kReflectorWords + k) * kStride] = hb[k];
}

template <int kStride>
__device__ __forceinline__ void unstash_reflectors(const float* slot, float (&hv)[kSymC - 2][kSymC],
                                                   float (&hb)[kSymC - 2]) {
  const volatile float* vs = slot;
  int q = 0;
#pragma unroll
  for (int k = 0; k < kSymC - 2; ++k) {
#pragma unroll
    for (int i = k + 1; i < kSymC; ++i) hv[k][i] = vs[(q++) * kStride];
  }
#pragma unroll
  for (int k = 0; k < kSymC - 2; ++k) hb[k] = vs[(kReflectorWords + k) * kStride];
}

// Eigen-decomposition of the symmetric tridiagonal (d, e[0..6]), e[7] = 0:
// on return d holds the eigenvalues (in no order) and column j of z the
// eigenvector of d[j]. Implicit-shift QL (tqli) in float64. Every index is
// a constant of the unrolled loops: the split point m is found by a scan
// and the rotations beyond it are skipped, so nothing goes to local memory.
__device__ __forceinline__ void tridiagonal_eigen(double (&d)[kSymC], double (&e)[kSymC],
                                                  float (&z)[kSymC][kSymC]) {
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
#pragma unroll
    for (int j = 0; j < kSymC; ++j) z[i][j] = i == j ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int l = 0; l < kSymC - 1; ++l) {
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
      // m: the first j >= l with e[j] negligible (7 if none); a NaN is never
      // negligible, so its matrix runs to the cap
      int m = kSymC - 1;
#pragma unroll
      for (int j = kSymC - 2; j >= l; --j) {
        const double dd = fabs(d[j]) + fabs(d[j + 1]);
        if (fabs(e[j]) + dd == dd) m = j;
      }
      if (m == l) break;
      double dm = d[l];
#pragma unroll
      for (int j = l + 1; j < kSymC; ++j) dm = j == m ? d[j] : dm;
      // Wilkinson-like shift from the leading 2x2 block
      double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
      double r = sqrt(fma(g, g, 1.0));
      g = dm - d[l] + e[l] / (g + copysign(r, g));
      double s = 1.0, c = 1.0, p = 0.0;
      bool underflow = false;
#pragma unroll
      for (int i = kSymC - 2; i >= l; --i) {
        if (i < m && !underflow) {
          const double f = s * e[i], b = c * e[i];
          const double r2 = fma(f, f, g * g);
          if (r2 == 0.0) {  // f = g = 0: T splits here; sweep again
            e[i + 1] = 0.0;
            d[i + 1] -= p;
            underflow = true;
          } else {
            const double inv_r = rsqrt(r2);
            e[i + 1] = r2 * inv_r;
            s = f * inv_r;
            c = g * inv_r;
            g = d[i + 1] - p;
            r = fma(d[i] - g, s, 2.0 * c * b);
            p = s * r;
            d[i + 1] = g + p;
            g = fma(c, r, -b);
            const float cf = static_cast<float>(c), sf = static_cast<float>(s);
#pragma unroll
            for (int k = 0; k < kSymC; ++k) {
              const float zi = z[k][i], zi1 = z[k][i + 1];
              z[k][i + 1] = fmaf(sf, zi, cf * zi1);
              z[k][i] = fmaf(cf, zi, -sf * zi1);
            }
          }
        }
      }
      if (!underflow) {
        d[l] -= p;
        e[l] = g;
      }
#pragma unroll
      for (int j = l + 1; j < kSymC; ++j) e[j] = j == m ? 0.0 : e[j];
    }
  }
}

// p[i] = sum_k c_k T_k(x[i]) for the float32 coefficients c_0..c_degree in
// device memory: b_k = c_k + 2 x b_(k+1) - b_(k+2), p = c_0 + x b_1 - b_2,
// in float64, two steps a trip so that b1 and b2 swap roles without a copy.
__device__ __forceinline__ void chebyshev_series(const double (&x)[kSymC], const float* __restrict__ coeffs,
                                                 int degree, double (&p)[kSymC]) {
  double b1[kSymC], b2[kSymC], x2[kSymC];
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
    b1[i] = 0.0;
    b2[i] = 0.0;
    x2[i] = 2.0 * x[i];
  }
  int k = degree;
  for (; k >= 2; k -= 2) {
    const double ck = __ldg(coeffs + k), ck1 = __ldg(coeffs + k - 1);
#pragma unroll
    for (int i = 0; i < kSymC; ++i) b2[i] = fma(x2[i], b1[i], ck - b2[i]);   // b_k
#pragma unroll
    for (int i = 0; i < kSymC; ++i) b1[i] = fma(x2[i], b2[i], ck1 - b1[i]);  // b_(k-1)
  }
  const double c0 = __ldg(coeffs);
  if (k == 1) {
    const double c1 = __ldg(coeffs + 1);
#pragma unroll
    for (int i = 0; i < kSymC; ++i) {
      b2[i] = fma(x2[i], b1[i], c1 - b2[i]);  // b_1; b1 holds b_2
      p[i] = fma(x[i], b2[i], c0 - b1[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSymC; ++i) p[i] = fma(x[i], b1[i], c0 - b2[i]);
  }
}

// The packed symmetric A in slot -> sum_k c_k T_k(X) in its place, X =
// (2 A - shift I) * scale (shift 0 and scale 0.5: X = A), by one float64
// eigendecomposition: Householder, QL, the scalar series p at the
// eigenvalues, r = Z diag(p - pm) Z^T (float32), r <- Q r Q^T, and pm =
// (min p + max p) / 2 added to the diagonal last: Q Z is orthogonal only to
// float32 rounding, so the part of p common to every eigenvalue goes round
// it (a degree-0 series gives c_0 I exactly).
template <int kStride>
__device__ __forceinline__ void chebyshev_sym8(float* slot, const float* __restrict__ coeffs, int degree,
                                               double shift, double scale) {
  int perm[kSymC];
  float hv[kSymC - 2][kSymC], hb[kSymC - 2];
  double d[kSymC], e[kSymC];
  {
    double a[kSymPairs];
    load_permuted<kStride>(slot, perm, a);
    double e7[kSymC - 1];
    tridiagonalize(a, hv, hb, d, e7);
#pragma unroll
    for (int i = 0; i < kSymC - 1; ++i) e[i] = e7[i];
    e[kSymC - 1] = 0.0;
  }
  stash_reflectors<kStride>(slot, hv, hb);
  unsigned packed = 0;  // the permutation, 4 bits a row, while the solve holds the registers
#pragma unroll
  for (int i = 0; i < kSymC; ++i) packed |= static_cast<unsigned>(perm[i]) << (4 * i);
  float z[kSymC][kSymC];
  tridiagonal_eigen(d, e, z);
  double x[kSymC], p[kSymC];
#pragma unroll
  for (int i = 0; i < kSymC; ++i) x[i] = (2.0 * d[i] - shift) * scale;
  chebyshev_series(x, coeffs, degree, p);
  double pmin = p[0], pmax = p[0];
#pragma unroll
  for (int i = 1; i < kSymC; ++i) {
    pmin = fmin(pmin, p[i]);
    pmax = fmax(pmax, p[i]);
  }
  const double pm = 0.5 * (pmin + pmax);
  float pd[kSymC];
#pragma unroll
  for (int k = 0; k < kSymC; ++k) pd[k] = static_cast<float>(p[k] - pm);
  float r[kSymPairs];
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
    float zp[kSymC];
#pragma unroll
    for (int k = 0; k < kSymC; ++k) zp[k] = z[i][k] * pd[k];
#pragma unroll
    for (int j = i; j < kSymC; ++j) {
      float acc = zp[0] * z[j][0];
#pragma unroll
      for (int k = 1; k < kSymC; ++k) acc = fmaf(zp[k], z[j][k], acc);
      r[sym_pidx(i, j)] = acc;
    }
  }
  unstash_reflectors<kStride>(slot, hv, hb);
  back_transform(hv, hb, r);
  const float pmf = static_cast<float>(pm);
#pragma unroll
  for (int i = 0; i < kSymC; ++i) r[sym_pidx(i, i)] += pmf;
#pragma unroll
  for (int i = 0; i < kSymC; ++i) perm[i] = static_cast<int>((packed >> (4 * i)) & 7u);
  store_permuted<kStride>(slot, perm, r);
}

}  // namespace nsd
