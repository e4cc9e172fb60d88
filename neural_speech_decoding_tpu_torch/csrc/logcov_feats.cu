// Fused whitened log-covariance features (rational or Chebyshev matrix
// log) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   neural_speech_decoding_tpu/ops/pallas/logmfeats.py:63 _fused_kernel
//   (grid call _fused_batched:320, wrapper
//   fused_whitened_logcov_feature_rows:344) in both its modes:
//   logm="rational" (logcov_feats_kernel below) and logm="chebyshev"
//   (:239-275, logcov_feats_cheb_kernel below).
// Python wrapper and plain twin:
//   neural_speech_decoding_tpu_torch/ops/kernels/logmfeats.py
//
// Per window b and band k, from the band-gram pairs g [36] (bandcov_grams),
// the scaled unwhitened trace t = tr(G) 2/T^2 and the pairs of W W^T:
//   1. shrinkage  s = (1 - a) (g scale) + (a (t / C + 1e-12)) wwt
//   2. guard      tr = sum of the diagonal; tr_df = max(tr, 1e-30) / C;
//                 Cholesky of s / tr_df - lo I (and of hi I - s / tr_df
//                 when hi < C) with pivots sqrt(max(d, 1e-30)); where a
//                 pivot is <= 0 the band is flagged and s is replaced by
//                 (1 - g) s + g (tr / C + 1e-12) I; tr is recomputed
//   3. matrix log A = s * (1 / (tr / C));
//                 out = c0 I + sum_j v_j (A - p_j I)^{-1}, poles accumulated
//                 in order (the twin inverts each shift by pivot-free
//                 Gauss-Jordan; this kernel as set out below)
//   4. features   out_ii + log(tr / C) on the diagonal, sqrt(2) out_ij off
//                 it, upper triangle row-major: feats[b, k * 36 + p]
// and flags[b, k] = 1 where the guard fired. Steps 1 and 2 use explicitly
// rounded operations (__fmul_rn and the like, never contracted into an
// FMA) in the order of the plain twin, so the guard decides exactly as the
// twin does; step 3 lets the compiler form FMAs.
//
// Chebyshev mode: steps 1, 2 and 4 are the same code; step 3 evaluates the
// JAX kernel's polynomial c_0 I + sum_k c_k T_k(t), t = (2 A - (hi + lo) I)
// / (hi - lo), A = s * (1 / (tr / C)), through one eigendecomposition of A
// (sym8_eigen.cuh) instead of the matrix Clenshaw recurrence: A's channels
// in ascending order of the diagonal, the Householder tridiagonal form and
// its implicit-shift QL iteration in float64, each eigenvalue mapped in
// float64 onto [-1, 1], the scalar Clenshaw recurrence there in float64,
// r = Z diag(p) Z^T in float32, the rational mode's back-transformation
// and the inverse permutation: about 8 k float64 and 3 k float32
// operations a matrix, where the JAX kernel's matrix recurrence does 320
// steps of 288 FMAs. It also errs less: a float32 map onto the domain
// rounds t by about 6e-8, which moves the log of an eigenvalue near lo by
// about 1.2e-4; here the map is in float64. The time is latency-bound:
// 168 registers a thread leave 12 warps an SM for the QL iteration's
// serial float64 chain, and the series runs at the float64 rate.
// Bound (B = 16384, degree 320): the same 38.4 MB, 0.0115 ms; the least
// work is an eigendecomposition (about 9 C^3), the scalar series at C
// eigenvalues (3 d C), V f(L) V^T (2 C^3) and the guard, about 13.7 kFLOP
// a matrix, 1.8 GFLOP, 0.027 ms at the float32 rate: bound by operations.
// Design: one thread a matrix, 32-thread blocks, as the rational mode.
//
// Bound on this card (logcov8, B = 16384, 131072 matrices): bytes are the
// gram pairs read once and the features written once, 18.9 MB each, plus
// the traces and flags (0.5 + 0.13 MB): about 38.4 MB, 0.0115 ms at
// 3.35 TB/s. The least work is about 4.5 kFLOP a matrix (0.59 GFLOP,
// 0.009 ms at 67 TFLOP/s): the Householder reduction, the shifted
// tridiagonal inverses, the back-transformation, the Cholesky guard and
// the elementwise steps. So the function is bound by bytes, at about
// 0.0115 ms (chip_smoke.py computes the bound from the run's shapes).
//
// Rational mode, design: one thread owns one matrix (32-thread blocks, so
// the 8192 matrices of B = 1024 spread over 256 blocks). The guard runs
// once a matrix and nothing crosses lanes: an earlier design gave each
// matrix 8 lanes, ran the guard (about 130 IEEE divisions) in all 8, and
// broadcast every Gauss-Jordan pivot row by shuffles, 1536 shuffles a warp
// for 29 kFLOP a matrix, which bound it at about a quarter of the FMA rate.
// Step 3 here takes the route the bound counts:
//   a. Householder tridiagonalisation T = Q^T A Q by 6 reflectors, on the
//      packed upper triangle in float64 (about 700 operations a matrix),
//      T and the reflectors then rounded to float32 and kept in registers;
//   b. per pole p_j < 0, in the twin's order, r += v_j (T - p_j I)^{-1}: the
//      shift is SPD, so the bottom-up factorisation T - p I = U D U^T needs
//      no pivoting (D_i >= lambda_min + |p_j|); with rho_i = -e_{i-1} / D_i
//      the inverse is L D^-1 L^T, L_ij = rho_{j+1} ... rho_i, so M_jj =
//      1 / D_j + rho_j^2 M_{j-1,j-1} (positive terms) and M_ij = rho_i
//      M_{i-1,j} below it: 8 reciprocals and about 100 FMAs a pole;
//   c. r <- Q r Q^T by the reflectors from both sides, then + c0 I.
// The reduction works on A with its channels in ascending order of the
// diagonal (a sorting network, then a gather through the thread's slot
// of shared memory; the result is scattered back the same way; the
// permutation, the reduction and the back-transformation are the shared
// code of sym8_eigen.cuh). A float32
// orthogonal reduction errs by about eps ||A|| in an eigenvalue: on the
// graded matrices of a railed channel or a whitener gain cut tenfold, with
// an eigenvalue near lo, it read up to 5x the twin's elimination error
// against float64 on the card. In float64 with the small channel first, a
// CPU emulation of the route reads at most 0.7x the twin's.
// The reduction holds A's 36 entries in float64; the pole loop about 110
// live floats (36 of r, 27 of reflectors, the tridiagonal, a pole's
// pivots), all indexed by unrolled constants. The features go out in nine
// 16-byte stores.
// No fast-math: the guard and the pivots rely on IEEE division and sqrt.

#include <cuda_runtime.h>

#include "sym8_eigen.cuh"

namespace {

constexpr int kC = 8;                       // channels (the wrapper checks)
constexpr int kPairs = kC * (kC + 1) / 2;   // 36
constexpr int kMaxTerms = 32;               // resolvent poles
constexpr int kMaxDegree = 4096;            // Chebyshev degree
constexpr int kThreads = 32;                // 32 matrices a block: B = 1024 spreads over 256 blocks
constexpr float kSqrt2 = static_cast<float>(1.4142135623730951);  // float32 sqrt(2)

struct GuardParams {
  float scale;            // 2 / T^2
  float alpha;            // shrinkage a
  float one_minus_alpha;  // 1 - a, rounded from float64 as the twin does
  float lo, hi;           // spectrum domain
  float guard_g;          // guard shrinkage g
  float one_minus_g;      // 1 - g
  int mirror;             // 1 when hi < C: test the upper edge too
};

struct Params {
  GuardParams guard;
  float c0;               // resolvent constant
  int terms;              // number of poles
  float poles[kMaxTerms];
  float weights[kMaxTerms];
};

struct ChebParams {
  GuardParams guard;
  double hi_plus_lo;      // the domain map x = (2 lambda - (hi + lo)) / (hi - lo),
  double inv_hi_minus_lo; // in float64
  int degree;
};

__host__ __device__ constexpr int pidx(int i, int j) {
  // (i, j), i <= j -> row-major upper-triangle index
  return nsd::sym_pidx(i, j);
}

// Cholesky PD test of the symmetric matrix e(i, j) (Sylvester's criterion,
// every pivot > 0), with the twin's order of operations.
template <typename Entry>
__device__ __forceinline__ bool pd_ok(Entry e) {
  float low[kPairs];  // low[pidx(j, i)] holds L[i][j], i > j
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    float d = e(j, j);
#pragma unroll
    for (int k = 0; k < j; ++k) d = __fsub_rn(d, __fmul_rn(low[pidx(k, j)], low[pidx(k, j)]));
    ok = ok && (d > 0.0f);
    const float ljj = __fsqrt_rn(fmaxf(d, 1e-30f));
#pragma unroll
    for (int i = j + 1; i < kC; ++i) {
      float t = e(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) t = __fsub_rn(t, __fmul_rn(low[pidx(k, i)], low[pidx(k, j)]));
      low[pidx(j, i)] = __fdiv_rn(t, ljj);
    }
  }
  return ok;
}

// Steps 1 and 2 of one matrix: s (its upper triangle) and trace out,
// returns false where the guard fired (s is then the shrunk matrix).
__device__ __forceinline__ bool shrink_and_guard(const float* __restrict__ g, float tr_scaled,
                                                 const float* __restrict__ w, const GuardParams& prm,
                                                 float (&s)[kPairs], float& trace) {
  // 1. shrinkage combine: scale first, then the convex mix
  const float shr = __fmul_rn(prm.alpha, __fadd_rn(__fdiv_rn(tr_scaled, 8.0f), 1e-12f));
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    s[p] = __fadd_rn(__fmul_rn(prm.one_minus_alpha, __fmul_rn(__ldg(g + p), prm.scale)),
                     __fmul_rn(shr, __ldg(w + p)));
  }
  trace = s[pidx(0, 0)];
#pragma unroll
  for (int i = 1; i < kC; ++i) trace = __fadd_rn(trace, s[pidx(i, i)]);

  // 2. spectrum guard
  const float tr_df = __fdiv_rn(fmaxf(trace, 1e-30f), static_cast<float>(kC));
  bool ok = pd_ok([&](int i, int j) {
    const float v = __fdiv_rn(s[pidx(min(i, j), max(i, j))], tr_df);
    return i == j ? __fsub_rn(v, prm.lo) : v;
  });
  if (prm.mirror) {
    ok = ok && pd_ok([&](int i, int j) {
      const float v = __fdiv_rn(s[pidx(min(i, j), max(i, j))], tr_df);
      return i == j ? __fsub_rn(prm.hi, v) : -v;
    });
  }
  if (!ok) {
    const float diag_add = __fmul_rn(prm.guard_g, __fadd_rn(__fdiv_rn(trace, static_cast<float>(kC)), 1e-12f));
#pragma unroll
    for (int i = 0; i < kC; ++i) {
#pragma unroll
      for (int j = i; j < kC; ++j) {
        const float v = __fmul_rn(prm.one_minus_g, s[pidx(i, j)]);
        s[pidx(i, j)] = i == j ? __fadd_rn(v, diag_add) : v;
      }
    }
    trace = s[pidx(0, 0)];
#pragma unroll
    for (int i = 1; i < kC; ++i) trace = __fadd_rn(trace, s[pidx(i, i)]);
  }
  return ok;
}

// Step 3b: r += v (T - p I)^{-1} for the symmetric tridiagonal T (d, e),
// every shift SPD (p < 0). With the pivot-free bottom-up factorisation
// T - p I = U D U^T (D_i = d_i - p - e_i^2 / D_{i+1}, all >= lambda_min +
// |p|), the inverse is L D^-1 L^T with L = U^-T unit lower triangular,
// L_ij = rho_{j+1} ... rho_i, rho_i = -e_{i-1} / D_i; so its diagonal is
// M_jj = 1 / D_j + rho_j^2 M_{j-1,j-1} (a sum of positive terms) and
// below it M_ij = rho_i M_{i-1,j}: O(C^2), 8 reciprocals.
__device__ __forceinline__ void add_shifted_inverse(const float (&d)[kC], const float (&e)[kC - 1],
                                                    const float (&e2)[kC - 1], float p, float v,
                                                    float (&r)[kPairs]) {
  float inv[kC];
  float piv = d[kC - 1] - p;
  inv[kC - 1] = __frcp_rn(piv);
#pragma unroll
  for (int i = kC - 2; i >= 0; --i) {
    piv = fmaf(-e2[i], inv[i + 1], d[i] - p);
    inv[i] = __frcp_rn(piv);
  }
  float rho[kC];
#pragma unroll
  for (int i = 1; i < kC; ++i) rho[i] = -e[i - 1] * inv[i];
  float mjj = inv[0];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (j > 0) mjj = fmaf(rho[j] * rho[j], mjj, inv[j]);
    r[pidx(j, j)] = fmaf(v, mjj, r[pidx(j, j)]);
    float mij = mjj;
#pragma unroll
    for (int i = j + 1; i < kC; ++i) {
      mij *= rho[i];
      r[pidx(j, i)] = fmaf(v, mij, r[pidx(j, i)]);
    }
  }
}

// Step 4 from the slot (the log without c0 and log(tr / C)): c0 and
// log(tr / C) on the diagonal, sqrt(2) off it; nine 16-byte stores (the
// 144-byte rows are aligned).
__device__ __forceinline__ void write_features(const float* slot, float c0, float logtr, float* __restrict__ row) {
  float f[kPairs];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
#pragma unroll
    for (int j = i; j < kC; ++j) {
      const int q = pidx(i, j);
      const float v = slot[q * kThreads];
      f[q] = i == j ? (v + c0) + logtr : v * kSqrt2;
    }
  }
  float4* out = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int q = 0; q < kPairs / 4; ++q) out[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
}

__global__ void __launch_bounds__(kThreads)
logcov_feats_kernel(const float* __restrict__ grams, const float* __restrict__ tr_scaled,
                    const float* __restrict__ wwt, float* __restrict__ feats,
                    unsigned char* __restrict__ flags, long long matrices, int nb,
                    Params prm) {
  __shared__ float scratch[kPairs][kThreads];  // one packed matrix a thread, for the permutations
  const long long m = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= matrices) return;
  const int band = static_cast<int>(m % nb);

  // 1-2. shrinkage and guard, once a matrix
  float s[kPairs];
  float trace;
  const bool ok = shrink_and_guard(grams + m * kPairs, __ldg(tr_scaled + m), wwt + band * kPairs,
                                   prm.guard, s, trace);
  flags[m] = ok ? 0 : 1;

  // 3. trace-normalised rational matrix log through the tridiagonal form,
  // in the basis whose diagonal ascends (perm[i] is the channel at row i)
  const float tr2 = __fdiv_rn(trace, static_cast<float>(kC));
  const float inv_tr = __fdiv_rn(1.0f, tr2);
  float* slot = scratch[0] + threadIdx.x;  // this thread's 36 words, stride kThreads
#pragma unroll
  for (int q = 0; q < kPairs; ++q) slot[q * kThreads] = s[q] * inv_tr;  // A
  int perm[kC];
  float hv[kC - 2][kC], hb[kC - 2], d[kC], e[kC - 1], e2[kC - 1];
  {
    double a[kPairs], d64[kC], e64[kC - 1];
    nsd::load_permuted<kThreads>(slot, perm, a);
    nsd::tridiagonalize(a, hv, hb, d64, e64);
#pragma unroll
    for (int i = 0; i < kC; ++i) d[i] = static_cast<float>(d64[i]);
#pragma unroll
    for (int i = 0; i < kC - 1; ++i) e[i] = static_cast<float>(e64[i]);
  }
#pragma unroll
  for (int i = 0; i < kC - 1; ++i) e2[i] = e[i] * e[i];
  float r[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) r[q] = 0.0f;
  for (int t = 0; t < prm.terms; ++t) add_shifted_inverse(d, e, e2, prm.poles[t], prm.weights[t], r);
  nsd::back_transform(hv, hb, r);
  nsd::store_permuted<kThreads>(slot, perm, r);

  // 4. features
  write_features(slot, prm.c0, logf(tr2), feats + m * kPairs);
}

__global__ void __launch_bounds__(kThreads)
logcov_feats_cheb_kernel(const float* __restrict__ grams, const float* __restrict__ tr_scaled,
                         const float* __restrict__ wwt, float* __restrict__ feats,
                         unsigned char* __restrict__ flags, long long matrices, int nb,
                         ChebParams prm, const float* __restrict__ coeffs) {
  __shared__ float scratch[kPairs][kThreads];  // one packed matrix a thread
  const long long m = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= matrices) return;
  const int band = static_cast<int>(m % nb);

  // 1-2. shrinkage and guard, the rational mode's code
  float s[kPairs];
  float trace;
  const bool ok = shrink_and_guard(grams + m * kPairs, __ldg(tr_scaled + m), wwt + band * kPairs,
                                   prm.guard, s, trace);
  flags[m] = ok ? 0 : 1;

  // 3. the series of the trace-normalised A mapped onto the domain, through
  // one float64 eigendecomposition of A
  const float tr2 = __fdiv_rn(trace, static_cast<float>(kC));
  const float inv_tr = __fdiv_rn(1.0f, tr2);
  float* slot = scratch[0] + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kPairs; ++q) slot[q * kThreads] = s[q] * inv_tr;  // A
  nsd::chebyshev_sym8<kThreads>(slot, coeffs, prm.degree, prm.hi_plus_lo, prm.inv_hi_minus_lo);

  // 4. features (c_0 is in the series)
  write_features(slot, 0.0f, logf(tr2), feats + m * kPairs);
}

GuardParams guard_params(double scale, double alpha, double lo, double hi, double guard_g) {
  GuardParams g;
  g.scale = static_cast<float>(scale);
  g.alpha = static_cast<float>(alpha);
  g.one_minus_alpha = static_cast<float>(1.0 - alpha);
  g.lo = static_cast<float>(lo);
  g.hi = static_cast<float>(hi);
  g.guard_g = static_cast<float>(guard_g);
  g.one_minus_g = static_cast<float>(1.0 - guard_g);
  g.mirror = hi < kC ? 1 : 0;
  return g;
}

}  // namespace

extern "C" {

int nsd_logcov_feats_max_terms() { return kMaxTerms; }

int nsd_logcov_feats_max_degree() { return kMaxDegree; }

// grams [batch, nb * 36], tr_scaled [batch, nb], wwt [nb, 36] float32,
// contiguous; feats [batch, nb * 36] float32 and flags [batch, nb] uint8
// out. coeffs: c0, then `terms` poles, then `terms` weights. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
int nsd_logcov_feats(const float* grams, const float* tr_scaled, const float* wwt,
                     float* feats, unsigned char* flags, int batch, int nb,
                     const double* coeffs, int terms, double scale, double alpha,
                     double lo, double hi, double guard_g, void* stream) {
  if (batch <= 0) return 0;
  if (nb < 1 || terms < 1 || terms > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.guard = guard_params(scale, alpha, lo, hi, guard_g);
  prm.c0 = static_cast<float>(coeffs[0]);
  prm.terms = terms;
  for (int t = 0; t < kMaxTerms; ++t) {
    prm.poles[t] = t < terms ? static_cast<float>(coeffs[1 + t]) : 0.0f;
    prm.weights[t] = t < terms ? static_cast<float>(coeffs[1 + terms + t]) : 0.0f;
  }
  const long long matrices = static_cast<long long>(batch) * nb;
  const long long blocks = (matrices + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  logcov_feats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      grams, tr_scaled, wwt, feats, flags, matrices, nb, prm);
  return static_cast<int>(cudaGetLastError());
}

// Chebyshev mode: the same arrays; coeffs [degree + 1] float32 in device
// memory (c_0..c_degree of log on [lo, hi]).
int nsd_logcov_feats_chebyshev(const float* grams, const float* tr_scaled, const float* wwt,
                               float* feats, unsigned char* flags, int batch, int nb,
                               const float* coeffs, int degree, double scale, double alpha,
                               double lo, double hi, double guard_g, void* stream) {
  if (batch <= 0) return 0;
  if (nb < 1 || degree < 0 || degree > kMaxDegree) return static_cast<int>(cudaErrorInvalidValue);
  ChebParams prm;
  prm.guard = guard_params(scale, alpha, lo, hi, guard_g);
  prm.hi_plus_lo = hi + lo;
  prm.inv_hi_minus_lo = 1.0 / (hi - lo);
  prm.degree = degree;
  const long long matrices = static_cast<long long>(batch) * nb;
  const long long blocks = (matrices + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  logcov_feats_cheb_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      grams, tr_scaled, wwt, feats, flags, matrices, nb, prm, coeffs);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
