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
//                 out = c0 I + sum_j v_j (A - p_j I)^{-1}, each inverse by
//                 pivot-free Gauss-Jordan: r = 1 / m_ii, pivot row m_i r,
//                 every row k updated by g_k = m_ki - delta_ki (the uniform
//                 rank-1 form); poles accumulated in order
//   4. features   out_ii + log(tr / C) on the diagonal, sqrt(2) out_ij off
//                 it, upper triangle row-major: feats[b, k * 36 + p]
// and flags[b, k] = 1 where the guard fired. Steps 1 and 2 use explicitly
// rounded operations (__fmul_rn and the like, never contracted into an
// FMA) in the order of the plain twin, so the guard decides exactly as the
// twin does; step 3 lets the compiler form FMAs.
//
// Chebyshev mode: steps 1, 2 and 4 are the same code; step 3 builds, as the
// JAX kernel does, a_ij = s_ij * (1 / (tr / C)), t_ii = (2 a_ii - (hi + lo))
// / (hi - lo), t_ij = 2 a_ij / (hi - lo), and runs the matrix Clenshaw
// recurrence over the degree + 1 coefficients in device memory
// (clenshaw_sym8.cuh): out = c_0 I + t b_1 - b_2. One thread owns one
// matrix there (the upper triangles of t, b1 and b2 in registers), since
// every step needs every entry of b1; the 8-lanes-a-matrix layout of the
// rational mode would broadcast all of b1 at each of the 320 steps.
// Bound (B = 16384, degree 320): the same 38.4 MB, 0.0115 ms; the least
// work is an eigendecomposition (about 9 C^3), the scalar series at C
// eigenvalues (3 d C), V f(L) V^T (2 C^3) and the guard, about 13.7 kFLOP
// a matrix, 1.8 GFLOP, 0.027 ms: bound by operations. The recurrence
// itself does 184 kFLOP a matrix.
//
// Bound on this card (logcov8, B = 16384, 131072 matrices): bytes are the
// gram pairs read once and the features written once, 18.9 MB each, plus
// the traces and flags (0.5 + 0.13 MB): about 38.4 MB, 0.0115 ms at
// 3.35 TB/s. Operations: this kernel's Gauss-Jordan costs about 29 kFLOP a
// matrix (3.8 GFLOP, 0.057 ms at 67 TFLOP/s), but that is the design's
// choice, not the floor. The least work for the same function is about
// 4.5 kFLOP a matrix: a Householder tridiagonal reduction (4/3 C^3), 12
// shifted tridiagonal inverses (3 C^2 each), the back-transformation
// (2 C^3), the Cholesky guard (C^3 / 3) and the elementwise steps,
// 0.59 GFLOP, 0.009 ms. So the function is bound by bytes, at about
// 0.0115 ms (chip_smoke.py computes the bound from the run's shapes).
//
// Design (simple and right first; see PERF.md for its time):
//   * 8 lanes per matrix, 4 matrices per warp, 16 per block; lane i owns
//     row i of the shifted matrix m, of its inverse and of the output, so
//     a thread holds about 40 floats of Gauss-Jordan state instead of the
//     190 a one-thread-per-matrix design would spill;
//   * each pivot row (m_i and inv_i, 16 floats) is broadcast from lane i
//     to its 7 neighbours with __shfl_sync over an 8-lane segment;
//   * the shrinkage and the guard are cheap (about 300 operations), so
//     every lane of a matrix computes them redundantly from the 36 pairs
//     in registers and keeps the row it owns; lane 0 writes the flag;
//   * the 36 pairs of a matrix are read by its 8 lanes from the same
//     addresses (one transaction each), and the lanes write the 36
//     features of their upper-triangle rows.
// No fast-math: the guard and the pivots rely on IEEE division and sqrt.

#include <cuda_runtime.h>

#include "clenshaw_sym8.cuh"

namespace {

constexpr int kC = 8;                       // channels (the wrapper checks)
constexpr int kPairs = kC * (kC + 1) / 2;   // 36
constexpr int kMaxTerms = 32;               // resolvent poles
constexpr int kMaxDegree = 4096;            // Chebyshev degree
constexpr int kThreads = 128;               // 16 matrices of 8 lanes (rational)
constexpr int kChebThreads = 128;           // 128 matrices (Chebyshev)
constexpr unsigned kFullMask = 0xffffffffu;
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
  float hi_plus_lo;       // float32(hi + lo), as the JAX kernel's constant
  float hi_minus_lo;      // float32(hi - lo)
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

__global__ void __launch_bounds__(kThreads)
logcov_feats_kernel(const float* __restrict__ grams, const float* __restrict__ tr_scaled,
                    const float* __restrict__ wwt, float* __restrict__ feats,
                    unsigned char* __restrict__ flags, long long matrices, int nb,
                    Params prm) {
  const int row = threadIdx.x & 7;
  const long long mat = static_cast<long long>(blockIdx.x) * (kThreads / 8) + (threadIdx.x >> 3);
  // Every lane takes part in the shuffles; a group past the end computes
  // on the last matrix and writes nothing.
  const bool active = mat < matrices;
  const long long m_idx = active ? mat : matrices - 1;
  const int band = static_cast<int>(m_idx % nb);

  // 1-2. shrinkage and guard, redundantly in every lane of the matrix
  float s[kPairs];
  float trace;
  const bool ok = shrink_and_guard(grams + m_idx * kPairs, __ldg(tr_scaled + m_idx),
                                   wwt + band * kPairs, prm.guard, s, trace);
  if (active && row == 0) flags[m_idx] = ok ? 0 : 1;

  // 3. trace-normalised rational matrix log; this lane owns row `row`
  const float tr2 = __fdiv_rn(trace, static_cast<float>(kC));
  const float inv_tr = __fdiv_rn(1.0f, tr2);
  float a_row[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      if (row == i) v = s[pidx(min(i, j), max(i, j))];  // a select, no local memory
    }
    a_row[j] = v * inv_tr;
  }
  float out_row[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) out_row[j] = (j == row) ? prm.c0 : 0.0f;

  for (int t = 0; t < prm.terms; ++t) {
    const float p = prm.poles[t];
    float m_row[kC], inv_row[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      m_row[j] = (j == row) ? a_row[j] - p : a_row[j];
      inv_row[j] = (j == row) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      float mi[kC], vi[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        mi[j] = __shfl_sync(kFullMask, m_row[j], i, 8);
        vi[j] = __shfl_sync(kFullMask, inv_row[j], i, 8);
      }
      const float r = __fdiv_rn(1.0f, mi[i]);
      const float gk = m_row[i] - (row == i ? 1.0f : 0.0f);
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        m_row[j] = m_row[j] - gk * (mi[j] * r);
        inv_row[j] = inv_row[j] - gk * (vi[j] * r);
      }
    }
    const float v = prm.weights[t];
#pragma unroll
    for (int j = 0; j < kC; ++j) out_row[j] = out_row[j] + v * inv_row[j];
  }

  // 4. log(tr/C) on the diagonal, sqrt(2) off it, upper-triangle rows
  if (!active) return;
  const float logtr = logf(tr2);
  float* f = feats + m_idx * kPairs;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (j == row) f[pidx(row, j)] = out_row[j] + logtr;
    if (j > row) f[pidx(row, j)] = out_row[j] * kSqrt2;
  }
}

__global__ void __launch_bounds__(kChebThreads)
logcov_feats_cheb_kernel(const float* __restrict__ grams, const float* __restrict__ tr_scaled,
                         const float* __restrict__ wwt, float* __restrict__ feats,
                         unsigned char* __restrict__ flags, long long matrices, int nb,
                         ChebParams prm, const float* __restrict__ coeffs) {
  const long long m = static_cast<long long>(blockIdx.x) * kChebThreads + threadIdx.x;
  if (m >= matrices) return;
  const int band = static_cast<int>(m % nb);

  // 1-2. shrinkage and guard, the rational mode's code
  float s[kPairs];
  float trace;
  const bool ok = shrink_and_guard(grams + m * kPairs, __ldg(tr_scaled + m), wwt + band * kPairs,
                                   prm.guard, s, trace);
  flags[m] = ok ? 0 : 1;

  // 3. trace-normalised, mapped onto the Chebyshev domain, Clenshaw
  const float tr2 = __fdiv_rn(trace, static_cast<float>(kC));
  const float inv_tr = __fdiv_rn(1.0f, tr2);
  float t[kPairs];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
#pragma unroll
    for (int j = i; j < kC; ++j) {
      const float a2 = 2.0f * (s[pidx(i, j)] * inv_tr);
      t[pidx(i, j)] = (i == j ? a2 - prm.hi_plus_lo : a2) / prm.hi_minus_lo;
    }
  }
  float out[kPairs];
  nsd::clenshaw_sym8(t, coeffs, prm.degree, out);

  // 4. log(tr/C) on the diagonal, sqrt(2) off it
  const float logtr = logf(tr2);
  float* f = feats + m * kPairs;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
#pragma unroll
    for (int j = i; j < kC; ++j) {
      const int p = pidx(i, j);
      f[p] = i == j ? out[p] + logtr : out[p] * kSqrt2;
    }
  }
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
  const long long blocks = (matrices + kThreads / 8 - 1) / (kThreads / 8);
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
  prm.hi_plus_lo = static_cast<float>(hi + lo);
  prm.hi_minus_lo = static_cast<float>(hi - lo);
  prm.degree = degree;
  const long long matrices = static_cast<long long>(batch) * nb;
  const long long blocks = (matrices + kChebThreads - 1) / kChebThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  logcov_feats_cheb_kernel<<<static_cast<unsigned>(blocks), kChebThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      grams, tr_scaled, wwt, feats, flags, matrices, nb, prm, coeffs);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
