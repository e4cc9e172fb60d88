// Matrix Clenshaw recurrence on one symmetric 8x8 matrix held by one
// thread, shared by csrc/logm_clenshaw.cu and the Chebyshev mode of
// csrc/logcov_feats.cu.
//
// For a symmetric t and coefficients c_0..c_d (float32, in device memory)
// it evaluates
//   b_k = c_k I + 2 t b_(k+1) - b_(k+2),  k = d..1,  b_(d+1) = b_(d+2) = 0
//   out = c_0 I + t b_1 - b_2
// as the JAX package's Pallas kernels do (ops/pallas/logm.py:39,
// ops/pallas/logmfeats.py:239-275). Every b_k is a polynomial in t, so it
// is symmetric: the thread keeps the 36 upper-triangle entries of t, b1
// and b2 (108 floats in registers) and computes only the upper triangle of
// each product, 288 FMAs a step. b0 overwrites b2 in place (entry (i, j)
// of b0 reads only entry (i, j) of b2), and the loop runs two steps at a
// time so that the roles of the two arrays swap back without a copy.

#pragma once

namespace nsd {

constexpr int kSymC = 8;
constexpr int kSymPairs = kSymC * (kSymC + 1) / 2;  // 36

// (i, j), i <= j -> row-major upper-triangle index
__host__ __device__ constexpr int sym_pidx(int i, int j) {
  return i * kSymC - i * (i - 1) / 2 + (j - i);
}

// either order of (i, j)
__host__ __device__ constexpr int sym_at(int i, int j) {
  return i <= j ? sym_pidx(i, j) : sym_pidx(j, i);
}

// acc(i, j) = (t b)_ij for symmetric t and b
__device__ __forceinline__ float sym_product(const float (&t)[kSymPairs], const float (&b)[kSymPairs],
                                             int i, int j) {
  float acc = t[sym_at(i, 0)] * b[sym_at(0, j)];
#pragma unroll
  for (int l = 1; l < kSymC; ++l) acc = fmaf(t[sym_at(i, l)], b[sym_at(l, j)], acc);
  return acc;
}

// b2 <- ck I + 2 t b1 - b2, upper triangle, in place
__device__ __forceinline__ void clenshaw_step(const float (&t)[kSymPairs], const float (&b1)[kSymPairs],
                                              float (&b2)[kSymPairs], float ck) {
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
#pragma unroll
    for (int j = i; j < kSymC; ++j) {
      const float two_tb = 2.0f * sym_product(t, b1, i, j);
      const int p = sym_pidx(i, j);
      b2[p] = (i == j ? ck + two_tb : two_tb) - b2[p];
    }
  }
}

// out <- c0 I + t b1 - b2, upper triangle
__device__ __forceinline__ void clenshaw_last(const float (&t)[kSymPairs], const float (&b1)[kSymPairs],
                                              const float (&b2)[kSymPairs], float c0,
                                              float (&out)[kSymPairs]) {
#pragma unroll
  for (int i = 0; i < kSymC; ++i) {
#pragma unroll
    for (int j = i; j < kSymC; ++j) {
      const float tb = sym_product(t, b1, i, j);
      const int p = sym_pidx(i, j);
      out[p] = (i == j ? c0 + tb : tb) - b2[p];
    }
  }
}

// sum_k c_k T_k(t), upper triangle of t in, upper triangle out
__device__ __forceinline__ void clenshaw_sym8(const float (&t)[kSymPairs], const float* __restrict__ coeffs,
                                              int degree, float (&out)[kSymPairs]) {
  float b1[kSymPairs], b2[kSymPairs];
#pragma unroll
  for (int p = 0; p < kSymPairs; ++p) {
    b1[p] = 0.0f;
    b2[p] = 0.0f;
  }
  int k = degree;
  for (; k >= 2; k -= 2) {
    clenshaw_step(t, b1, b2, __ldg(coeffs + k));      // b2 = b_k; b1 = b_(k+1)
    clenshaw_step(t, b2, b1, __ldg(coeffs + k - 1));  // b1 = b_(k-1); b2 = b_k
  }
  if (k == 1) {
    clenshaw_step(t, b1, b2, __ldg(coeffs + 1));  // b2 = b_1; b1 = b_2
    clenshaw_last(t, b2, b1, __ldg(coeffs), out);
  } else {
    clenshaw_last(t, b1, b2, __ldg(coeffs), out);
  }
}

}  // namespace nsd
