// Batched Chebyshev matrix log of symmetric 8x8 matrices (the series
// through one float64 eigendecomposition a matrix) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   neural_speech_decoding_tpu/ops/pallas/logm.py:39 _clenshaw_kernel
//   (grid call _clenshaw_batched:77-95, wrapper logm_spd_chebyshev_pallas:139
//   / _logm_pallas_impl:149-181).
// Python wrapper and plain twin:
//   neural_speech_decoding_tpu_torch/ops/kernels/logm.py
//
// In: t [M, 8, 8] float32, the trace-normalised matrices already mapped
// onto the Chebyshev domain, t = (2 A - (hi + lo) I) / (hi - lo) (the
// wrapper does that and adds log(tr / C) I afterwards, as the JAX wrapper
// leaves both to XLA), and the degree + 1 coefficients in device memory.
// Out: sum_k c_k T_k(t) [M, 8, 8], the JAX kernel's c_0 I + t b_1 - b_2,
// symmetric (both triangles written).
// t is symmetric for a symmetric input; the kernel reads its upper
// triangle.
//
// Bound on this card (logcov8 at B = 16384: 131072 matrices, degree 320):
// bytes are t read once and the result written once, 256 B each a matrix,
// 67 MB, 0.020 ms at 3.35 TB/s. Operations: the least work for the
// polynomial of a symmetric matrix is an eigendecomposition (about 9 C^3
// by the symmetric QR algorithm), the scalar Clenshaw at C eigenvalues
// (3 d C) and V f(L) V^T (2 C^3), about 13.3 kFLOP a matrix, 1.75 GFLOP,
// 0.026 ms at the float32 rate. So the function is bound by operations at
// about 0.026 ms (chip_smoke.py computes the bound from the run's shapes).
//
// Design: that route, one thread a matrix, 32-thread blocks (so the 8192
// matrices of B = 1024 spread over 256 blocks), in sym8_eigen.cuh: t's
// upper triangle into the thread's slot of shared memory, its channels in
// ascending order of the diagonal, the Householder tridiagonal form and
// its implicit-shift QL iteration in float64 (Z in float32), the scalar
// Clenshaw recurrence at the eigenvalues in float64, r = Z diag(p) Z^T,
// the back-transformation and the inverse permutation; both triangles go
// out from the one packed result, so it is exactly symmetric. A NaN or Inf
// matrix ends after at most 30 QL sweeps an eigenvalue, with a non-finite
// result in its own place only. Latency-bound, as the feature kernel's
// Chebyshev mode (csrc/logcov_feats.cu).

#include <cuda_runtime.h>

#include "sym8_eigen.cuh"

namespace {

constexpr int kC = nsd::kSymC;
constexpr int kThreads = 32;
constexpr int kMaxDegree = 4096;

__global__ void __launch_bounds__(kThreads)
logm_clenshaw_kernel(const float* __restrict__ t, float* __restrict__ out, long long matrices,
                     const float* __restrict__ coeffs, int degree) {
  __shared__ float scratch[nsd::kSymPairs][kThreads];  // one packed matrix a thread
  const long long m = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= matrices) return;
  const float* tm = t + m * kC * kC;
  float* slot = scratch[0] + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
#pragma unroll
    for (int j = i; j < kC; ++j) slot[nsd::sym_pidx(i, j) * kThreads] = __ldg(tm + i * kC + j);
  }
  // t is already on the domain: X = (2 t - 0) * 0.5 = t exactly
  nsd::chebyshev_sym8<kThreads>(slot, coeffs, degree, 0.0, 0.5);
  float4* om = reinterpret_cast<float4*>(out + m * kC * kC);  // 256-byte rows of a fresh tensor: aligned
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    float row[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) row[j] = slot[nsd::sym_at(i, j) * kThreads];
    om[2 * i] = make_float4(row[0], row[1], row[2], row[3]);
    om[2 * i + 1] = make_float4(row[4], row[5], row[6], row[7]);
  }
}

}  // namespace

extern "C" {

int nsd_logm_clenshaw_max_degree() { return kMaxDegree; }

// t [matrices, 8, 8] float32 contiguous; out [matrices, 8, 8] float32,
// 16-byte aligned; coeffs [degree + 1] float32 in device memory. Launches
// on `stream` and returns the cudaError_t of the launch (0 on success).
int nsd_logm_clenshaw(const float* t, float* out, long long matrices, const float* coeffs,
                      int degree, void* stream) {
  if (matrices <= 0) return 0;
  if (degree < 0 || degree > kMaxDegree) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (matrices + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  logm_clenshaw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(t, out, matrices, coeffs, degree);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
