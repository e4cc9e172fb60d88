// Batched Chebyshev matrix log of symmetric 8x8 matrices (the Clenshaw
// recurrence) for NVIDIA Hopper (sm_90a).
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
// Out: c_0 I + t b_1 - b_2 [M, 8, 8], symmetric (both triangles written).
// t is symmetric for a symmetric input; the kernel reads its upper
// triangle.
//
// Bound on this card (logcov8 at B = 16384: 131072 matrices, degree 320):
// bytes are t read once and the result written once, 256 B each a matrix,
// 67 MB, 0.020 ms at 3.35 TB/s. Operations: the recurrence costs 320
// steps of 288 FMAs (184 kFLOP a matrix, 24 GFLOP, 0.36 ms at 67 TFLOP/s),
// but that is the design's choice, not the floor: the least work for the
// same polynomial of a symmetric matrix is an eigendecomposition (about
// 9 C^3 by the symmetric QR algorithm), the scalar Clenshaw at C
// eigenvalues (3 d C) and V f(L) V^T (2 C^3), about 13.3 kFLOP a matrix,
// 1.75 GFLOP, 0.026 ms. So the function is bound by operations at about
// 0.026 ms (chip_smoke.py computes the bound from the run's shapes).
//
// Design (simple and right first; see PERF.md for its time): one thread a
// matrix, the 36 upper-triangle entries of t, b1 and b2 in registers
// (clenshaw_sym8.cuh), coefficients read through the read-only cache (every
// thread reads the same one at the same step). No shuffles, no shared
// memory; the recurrence is 36 independent FMA chains of 8 a step, enough
// instruction-level parallelism to keep the FMA pipes busy.

#include <cuda_runtime.h>

#include "clenshaw_sym8.cuh"

namespace {

constexpr int kC = nsd::kSymC;
constexpr int kThreads = 128;
constexpr int kMaxDegree = 4096;

__global__ void __launch_bounds__(kThreads)
logm_clenshaw_kernel(const float* __restrict__ t, float* __restrict__ out, long long matrices,
                     const float* __restrict__ coeffs, int degree) {
  const long long m = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= matrices) return;
  const float* tm = t + m * kC * kC;
  float ts[nsd::kSymPairs];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
#pragma unroll
    for (int j = i; j < kC; ++j) ts[nsd::sym_pidx(i, j)] = __ldg(tm + i * kC + j);
  }
  float res[nsd::kSymPairs];
  nsd::clenshaw_sym8(ts, coeffs, degree, res);
  float* om = out + m * kC * kC;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
#pragma unroll
    for (int j = 0; j < kC; ++j) om[i * kC + j] = res[nsd::sym_at(i, j)];
  }
}

}  // namespace

extern "C" {

int nsd_logm_clenshaw_max_degree() { return kMaxDegree; }

// t [matrices, 8, 8] float32 contiguous; out [matrices, 8, 8] float32;
// coeffs [degree + 1] float32 in device memory. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
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
