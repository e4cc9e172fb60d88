// Per-band spatial gram pairs for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   neural_speech_decoding_tpu/ops/pallas/bandcov.py:35 _gram_kernel
//   (grid call _grams_batched:69, wrapper band_grams:113).
// Python wrapper and plain twin:
//   neural_speech_decoding_tpu_torch/ops/kernels/bandcov.py
//
// For each window b of whitened projection rows y [R, 8] (float32) and
// bands given by row offsets o_0 <= o_1 <= ... <= o_nb:
//   out[b, k * 36 + p] = sum_{o_k <= r < o_(k+1)} y[r, c] * y[r, d]
// for the 36 channel pairs p = (c, d), c <= d, row-major. Unscaled.
// The TPU kernel puts the batch on lanes ([C, R, B] in, [nb * 36, B]
// out); here each window's output stays contiguous, [B, nb * 36], which
// is the layout the feature kernel (logcov_feats.cu) reads.
//
// Bound on this card (logcov8: R = 450, nb = 8; B = 16384): the rows are
// read once, 14.4 KB a window (236 MB), and 1.15 KB of pairs written a
// window (19 MB): 255 MB at 3.35 TB/s, about 0.076 ms. The products are
// 2 * 36 * R = 32.4 kFLOP a window (0.53 GFLOP, about 0.008 ms at the
// 67 TFLOP/s float32 peak). So the function is bound by bytes.
// (chip_smoke.py computes the bound from the run's shapes.)
//
// Design (simple and right first; see PERF.md for its time):
//   * one block per window: its R x 8 rows go into shared memory with
//     16-byte loads, so the device-memory read is one coalesced pass;
//   * one thread per (band, pair) output, nb * 36 threads (288 for
//     logcov8), each sums its band's rows (at most 180 for the shipped
//     configurations) from shared memory. The threads of a warp read the
//     same row, so the loads are broadcasts;
//   * four independent float32 FMA chains per thread, added pairwise at
//     the end: this hides the FMA latency, and keeps the rounding error of
//     a 180-term sum near that of 45-term running sums. No TF32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 8;                       // channels (the wrapper checks)
constexpr int kPairs = kC * (kC + 1) / 2;   // 36
constexpr int kMaxBands = 16;
constexpr int kMaxSmemBytes = 232448;       // opt-in shared memory per block

struct Bands {
  int off[kMaxBands + 1];
};

__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  // p enumerates (i, j), i <= j, row by row: (0,0) (0,1) .. (0,7) (1,1) ..
  i = 0;
  int row_len = kC;
  while (p >= row_len) {
    p -= row_len;
    ++i;
    --row_len;
  }
  j = i + p;
}

__global__ void band_grams_kernel(const float* __restrict__ y, float* __restrict__ out,
                                  int rows, int nb, Bands bands) {
  extern __shared__ float4 ys4[];  // [rows][kC] floats, as float4 pairs
  const float* ys = reinterpret_cast<const float*>(ys4);

  const size_t b = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(y + b * rows * kC);
  const int n4 = rows * (kC / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) ys4[i] = __ldg(src + i);
  __syncthreads();

  const int outputs = nb * kPairs;
  for (int o = threadIdx.x; o < outputs; o += blockDim.x) {
    const int k = o / kPairs;
    int c, d;
    pair_of(o - k * kPairs, c, d);
    const int r1 = bands.off[k + 1];
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int r = bands.off[k];
    for (; r + 4 <= r1; r += 4) {
      const float* q = ys + r * kC;
      a0 = fmaf(q[c], q[d], a0);
      a1 = fmaf(q[kC + c], q[kC + d], a1);
      a2 = fmaf(q[2 * kC + c], q[2 * kC + d], a2);
      a3 = fmaf(q[3 * kC + c], q[3 * kC + d], a3);
    }
    for (; r < r1; ++r) a0 = fmaf(ys[r * kC + c], ys[r * kC + d], a0);
    out[b * outputs + o] = (a0 + a1) + (a2 + a3);
  }
}

}  // namespace

extern "C" {

// Most rows a window may have: its rows fill one block's shared memory.
int nsd_band_grams_max_rows() {
  return static_cast<int>(kMaxSmemBytes / (kC * sizeof(float)));
}

// y [batch, rows, 8] float32, contiguous, 16-byte aligned; out
// [batch, nb * 36] float32; offsets: nb + 1 row offsets, non-decreasing,
// within [0, rows]. Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
int nsd_band_grams(const float* y, float* out, int batch, int rows,
                   const int* offsets, int nb, void* stream) {
  if (batch <= 0) return 0;
  if (nb < 1 || nb > kMaxBands || rows < 1 || rows > nsd_band_grams_max_rows() ||
      reinterpret_cast<std::uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bands bands;
  for (int k = 0; k <= nb; ++k) {
    bands.off[k] = offsets[k];
    if (offsets[k] < 0 || offsets[k] > rows || (k > 0 && offsets[k] < offsets[k - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int k = nb + 1; k <= kMaxBands; ++k) bands.off[k] = rows;
  const size_t smem = static_cast<size_t>(rows) * kC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      band_grams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = nb * kPairs;
  const int threads = ((outputs + 31) / 32) * 32;  // at most 576 for 16 bands
  band_grams_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, out, rows, nb, bands);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
