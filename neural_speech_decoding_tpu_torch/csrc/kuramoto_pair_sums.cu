// Fused Hilbert transform + Kuramoto pair sums for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   neural_speech_decoding_tpu/ops/pallas/kuramoto.py:60 _pair_sums_kernel
//   (grid call _pair_sums_batched:98, wrapper kuramoto_pair_sums:120).
// Python wrapper and plain twin:
//   neural_speech_decoding_tpu_torch/ops/kernels/kuramoto.py
//
// For each raw window x [T, 8] (float32, batch b):
//   im[t, c] = sum_k H[t, k] x[k, c]         dense [T, T] Hilbert operator
//   p2 = x^2 + im^2
//   c2 = (x^2 - im^2) / p2,  s2 = 2 x im / p2, and c2 = 1, s2 = 0 where
//        p2 < FLT_MIN (an all-zero channel: np.angle(0) == 0)
//   G[b, i, j] = sum_t c2_i c2_j + s2_i s2_j  for the 36 pairs i <= j,
//        written to both halves of out [B, 8, 8].
//
// Bound on this card: the Hilbert step is a linear map that an FFT does
// in O(T log T), about 0.24 MFLOP per window with c2/s2 and the pair sums
// 0.38 MFLOP (6.2e9 FLOP at B = 16384, about 0.09 ms at the H100 SXM's
// 67 TFLOP/s float32). Reading x is 20 KB per window (328 MB at
// B = 16384, about 0.1 ms at 3.35 TB/s). So the function is bound by
// bytes, at about 0.1 ms (chip_smoke.py computes it). This kernel, like
// the TPU kernel, does the Hilbert step as the dense [T, T] product
// instead: 2 T^2 C = 6.25 MFLOP per window, about 1.5 ms at B = 16384.
// That is the design's choice, not the floor.
// The products stay in full float32 FMA: TF32 keeps about three decimal
// digits, and the filter's ridge solve amplifies gram errors into the
// logits (the JAX package records 3e-1 of filter error from a bf16 gram).
//
// Design (a simple kernel that is right; see PERF.md for its time):
//   * one block holds kWin windows; x goes into shared memory
//     (T * 8 * 4 = 20 KB per window), loaded once from device memory;
//   * each thread owns rows t = tid, tid + 256, ... and computes im for
//     all kWin windows at once, so each H element it reads (H^T, row k,
//     coalesced across the threads of a warp; 1.56 MB, resident in L2)
//     feeds kWin * 8 FMAs; x is read from shared memory as a broadcast;
//   * c2/s2 of its rows stay in registers and feed 36 per-thread partial
//     pair sums per window;
//   * the partials are reduced by a tree: warp shuffles, then across the
//     warps through shared memory. All sums are float32; the tree keeps
//     the rounding error near log2(T) ulps instead of the T ulps of one
//     running sum.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8;                       // channels (the wrapper checks)
constexpr int kPairs = kC * (kC + 1) / 2;   // 36
constexpr int kWin = 2;                     // windows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;       // opt-in shared memory per block
constexpr int kRedBytes = kWarps * kWin * kPairs * sizeof(float);

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

__global__ void __launch_bounds__(kThreads, 2)
pair_sums_kernel(const float* __restrict__ x, const float* __restrict__ ht,
                 float* __restrict__ out, int batch, int t_len) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kWin][t_len][kC]
  __shared__ float red[kWarps][kWin * kPairs];

  const int b0 = blockIdx.x * kWin;
  const int n = t_len * kC;
  for (int w = 0; w < kWin; ++w) {
    const bool valid = b0 + w < batch;
    const float* src = x + static_cast<size_t>(b0 + w) * n;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      xs[w * n + i] = valid ? src[i] : 0.0f;  // padding slot: all zero
    }
  }
  __syncthreads();

  float pacc[kWin][kPairs];
#pragma unroll
  for (int w = 0; w < kWin; ++w) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) pacc[w][p] = 0.0f;
  }

  for (int t = threadIdx.x; t < t_len; t += kThreads) {
    float im[kWin][kC];
#pragma unroll
    for (int w = 0; w < kWin; ++w) {
#pragma unroll
      for (int c = 0; c < kC; ++c) im[w][c] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < t_len; ++k) {
      const float h = __ldg(ht + static_cast<size_t>(k) * t_len + t);  // H[t, k]
#pragma unroll
      for (int w = 0; w < kWin; ++w) {
        const float4 lo = smem4[(w * t_len + k) * 2];
        const float4 hi = smem4[(w * t_len + k) * 2 + 1];
        im[w][0] = fmaf(h, lo.x, im[w][0]);
        im[w][1] = fmaf(h, lo.y, im[w][1]);
        im[w][2] = fmaf(h, lo.z, im[w][2]);
        im[w][3] = fmaf(h, lo.w, im[w][3]);
        im[w][4] = fmaf(h, hi.x, im[w][4]);
        im[w][5] = fmaf(h, hi.y, im[w][5]);
        im[w][6] = fmaf(h, hi.z, im[w][6]);
        im[w][7] = fmaf(h, hi.w, im[w][7]);
      }
    }
#pragma unroll
    for (int w = 0; w < kWin; ++w) {
      float c2[kC], s2[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float re = xs[(w * t_len + t) * kC + c];
        const float re2 = re * re;
        const float im2 = im[w][c] * im[w][c];
        const float p2 = re2 + im2;
        const bool degenerate = p2 < 1.17549435e-38f;  // FLT_MIN
        const float inv = 1.0f / (degenerate ? 1.0f : p2);
        c2[c] = degenerate ? 1.0f : (re2 - im2) * inv;
        s2[c] = degenerate ? 0.0f : (2.0f * re * im[w][c]) * inv;
      }
      int p = 0;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
#pragma unroll
        for (int j = i; j < kC; ++j) {
          pacc[w][p] += c2[i] * c2[j] + s2[i] * s2[j];
          ++p;
        }
      }
    }
  }

  // Tree reduction of the per-thread partials: lanes, then warps.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < kWin; ++w) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      float v = pacc[w][p];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][w * kPairs + p] = v;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kWin * kPairs; idx += kThreads) {
    float v[kWarps];
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v[q] = red[q][idx];
#pragma unroll
    for (int s = kWarps / 2; s > 0; s >>= 1) {
#pragma unroll
      for (int q = 0; q < s; ++q) v[q] += v[q + s];
    }
    const int w = idx / kPairs;
    const int b = b0 + w;
    if (b < batch) {
      int i, j;
      pair_of(idx - w * kPairs, i, j);
      float* g = out + static_cast<size_t>(b) * kC * kC;
      g[i * kC + j] = v[0];
      g[j * kC + i] = v[0];
    }
  }
}

}  // namespace

extern "C" {

// Largest window length whose kWin windows fit in one block's shared
// memory beside the reduction buffer.
int nsd_kuramoto_pair_sums_max_t() {
  return static_cast<int>((kMaxSmemBytes - kRedBytes) / (kWin * kC * sizeof(float)));
}

// x [batch, t_len, 8], ht = H^T [t_len, t_len], out [batch, 8, 8]; all
// float32, contiguous, on the current device. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
int nsd_kuramoto_pair_sums(const float* x, const float* ht, float* out,
                           int batch, int t_len, void* stream) {
  if (batch <= 0) return 0;
  if (t_len <= 0 || t_len > nsd_kuramoto_pair_sums_max_t()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kWin) * t_len * kC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pair_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kWin - 1) / kWin;
  pair_sums_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, ht, out, batch, t_len);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
