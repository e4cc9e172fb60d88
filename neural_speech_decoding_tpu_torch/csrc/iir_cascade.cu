// Zero-phase IIR cascade (the collector's biquads, forward then
// time-reversed) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   neural_speech_decoding_tpu/ops/pallas/iir.py:38 _cascade_kernel
//   (grid call _cascade_pass:80-126, wrapper fused_preprocess:133-171).
// Python wrapper and plain twin:
//   neural_speech_decoding_tpu_torch/ops/kernels/iir.py
//
// In: x [B, T, C] float32 (already detrended by the wrapper, as the JAX
// wrapper leaves the detrend and the z-score to XLA) and S second-order
// sections (b0, b1, b2, a1, a2; a0 = 1) in float32. Out: [B, T, C], every
// (window, channel) series run through all S sections in transposed
// direct form II, in the JAX kernel's order,
//   out = b0 y + z0;  z0 = b1 y - a1 out + z1;  z1 = b2 y - a2 out,
// forward over T from a zero state, then time-reversed from a zero state.
// One launch does both passes (the TPU does two pallas_calls).
//
// Bound on this card (B = 16384, T = 625, C = 8, the collector's 14
// sections): bytes are x read once and the result written once, 655 MB,
// 0.196 ms at 3.35 TB/s. Operations: 9 a section and sample (3 products
// and 2 sums for out and z0 in FMAs, 2 for z1) in each direction, 252 a
// sample, 20.6 GFLOP, 0.31 ms at 67 TFLOP/s. So operations bind it.
//
// Design (simple and right first; see PERF.md for its time): one thread a
// series, all sections' state (2 S floats) in registers, the coefficients
// in the kernel's parameter space (read by every thread at the same step:
// a constant-cache broadcast). A warp holds 4 windows x 8 channels, so each
// time step reads and writes 4 full 32-byte sectors. Samples go through in
// chunks of kChunk: the chunk's loads are issued together before its
// recurrence, so each thread keeps several loads in flight. The forward
// pass writes its output, and the reverse pass reads it back in place (the
// same thread, the same addresses). The recurrence is serial in time, so
// the parallelism is the B * C series: 131072 threads at B = 16384, 8192 at
// B = 1024.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSections = 32;
constexpr int kChunk = 8;

struct Sos {
  int sections;
  float b0[kMaxSections], b1[kMaxSections], b2[kMaxSections];
  float a1[kMaxSections], a2[kMaxSections];
};

struct State {
  float z0[kMaxSections], z1[kMaxSections];
};

__device__ __forceinline__ float cascade_sample(float y, State& st, const Sos& sos) {
#pragma unroll
  for (int s = 0; s < kMaxSections; ++s) {
    if (s < sos.sections) {
      const float out = sos.b0[s] * y + st.z0[s];
      st.z0[s] = sos.b1[s] * y - sos.a1[s] * out + st.z1[s];
      st.z1[s] = sos.b2[s] * y - sos.a2[s] * out;
      y = out;
    }
  }
  return y;
}

// One causal pass over a series of t_len samples `stride` floats apart;
// kReverse walks it from the end. src and dst may be the same series.
template <bool kReverse>
__device__ __forceinline__ void cascade_pass(const float* src, float* dst, int t_len, int stride,
                                             const Sos& sos) {
  State st;
#pragma unroll
  for (int s = 0; s < kMaxSections; ++s) {
    st.z0[s] = 0.0f;
    st.z1[s] = 0.0f;
  }
  int i = 0;
  for (; i + kChunk <= t_len; i += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const long long idx = kReverse ? t_len - 1 - (i + u) : i + u;
      v[u] = src[idx * stride];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) v[u] = cascade_sample(v[u], st, sos);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const long long idx = kReverse ? t_len - 1 - (i + u) : i + u;
      dst[idx * stride] = v[u];
    }
  }
  for (; i < t_len; ++i) {
    const long long idx = kReverse ? t_len - 1 - i : i;
    dst[idx * stride] = cascade_sample(src[idx * stride], st, sos);
  }
}

__global__ void __launch_bounds__(kThreads)
iir_cascade_kernel(const float* x, float* out, long long series, int t_len, int channels, Sos sos) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= series) return;
  const long long base = (n / channels) * t_len * channels + n % channels;
  cascade_pass<false>(x + base, out + base, t_len, channels, sos);
  cascade_pass<true>(out + base, out + base, t_len, channels, sos);
}

}  // namespace

extern "C" {

int nsd_iir_cascade_max_sections() { return kMaxSections; }

// x, out [batch, t_len, channels] float32 contiguous (not overlapping);
// sos [sections, 6] float64 rows (b0, b1, b2, a0, a1, a2), rounded to
// float32 here (a0 is taken as 1). Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
int nsd_iir_cascade(const float* x, float* out, int batch, int t_len, int channels,
                    const double* sos, int sections, void* stream) {
  if (batch <= 0 || t_len <= 0 || channels <= 0) return 0;
  if (sections < 0 || sections > kMaxSections) return static_cast<int>(cudaErrorInvalidValue);
  Sos prm;
  prm.sections = sections;
  for (int s = 0; s < kMaxSections; ++s) {
    const bool on = s < sections;
    prm.b0[s] = on ? static_cast<float>(sos[6 * s + 0]) : 0.0f;
    prm.b1[s] = on ? static_cast<float>(sos[6 * s + 1]) : 0.0f;
    prm.b2[s] = on ? static_cast<float>(sos[6 * s + 2]) : 0.0f;
    prm.a1[s] = on ? static_cast<float>(sos[6 * s + 4]) : 0.0f;
    prm.a2[s] = on ? static_cast<float>(sos[6 * s + 5]) : 0.0f;
  }
  const long long series = static_cast<long long>(batch) * channels;
  const long long blocks = (series + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  iir_cascade_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, series, t_len, channels, prm);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
