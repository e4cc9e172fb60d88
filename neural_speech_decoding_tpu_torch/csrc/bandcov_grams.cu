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
// out) and sums in float32 on the MXU; here each window's output stays
// contiguous, [B, nb * 36], which is the layout the feature kernel
// (logcov_feats.cu) reads.
//
// Bound on this card (logcov8: R = 450, nb = 8; B = 16384): the rows are
// read once, 14.4 KB a window (236 MB), and 1.15 KB of pairs written a
// window (19 MB): 255 MB at 3.35 TB/s, about 0.076 ms. The products are
// 2 * 36 * R = 32.4 kFLOP a window (0.53 GFLOP, about 0.008 ms at the
// 67 TFLOP/s float32 peak). So the function is bound by bytes, and the
// kernel should be one streaming read of the rows.
// (chip_smoke.py computes the bound from the run's shapes.)
//
// Design: float64 tensor cores on exact products.
//   * One warp a (window, band) item, 8 warps a block: at B = 1 the nb
//     bands run side by side, at B = 1024 (8192 warps) the card holds
//     every item at once, at B = 16384 the blocks stream through.
//   * A band is walked 4 rows at a time by one DMMA,
//     mma.sync.m8n8k4.row.col.f64: D[8x8] += Y^T[8x4] * Y[4x8]. In that
//     instruction lane l holds A[l / 4][l % 4] and B[l % 4][l / 4], and
//     for A = Y^T, B = Y both are the one value Y[r0 + l % 4][l / 4]. So
//     each lane loads one float a chunk, and the warp's 32 loads are the
//     chunk's 128 contiguous bytes: one coalesced read, and no row is
//     read twice.
//   * The value is widened to float64. A product of two float32 values
//     is exact in float64, so every pair is a float64 sum of exact
//     products, rounded once to float32 at the band's end: within one
//     float32 rounding (2^-24 of |G|) of the exact gram, which the
//     float32 twin is not (up to n * 2^-24 of max|G| for n rows).
//   * Lanes past the band's last row load 0 (bands of 30 or 50 rows are
//     not multiples of 4), so they add nothing; a chunk wholly past the
//     end is skipped by the whole warp. The order of the sums is fixed:
//     chunks in row order, one accumulator.
//   * The accumulator is D's 2 doubles a lane: lane l holds
//     D[l / 4][2 (l % 4) + i], i = 0, 1, and writes those with
//     l / 4 <= 2 (l % 4) + i to pair p = c (15 - c) / 2 + d.
//   * kUnroll chunks are loaded before their DMMAs run, so that a warp
//     keeps kUnroll 128-byte reads in flight; with 64 warps an SM that
//     is what HBM's rate needs (Little's law: about 18 KB an SM at
//     0.7 us). No shared memory, so no opt-in attribute and no limit
//     from it on R.
//   The work is 114 DMMAs a logcov8 window, about 15 us at B = 16384 at
//   the 67 TFLOP/s float64 tensor rate: far under the bytes bound.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W power limit):
// B = 16384 0.0887 ms a call, 0.0858 ms on the device (89 % of the
// bound); B = 1024 0.016 ms a call, 0.0054 ms on the device (L2 warm);
// B = 1 0.015 ms a call, 0.0022 ms on the device. The first design (a
// block a window staged in shared memory, a thread a (band, pair) output,
// two shared loads an FMA) took 0.1377 ms at B = 16384 and 0.038-0.070 ms
// a call at B = 1024. Loads 2, 4 and 16 deep were 1-10 % slower than 8
// at B = 16384 (tools/torch_band_grams_unroll.py). PERF.md (section 6)
// holds the times of every run.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kC = 8;                       // channels (the wrapper checks)
constexpr int kPairs = kC * (kC + 1) / 2;   // 36
constexpr int kMaxBands = 16;
constexpr int kWarps = 8;                   // warps (items) a block
constexpr int kUnroll = 8;                  // chunks a warp loads ahead
// most rows a window may have (ops/kernels/bandcov.py MAX_ROWS): a band's
// element offsets, rows * 8 plus a few chunks, stay well inside int
constexpr int kMaxRows = 1 << 26;

struct Bands {
  int off[kMaxBands + 1];
};

__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a, double b) {
  asm(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(kWarps * 32, 8)
band_grams_kernel(const float* __restrict__ y, float* __restrict__ out, int batch, int rows, int nb,
                  Bands bands) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(batch) * nb) return;  // whole warps only
  const long long b = item / nb;
  const int k = static_cast<int>(item - b * nb);
  int lo = 0, hi = 0;  // bands.off[k], bands.off[k + 1] without a run-time index into the parameters
#pragma unroll
  for (int j = 0; j < kMaxBands; ++j) {
    if (j == k) {
      lo = bands.off[j];
      hi = bands.off[j + 1];
    }
  }
  const int n = hi - lo;
  const int q = lane & 3;   // the chunk's row this lane loads
  const int c = lane >> 2;  // its channel
  const float* src = y + (b * rows + lo) * kC + q * kC + c;

  double d0 = 0.0, d1 = 0.0;
  for (int r = 0; r < n; r += 4 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r0 = r + 4 * u;
      v[u] = r0 + q < n ? __ldg(src + r0 * kC) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + 4 * u < n) {  // the same for every lane of the warp
        const double a = static_cast<double>(v[u]);
        dmma_8x8x4(d0, d1, a, a);
      }
    }
  }

  float* dst = out + item * kPairs + c * (15 - c) / 2;
  const int d = 2 * q;
  if (d >= c) dst[d] = __double2float_rn(d0);
  if (d + 1 >= c) dst[d + 1] = __double2float_rn(d1);
}

}  // namespace

extern "C" {

// y [batch, rows, 8] float32, contiguous, 16-byte aligned (the kernel's
// loads need 4 bytes; the wrapper keeps the first design's contract, which
// every tensor of the path meets: allocations are 512-byte aligned); out
// [batch, nb * 36] float32; offsets: nb + 1 row offsets, non-decreasing,
// within [0, rows]. Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
int nsd_band_grams(const float* y, float* out, int batch, int rows,
                   const int* offsets, int nb, void* stream) {
  if (batch <= 0) return 0;
  if (nb < 1 || nb > kMaxBands || rows < 1 || rows > kMaxRows ||
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
  const long long items = static_cast<long long>(batch) * nb;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  band_grams_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      y, out, batch, rows, nb, bands);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
