// Zero-phase IIR cascade (the collector's biquads, forward then
// time-reversed) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   neural_speech_decoding_tpu/ops/pallas/iir.py:38 _cascade_kernel
//   (grid call _cascade_pass:80-126, wrapper fused_preprocess:133-171).
// Python wrapper, launch plan and plain twin:
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
// sample, 20.6 GFLOP, 0.31 ms at 67 TFLOP/s. So operations bind it. As
// issued, a section and sample is 6 instructions (3 FMA, 2 MUL, 1 ADD).
//
// Design. The recurrence is serial in time, so the parallelism is the
// B * C series and, inside a series, its S sections.
//
// 1. Whole windows in shared memory. A block takes W consecutive windows
//    (their [T, C] tiles are contiguous) with one bulk asynchronous copy
//    (cp.async.bulk, completion on an mbarrier) where the address and the
//    size are 16-byte aligned, else with a plain block-wide copy. Both
//    passes run in place in that tile, and the result leaves with one
//    bulk copy back. HBM carries x once and the result once. (The plain
//    copy is far slower: chip_smoke.py phase 3c times the two, and
//    PERF.md, section 6, has the times.)
// 2. A series' sections pipelined over a group of G lanes of one warp
//    (G in {1, 2, 4, 8, 16}: a group never straddles a warp). Lane g holds
//    K >= ceil(S / G) slots (kSlotCounts), slot j = 0 .. K-1 holding
//    section s = g K + j, their coefficients and states in registers (K is
//    a template argument, so no register array is indexed at run time).
//    Slots past the last section are identities (b0 = 1, the rest 0),
//    which pass every finite value and NaN through unchanged. At step i
//    section s runs on sample i - s: every slot takes the sample its
//    predecessor finished one step earlier (slot j - 1 in a register,
//    slot K - 1 of lane g - 1 through __shfl_up_sync), so the K sections
//    of a lane are independent within a step and the only chain a step
//    waits on is a section's own state (16 cycles), not K sections in
//    series. The group reads each sample from the tile two chunks of
//    kReadAhead steps ahead of its use (all its lanes read the same word,
//    one broadcast; lane 0 takes it), and the group's last lane writes
//    each result back in place, G K - 1 steps behind, so every sample is
//    read before it is overwritten. Lanes that hold no result write it to
//    a sink word, so no read or write is a branch. Before its first sample
//    a slot sees zeros on a zero state and stays exactly zero; what a slot
//    computes past sample T - 1 is never stored. Only the first and last
//    chunks of a pass check their reads and writes against the series. A
//    pass takes T + G K - 1 steps (rounded up to a chunk), __syncwarp
//    separates the two, and the reverse pass walks the same series from
//    its end. Each section's arithmetic is the same as in a
//    one-thread-a-series loop, so the result is the same for every G.
// 3. The shape is picked at launch by ops/kernels/iir.launch_plan: staged
//    with G = 2 and W the fewest windows that fill whole warps while the
//    batch is small against the card; past that, and for windows too long
//    for one block's shared memory (T C floats and the kernel's own 16
//    bytes over the opt-in limit, T > 7263 at C = 8 on an H100), the same
//    lane pipeline runs in place on the output in global memory
//    (kStaged = false) with G = 1 (2 past 16 sections) and 256 threads a
//    block: the forward pass reads x and writes out, the reverse pass
//    reads and writes out. With twice the HBM traffic it still fills the
//    card better at large B (8 warps an SM, registers the limit, against
//    the staged shape's 5, shared memory the limit).
//
// Bank conflicts: a group reads word (w T + i) C + c of the tile. At
// T = 625, C = 8 a warp's groups read 8 adjacent words of each of its
// windows, and T C = 5000 = 8 (mod 32) puts consecutive windows on the
// next 8 banks: conflict-free for every G (the CPU design test checks it).
// The last lanes write the same words; the others write one sink word.
//
// Times on the card, by launch shape: PERF.md, section 6.

#include <cuda_runtime.h>

#include <array>
#include <iterator>
#include <climits>
#include <cstdint>
#include <utility>

namespace {

constexpr int kMaxSections = 32;
constexpr int kMaxSlots = 16;    // K, sections one lane holds
// The K instantiated (each costs nvcc time): the powers of two, and 7 and
// 14 for the collector's 14 sections on the staged (G = 2) and the global
// (G = 1) shape. A lane holds the smallest K here that is at least
// ceil(S / G); the slots past S are identities. G K <= 32 for every S.
constexpr int kSlotCounts[] = {1, 2, 4, 7, 8, 14, 16};
static_assert(kSlotCounts[std::size(kSlotCounts) - 1] == kMaxSlots);
constexpr int kMaxLanes = 16;    // G, lanes one series takes
constexpr int kMaxThreads = 256;
constexpr int kReadAhead = 8;    // steps between lane 0's batched reads

// Coefficients by slot (s = g K + j); slots past the last section are
// identities.
struct Sos {
  float b0[kMaxSections], b1[kMaxSections], b2[kMaxSections];
  float a1[kMaxSections], a2[kMaxSections];
};

template <int K>
struct Slots {
  float b0[K], b1[K], b2[K], a1[K], a2[K];
};

__device__ __forceinline__ float section(float y, float& z0, float& z1, float b0, float b1, float b2,
                                         float a1, float a2) {
  const float out = b0 * y + z0;
  z0 = b1 * y - a1 * out + z1;
  z1 = b2 * y - a2 * out;
  return out;
}

// kReadAhead steps of the lane pipeline from step i0. Lane 0 of a group
// (head) takes the samples `ahead` holds (read two chunks earlier); every
// lane of the group reads the samples of the chunk after next (the same
// words: one broadcast) at the end, after this chunk's writes, which
// never touch them. The group's last lane (tail) writes each result,
// `depth` steps behind. Sample i is read at in[i * step] and written at
// out[i * wstep]; the other lanes have wstep = 0 and out = sink, so every
// lane issues every read and write and none is a branch. kChecked (the
// fill and the drain): a read past the series reads `in` itself and a
// write outside it goes to the sink; else every read and write of the
// chunk lies inside the series. `left` carries the shuffle of the
// previous step's last slot: it is issued as soon as that slot is
// computed, a step's work ahead of its use.
template <int K, bool kChecked>
__device__ __forceinline__ void pipeline_chunk(int i0, const float* in, float* out, float* sink, int step,
                                               int wstep, int t_len, int depth, bool head,
                                               float (&ahead)[2][kReadAhead], float& left, float (&o)[K],
                                               float (&z0)[K], float (&z1)[K], const Slots<K>& c) {
  float cur[kReadAhead];
#pragma unroll
  for (int u = 0; u < kReadAhead; ++u) {
    cur[u] = ahead[0][u];
    ahead[0][u] = ahead[1][u];
  }
  float* wp = out + (i0 - depth) * wstep;
#pragma unroll
  for (int u = 0; u < kReadAhead; ++u) {
    // lane l takes lane l - 1's last slot; a group's head takes its sample
    // instead, so the shuffle needs no group width
    const float y = head ? cur[u] : left;
    if constexpr (K > 1) {
      o[K - 1] = section(o[K - 2], z0[K - 1], z1[K - 1], c.b0[K - 1], c.b1[K - 1], c.b2[K - 1], c.a1[K - 1],
                         c.a2[K - 1]);
      left = __shfl_up_sync(0xffffffffu, o[K - 1], 1);
    }
#pragma unroll
    for (int j = K - 2; j > 0; --j)
      o[j] = section(o[j - 1], z0[j], z1[j], c.b0[j], c.b1[j], c.b2[j], c.a1[j], c.a2[j]);
    o[0] = section(y, z0[0], z1[0], c.b0[0], c.b1[0], c.b2[0], c.a1[0], c.a2[0]);
    if constexpr (K == 1) left = __shfl_up_sync(0xffffffffu, o[0], 1);
    const int p = i0 + u - depth;
    *(!kChecked || (p >= 0 && p < t_len) ? wp + u * wstep : sink) = o[K - 1];
  }
  const int i2 = i0 + 2 * kReadAhead;
  const float* rp = in + i2 * step;
#pragma unroll
  for (int u = 0; u < kReadAhead; ++u) ahead[1][u] = *(!kChecked || i2 + u < t_len ? rp + u * step : in);
}

// One pass of the lane pipeline over one series of t_len samples `stride`
// floats apart (kReverse: from its end): the head reads src, the tail
// writes dst, which may be src. Every lane of the warp runs the same steps.
template <int K, bool kReverse>
__device__ __forceinline__ void pipeline_pass(const float* src, float* dst, float* sink, int t_len, int stride,
                                              int lanes, bool head, bool tail, const Slots<K>& c) {
  float o[K], z0[K], z1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = z0[j] = z1[j] = 0.0f;
  const int depth = lanes * K - 1;
  const int steps = t_len + depth;
  const int step = kReverse ? -stride : stride;
  const int last = kReverse ? (t_len - 1) * stride : 0;
  const float* in = src + last;
  float* out = tail ? dst + last : sink;
  const int wstep = tail ? step : 0;
  float ahead[2][kReadAhead];
#pragma unroll
  for (int u = 0; u < 2 * kReadAhead; ++u) ahead[u / kReadAhead][u % kReadAhead] = u < t_len ? in[u * step] : 0.0f;
  float left = 0.0f;
  int i0 = 0;
  for (; i0 < depth && i0 < steps; i0 += kReadAhead)
    pipeline_chunk<K, true>(i0, in, out, sink, step, wstep, t_len, depth, head, ahead, left, o, z0, z1, c);
  for (; i0 + 3 * kReadAhead <= t_len; i0 += kReadAhead)  // the steady state: i0 >= depth here
    pipeline_chunk<K, false>(i0, in, out, sink, step, wstep, t_len, depth, head, ahead, left, o, z0, z1, c);
  for (; i0 < steps; i0 += kReadAhead)
    pipeline_chunk<K, true>(i0, in, out, sink, step, wstep, t_len, depth, head, ahead, left, o, z0, z1, c);
}

__device__ __forceinline__ bool bulk_ok(const void* gmem, long long bytes) {
  return (reinterpret_cast<uintptr_t>(gmem) & 15) == 0 && (bytes & 15) == 0;
}

__device__ __forceinline__ void wait_phase0(unsigned bar) {
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "WAIT_LOOP:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n\t"
      "@p bra WAIT_DONE;\n\t"
      "bra WAIT_LOOP;\n\t"
      "WAIT_DONE:\n\t"
      "}\n" ::"r"(bar)
      : "memory");
}

// The block's windows, count floats, from global memory into the tile.
__device__ __forceinline__ void stage_in(float* tile, const float* src, long long count,
                                         unsigned long long* barrier) {
  const long long bytes = 4 * count;
  if (bulk_ok(src, bytes)) {
    const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(barrier));
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(static_cast<unsigned>(bytes))
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              static_cast<unsigned>(__cvta_generic_to_shared(tile))),
          "l"(src), "r"(static_cast<unsigned>(bytes)), "r"(bar)
          : "memory");
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    wait_phase0(bar);
  } else {
    for (long long k = threadIdx.x; k < count; k += blockDim.x) tile[k] = src[k];
    __syncthreads();
  }
}

// The tile, count floats, back to global memory.
__device__ __forceinline__ void stage_out(float* dst, const float* tile, long long count) {
  const long long bytes = 4 * count;
  if (bulk_ok(dst, bytes)) {
    // this thread's tile writes, visible to the bulk copy's (async) proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(tile))),
                   "r"(static_cast<unsigned>(bytes))
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the tile outlives the read
    }
  } else {
    __syncthreads();
    for (long long k = threadIdx.x; k < count; k += blockDim.x) dst[k] = tile[k];
  }
}

// Block b takes series [b * block_series, (b + 1) * block_series) of the
// B * C (window-major), G = lanes threads each; kStaged: block_series is
// whole windows, staged in shared memory.
template <int K, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
iir_cascade_kernel(const float* __restrict__ x, float* __restrict__ out, int batch, int t_len,
                   int channels, int lanes, int block_series, Sos sos) {
  extern __shared__ float4 tile4[];
  __shared__ unsigned long long barrier;
  __shared__ float sink;  // where lanes that hold no result write theirs
  float* tile = reinterpret_cast<float*>(tile4);

  const long long tile_len = static_cast<long long>(t_len) * channels;
  const long long n0 = static_cast<long long>(blockIdx.x) * block_series;
  const int local = threadIdx.x / lanes;
  const int g = threadIdx.x % lanes;
  const long long n = n0 + local;
  const bool active = local < block_series && n < static_cast<long long>(batch) * channels;
  const bool head = active && g == 0;
  const bool tail = active && g == lanes - 1;

  // This lane's slots: s / K and s % K are constants once unrolled.
  Slots<K> c;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    c.b0[j] = 1.0f;
    c.b1[j] = c.b2[j] = c.a1[j] = c.a2[j] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kMaxSections; ++s) {
    if (s / K == g) {
      c.b0[s % K] = sos.b0[s];
      c.b1[s % K] = sos.b1[s];
      c.b2[s % K] = sos.b2[s];
      c.a1[s % K] = sos.a1[s];
      c.a2[s % K] = sos.a2[s];
    }
  }

  if (kStaged) {
    const long long w0 = n0 / channels;
    const long long here = min(static_cast<long long>(block_series / channels), batch - w0);
    stage_in(tile, x + w0 * tile_len, here * tile_len, &barrier);
    float* series = tile + (active ? (local / channels) * tile_len + local % channels : 0);
    pipeline_pass<K, false>(series, series, &sink, t_len, channels, lanes, head, tail, c);
    __syncwarp();
    pipeline_pass<K, true>(series, series, &sink, t_len, channels, lanes, head, tail, c);
    stage_out(out + w0 * tile_len, tile, here * tile_len);
  } else {
    const long long base = active ? (n / channels) * tile_len + n % channels : 0;
    pipeline_pass<K, false>(x + base, out + base, &sink, t_len, channels, lanes, head, tail, c);
    __syncwarp();  // orders the forward writes before the reverse reads
    pipeline_pass<K, true>(out + base, out + base, &sink, t_len, channels, lanes, head, tail, c);
  }
}

struct Launch {
  const float* x;
  float* out;
  int batch, t_len, channels, lanes, block_series;
  unsigned blocks;
  int threads;
  size_t shared, optin;  // dynamic shared memory, the card's opt-in limit
  cudaStream_t stream;
};

template <int K>
cudaError_t launch(const Launch& l, bool staged, const Sos& sos) {
  if (staged) {
    auto kernel = iir_cascade_kernel<K, true>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (l.shared + attr.sharedSizeBytes > l.optin) return cudaErrorInvalidValue;  // the tile and the static words
    if (l.shared > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.shared));
      if (err != cudaSuccess) return err;
    }
    kernel<<<l.blocks, l.threads, l.shared, l.stream>>>(l.x, l.out, l.batch, l.t_len, l.channels, l.lanes,
                                                         l.block_series, sos);
  } else {
    iir_cascade_kernel<K, false><<<l.blocks, l.threads, 0, l.stream>>>(l.x, l.out, l.batch, l.t_len, l.channels,
                                                                       l.lanes, l.block_series, sos);
  }
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Launch&, bool, const Sos&);

template <std::size_t... I>
constexpr std::array<LaunchFn, sizeof...(I)> launch_table(std::index_sequence<I...>) {
  return {{&launch<kSlotCounts[I]>...}};
}

constexpr auto kLaunch = launch_table(std::make_index_sequence<std::size(kSlotCounts)>{});

}  // namespace

extern "C" {

// x, out [batch, t_len, channels] float32 contiguous (not overlapping);
// sos [sections, 6] float64 rows (b0, b1, b2, a0, a1, a2), rounded to
// float32 here (a0 is taken as 1). The launch plan (ops/kernels/iir.py
// launch_plan): `lanes` threads a series (1, 2, 4, 8 or 16), block_series
// series a block, staged != 0 to stage whole windows (block_series a
// multiple of channels) in shared memory. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// plan the kernel does not take, a staged tile over the card's shared
// memory among them).
int nsd_iir_cascade(const float* x, float* out, int batch, int t_len, int channels, const double* sos,
                    int sections, int lanes, int block_series, int staged, void* stream) {
  if (batch <= 0 || t_len <= 0 || channels <= 0) return 0;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((static_cast<long long>(t_len) + 64) * channels > INT_MAX) return bad;  // offsets in a series are ints
  if (sections < 0 || sections > kMaxSections) return bad;
  if (lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0) return bad;
  const int k = sections > lanes ? (sections + lanes - 1) / lanes : 1;
  int slot = 0;  // the instantiation: the smallest K of kSlotCounts >= k
  while (slot < static_cast<int>(std::size(kSlotCounts)) && kSlotCounts[slot] < k) ++slot;
  if (slot == static_cast<int>(std::size(kSlotCounts))) return bad;
  if (block_series <= 0 || static_cast<long long>(block_series) * lanes > kMaxThreads) return bad;
  Launch l{x, out, batch, t_len, channels, lanes, block_series, 0u, 0, 0, 0, static_cast<cudaStream_t>(stream)};
  l.threads = (block_series * lanes + 31) / 32 * 32;
  if (staged) {
    if (block_series % channels != 0) return bad;
    l.shared = static_cast<size_t>(block_series / channels) * t_len * channels * sizeof(float);
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    l.optin = static_cast<size_t>(optin);
  }
  const long long blocks = (static_cast<long long>(batch) * channels + block_series - 1) / block_series;
  if (blocks > 0x7fffffffLL) return bad;
  l.blocks = static_cast<unsigned>(blocks);
  Sos prm;
  for (int s = 0; s < kMaxSections; ++s) {
    const bool on = s < sections;
    prm.b0[s] = on ? static_cast<float>(sos[6 * s + 0]) : 1.0f;
    prm.b1[s] = on ? static_cast<float>(sos[6 * s + 1]) : 0.0f;
    prm.b2[s] = on ? static_cast<float>(sos[6 * s + 2]) : 0.0f;
    prm.a1[s] = on ? static_cast<float>(sos[6 * s + 4]) : 0.0f;
    prm.a2[s] = on ? static_cast<float>(sos[6 * s + 5]) : 0.0f;
  }
  return static_cast<int>(kLaunch[slot](l, staged != 0, prm));
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
