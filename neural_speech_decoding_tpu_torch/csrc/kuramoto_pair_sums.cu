// Fused Hilbert transform + Kuramoto pair sums for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   neural_speech_decoding_tpu/ops/pallas/kuramoto.py:60 _pair_sums_kernel
//   (grid call _pair_sums_batched:98, wrapper kuramoto_pair_sums:120).
// Python wrapper, tables and plain twin:
//   neural_speech_decoding_tpu_torch/ops/kernels/kuramoto.py
//
// For each raw window x [T, 8] (float32, batch b):
//   im[t, c] = (H x)[t, c]                    the Hilbert transform in time
//   p2 = x^2 + im^2
//   c2 = (x^2 - im^2) / p2,  s2 = 2 x im / p2, and c2 = 1, s2 = 0 where
//        p2 < FLT_MIN (an all-zero channel: np.angle(0) == 0)
//   G[b, i, j] = sum_t c2_i c2_j + s2_i s2_j  for the 36 pairs i <= j,
//        written to both halves of out [B, 8, 8].
//
// Bound on this card: reading x is 20 KB per window (328 MB at B = 16384,
// about 0.1 ms at 3.35 TB/s); the least work (an FFT Hilbert step, c2/s2
// and the pair sums, about 0.38 MFLOP a window) takes about 0.09 ms at the
// H100 SXM's 67 TFLOP/s float32. So the function is bound by bytes, at
// about 0.1 ms (chip_smoke.py computes the bound). The TPU kernel does the
// Hilbert step as a dense [T, T] product, 6.25 MFLOP a window: on this
// card that product alone has a float32 floor of about 1.5 ms at
// B = 16384, whatever its tiling. So the step is an FFT here.
//
// Design:
//   * one block holds kWin = 2 windows: 16 series (window, channel) of T
//     complex samples in shared memory, [T][16] float2 (128 T bytes), the
//     operator column and a queue slot a sample; 256 threads, 2 blocks an
//     SM (128 registers a thread). A half-warp reads or writes one 128-byte
//     row: no bank conflicts. x is read once, in 16-byte loads (all of a
//     thread's in flight), into the real parts; each series' energy is
//     summed on the way;
//   * the operator is split, H = N + F: N, the kNear nearest taps on each
//     side of t (H is circulant), is summed in the time domain after the
//     FFT's part, nearest tap last; F, the rest, is the FFT round trip.
//     The FFT rounds by about eps ||x|| at every sample, while the dense
//     float32 product (the reference) rounds by about eps |im| where im is
//     small, and c2/s2 amplify im's error by 2 / |z| there: with the whole
//     operator in the FFT the pair sums read 3.1x the reference's error
//     against float64 on one window (T = 1250, on the card). F's part is about a
//     tenth of im, so its rounding is too; 3 taps bring the kernel within
//     the reference's error (on the card, 0.4-1.1x of it at the smoke's
//     inputs);
//   * F x is a DFT round trip of each series on its own (two real channels
//     are never packed into one complex transform: their rounding would
//     leak into each other, and a dead channel's im would no longer be
//     exactly 0). The forward transform is an in-place mixed-radix
//     decimation in frequency (radix 4, 2, 3 and 5 with the twiddle after
//     the butterfly; any other prime factor a direct-DFT stage with a
//     compensated sum), which leaves the spectrum in digit-reversed order.
//     The spectrum is multiplied by -i ((h_k - 1) - mu_k) / T (h scipy's
//     Hilbert gain, -i mu_k N's eigenvalues), permuted to that order by the
//     wrapper. The inverse is the forward's adjoint (conjugate twiddle
//     before the conjugate butterfly, stages in reverse), which takes that
//     order back to natural order; its real part is F x. Every stage is
//     local to its butterfly groups, so it runs in place, one barrier a
//     pass, with no permutation pass;
//   * passes: two stages of one radix (5 or 4) run as one pass of R^2
//     points in registers; the plan's last two stages and the first two
//     of the inverse act on the same groups, so one middle pass does all
//     four and the multiplier (its twiddles are constants). 625 = 5^4 is
//     three shared-memory passes. The first pass reads only real input
//     and the last computes only real output, with the same operations on
//     what is nonzero;
//   * twiddles exp(-2 pi i m / T) and the permuted multiplier come from a
//     float32 table the wrapper builds in float64 (read through the
//     read-only cache). An all-zero series stays exactly zero;
//   * after the inverse transform, thread (series, chunk of T / 16 rows)
//     walks its rows in order, reading x again (from L2) with x[t - 3 ..
//     t + 3] in registers: it writes x into the imaginary parts (which the
//     inverse leaves as rounding noise about 0), adds N x to F x and
//     queues the samples near z = 0;
//   * c2 = cos 2 phi and s2 = sin 2 phi move by about 2 |d im| / |z| for an
//     error d im, so near z = 0 the pair sums are ill-conditioned: there
//     every float32 im gives another G. The reference defines im in fast
//     mode as the dense float32 operator product (the JAX package's fast
//     filter; the plain twin, a cuBLAS product whose rounding is that of
//     one FMA chain over k), and that product itself errs by up to 5.7e-4
//     of G against float64 at B = 16384. So a sample whose |z|^2 is below
//     kRefineBelow (1e-4) of its series' mean x^2 (about 0.005 % of the
//     samples of random data; on a channel of artifact bursts, where the
//     bursts set the mean, most of its flat samples) takes im from that
//     product: the FMA chain sum_k col[(t - k) mod T] x[k], k = 0 .. T-1,
//     col the operator's first column, kept reversed in shared memory. The
//     queue has a slot for every sample; the chains run side by side, a
//     thread each, in rounds of 256, in a phase of their own. A one-lane
//     chain still costs the shared-memory pipe a warp instruction a load,
//     and on the card it slowed the other blocks' passes too: hence the
//     low threshold;
//   * c2/s2: thread (series, row) takes x and im from shared memory. The 8
//     channels of a row sit on 8 neighbouring lanes, so lane c forms the
//     pairs (c, c + d mod 8), d = 0..4, by width-8 shuffles (d = 4 on
//     lanes 0..3 only): 36 pairs, 5 accumulators a thread, 4 rows a group.
//     Each thread sums its groups with Kahan compensation, then a tree of
//     (hi, lo) pairs by TwoSum (one shuffle level, then the 8 warps
//     through shared memory), rounded once at the end. A running float32
//     sum over T errs by about 1.7e-3; a plain float32 tree rounds at each
//     of its levels, up to an ulp of T.
// The products stay in full float32: TF32 keeps about three decimal
// digits, and the filter's ridge solve amplifies gram errors into the
// logits (the JAX package records 3e-1 of filter error from a bf16 gram).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 8;                       // channels (the wrapper checks)
constexpr int kWin = 2;                     // windows a block
constexpr int kSeries = kWin * kC;          // 16 series a block
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;             // registers: 128 a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRowStep = kThreads / kSeries;  // 16 butterflies or rows in flight a series
constexpr int kDiag = 5;                    // cyclic pair offsets d = 0..4
constexpr int kMaxStages = 16;
constexpr int kGenOut = 8;                  // outputs a thread holds in a direct-DFT round
constexpr int kMaxDirect = kThreads * kGenOut;  // largest direct-DFT radix, so the largest T
constexpr int kNear = 3;                    // taps on each side summed in the time domain
constexpr int kGroup = 8;                   // rows a thread adds the taps to at once
// A sample with |z|^2 below this share of its series' mean x^2 (about
// 0.005 % of the samples of random windows) takes im as the reference's
// dense product: see the note above.
constexpr float kRefineBelow = 1e-4f;
constexpr int kBatch = 10;                  // x loads a thread keeps in flight (T = 625: all of them)
constexpr int kRows = 4;                    // rows a thread sums as one group
constexpr int kMaxSmemBytes = 232448;       // opt-in shared memory per block
constexpr int kRedBytes = kWarps * kSeries * kDiag * sizeof(float2) + kSeries * sizeof(float) + 16;
// dynamic shared memory a sample: its complex value, the column, a queue slot
constexpr int kBytesPerT = kSeries * sizeof(float2) + sizeof(float) + kSeries * sizeof(unsigned short);
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kSeries == 16, "a warp holds 2 rows of the 16 series: lanes l and l ^ 16 share one");

// Radices of the stages in order, product T (the wrapper's fft_plan); bit
// st of `fused` set: stages st and st + 1 (the same radix, 4 or 5) run as
// one pass.
struct Plan {
  int stages;
  unsigned fused;
  int radix[kMaxStages];
};

enum Mode { kForward = 0, kMiddle = 1, kAdjoint = 2 };

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 w) {  // a * conj(w)
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}
// a + sg i b and a - sg i b, sg = -1 (forward) or +1 (inverse)
template <int Sg>
__device__ __forceinline__ float2 add_i(float2 a, float2 b) {
  return Sg > 0 ? make_float2(a.x - b.y, a.y + b.x) : make_float2(a.x + b.y, a.y - b.x);
}
template <int Sg>
__device__ __forceinline__ float2 sub_i(float2 a, float2 b) {
  return Sg > 0 ? make_float2(a.x + b.y, a.y - b.x) : make_float2(a.x - b.y, a.y + b.x);
}
// s + e == a + b exactly (Knuth's TwoSum; no FMA can form here)
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
  return s;
}

// (hi, lo) += (hi2, lo2) for a sum kept as an unevaluated pair
__device__ __forceinline__ void add_pair(float& hi, float& lo, float hi2, float lo2) {
  float e;
  hi = two_sum(hi, hi2, e);
  lo = lo + lo2 + e;
}

// times -i g: the Hilbert multiplier of one frequency
__device__ __forceinline__ float2 hilbert_gain(float2 v, float g) { return make_float2(g * v.y, -g * v.x); }

// In-register DFT of R points, X_k = sum_n v_n exp(Sg 2 pi i n k / R).
template <int R, int Sg>
struct Dft;

template <int Sg>
struct Dft<2, Sg> {
  static __device__ __forceinline__ void run(float2 (&v)[2]) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  }
};

template <int Sg>
struct Dft<3, Sg> {
  static __device__ __forceinline__ void run(float2 (&v)[3]) {
    const float kS = static_cast<float>(0.86602540378443864676);  // sin(2 pi / 3)
    const float2 t = cadd(v[1], v[2]);
    const float2 d = cscale(csub(v[1], v[2]), kS);
    const float2 b = csub(v[0], cscale(t, 0.5f));
    v[0] = cadd(v[0], t);
    v[1] = add_i<Sg>(b, d);
    v[2] = sub_i<Sg>(b, d);
  }
};

template <int Sg>
struct Dft<4, Sg> {
  static __device__ __forceinline__ void run(float2 (&v)[4]) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = csub(v[1], v[3]);
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = add_i<Sg>(t1, t3);
    v[3] = sub_i<Sg>(t1, t3);
  }
};

template <int Sg>
struct Dft<5, Sg> {
  static __device__ __forceinline__ void run(float2 (&v)[5]) {
    const float kC1 = static_cast<float>(0.30901699437494742410);   // cos(2 pi / 5)
    const float kC2 = static_cast<float>(-0.80901699437494742410);  // cos(4 pi / 5)
    const float kS1 = static_cast<float>(0.95105651629515357212);   // sin(2 pi / 5)
    const float kS2 = static_cast<float>(0.58778525229247312917);   // sin(4 pi / 5)
    const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
    const float2 t3 = csub(v[1], v[4]), t4 = csub(v[2], v[3]);
    const float2 b1 = cadd(v[0], cadd(cscale(t1, kC1), cscale(t2, kC2)));
    const float2 b2 = cadd(v[0], cadd(cscale(t1, kC2), cscale(t2, kC1)));
    const float2 d1 = cadd(cscale(t3, kS1), cscale(t4, kS2));
    const float2 d2 = csub(cscale(t3, kS2), cscale(t4, kS1));
    v[0] = cadd(v[0], cadd(t1, t2));
    v[1] = add_i<Sg>(b1, d1);
    v[4] = sub_i<Sg>(b1, d1);
    v[2] = add_i<Sg>(b2, d2);
    v[3] = sub_i<Sg>(b2, d2);
  }
};

// Forward DFT of R real points (the first pass's input): the complex DFT
// with zero imaginary parts, operation for operation on what is nonzero.
template <int R>
struct DftRealIn;

template <>
struct DftRealIn<5> {
  static __device__ __forceinline__ void run(const float (&a)[5], float2 (&v)[5]) {
    const float kC1 = static_cast<float>(0.30901699437494742410);
    const float kC2 = static_cast<float>(-0.80901699437494742410);
    const float kS1 = static_cast<float>(0.95105651629515357212);
    const float kS2 = static_cast<float>(0.58778525229247312917);
    const float t1 = a[1] + a[4], t2 = a[2] + a[3];
    const float t3 = a[1] - a[4], t4 = a[2] - a[3];
    const float b1 = a[0] + (t1 * kC1 + t2 * kC2);
    const float b2 = a[0] + (t1 * kC2 + t2 * kC1);
    const float d1 = t3 * kS1 + t4 * kS2;
    const float d2 = t3 * kS2 - t4 * kS1;
    v[0] = make_float2(a[0] + (t1 + t2), 0.0f);
    v[1] = make_float2(b1, -d1);
    v[4] = make_float2(b1, d1);
    v[2] = make_float2(b2, -d2);
    v[3] = make_float2(b2, d2);
  }
};

template <>
struct DftRealIn<4> {
  static __device__ __forceinline__ void run(const float (&a)[4], float2 (&v)[4]) {
    const float t0 = a[0] + a[2], t1 = a[0] - a[2];
    const float t2 = a[1] + a[3], t3 = a[1] - a[3];
    v[0] = make_float2(t0 + t2, 0.0f);
    v[2] = make_float2(t0 - t2, 0.0f);
    v[1] = make_float2(t1, -t3);
    v[3] = make_float2(t1, t3);
  }
};

// Inverse DFT of R points, real parts only (the last pass's output, im).
template <int R>
struct DftRealOut;

template <>
struct DftRealOut<5> {
  static __device__ __forceinline__ void run(const float2 (&u)[5], float (&x)[5]) {
    const float kC1 = static_cast<float>(0.30901699437494742410);
    const float kC2 = static_cast<float>(-0.80901699437494742410);
    const float kS1 = static_cast<float>(0.95105651629515357212);
    const float kS2 = static_cast<float>(0.58778525229247312917);
    const float t1 = u[1].x + u[4].x, t2 = u[2].x + u[3].x;
    const float t3 = u[1].y - u[4].y, t4 = u[2].y - u[3].y;
    const float b1 = u[0].x + (t1 * kC1 + t2 * kC2);
    const float b2 = u[0].x + (t1 * kC2 + t2 * kC1);
    const float d1 = t3 * kS1 + t4 * kS2;
    const float d2 = t3 * kS2 - t4 * kS1;
    x[0] = u[0].x + (t1 + t2);
    x[1] = b1 - d1;
    x[4] = b1 + d1;
    x[2] = b2 - d2;
    x[3] = b2 + d2;
  }
};

template <>
struct DftRealOut<4> {
  static __device__ __forceinline__ void run(const float2 (&u)[4], float (&x)[4]) {
    const float t0 = u[0].x + u[2].x, t1 = u[0].x - u[2].x;
    const float t2 = u[1].x + u[3].x, t3 = u[1].y - u[3].y;
    x[0] = t0 + t2;
    x[2] = t0 - t2;
    x[1] = t1 - t3;
    x[3] = t1 + t3;
  }
};

// q = b / m, r = b - q m for the small non-negative ints of a plan
// (b, m < 2^12), by a float reciprocal and one correction step.
__device__ __forceinline__ void divmod_small(int b, int m, float inv_m, int& q, int& r) {
  q = __float2int_rz(static_cast<float>(b) * inv_m);
  r = b - q * m;
  if (r < 0) {
    --q;
    r += m;
  } else if (r >= m) {
    ++q;
    r -= m;
  }
}

// One stage of a fixed radix on a block of length `len` (the sub-transform
// length before this stage): butterfly b of a series reads the R points
// base + r m, m = len / R, base = (b / m) len + b % m, and writes them back.
//   kForward: DFT, then point k1 times w_len^(n0 k1)
//   kAdjoint: point k1 times conj(w_len^(n0 k1)), then the inverse DFT
//   kMiddle (last stage, m = 1): DFT, times -i gain[position], inverse DFT
template <int R, int M>
__device__ __forceinline__ void fixed_stage(float2* buf, int n, int len, const float2* __restrict__ tw,
                                            const float* __restrict__ gain) {
  const int m = len / R;
  const int step = n / len;  // w_len^j = w_n^(j step)
  const float inv_m = 1.0f / static_cast<float>(m);
  const int groups = n / R;
  const int s = threadIdx.x % kSeries;
#pragma unroll 2
  for (int b = threadIdx.x / kSeries; b < groups; b += kRowStep) {
    int blk, n0;
    divmod_small(b, m, inv_m, blk, n0);
    const int base = blk * len + n0;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = buf[(base + r * m) * kSeries + s];
    if (M == kAdjoint) {
#pragma unroll
      for (int k = 1; k < R; ++k) v[k] = cmul_conj(v[k], __ldg(tw + n0 * k * step));
      Dft<R, +1>::run(v);
    } else {
      Dft<R, -1>::run(v);
      if (M == kForward) {
#pragma unroll
        for (int k = 1; k < R; ++k) v[k] = cmul(v[k], __ldg(tw + n0 * k * step));
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = hilbert_gain(v[k], __ldg(gain + base + k));
        Dft<R, +1>::run(v);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) buf[(base + r * m) * kSeries + s] = v[r];
  }
}

// exp(-2 pi i m / R^2) in float32, m < R^2: the twiddles of a fused middle
// pass (the plan's last two stages, n0 = 0), the same numbers as the table's.
template <int R>
__device__ __forceinline__ float2 root(int m);
template <>
__device__ __forceinline__ float2 root<5>(int m) {
  constexpr float kRe[25] = {1.0f, 0.9685831665992737f, 0.8763066530227661f, 0.728968620300293f, 0.5358268022537231f, 0.30901700258255005f, 0.06279052048921585f, -0.187381312251091f, -0.4257792830467224f, -0.6374239921569824f, -0.80901700258255f, -0.9297764897346497f, -0.9921147227287292f, -0.9921147227287292f, -0.9297764897346497f, -0.80901700258255f, -0.6374239921569824f, -0.4257792830467224f, -0.187381312251091f, 0.06279052048921585f, 0.30901700258255005f, 0.5358268022537231f, 0.728968620300293f, 0.8763066530227661f, 0.9685831665992737f};
  constexpr float kIm[25] = {0.0f, -0.24868988990783691f, -0.4817536771297455f, -0.6845471262931824f, -0.8443279266357422f, -0.9510565400123596f, -0.9980267286300659f, -0.9822872281074524f, -0.9048270583152771f, -0.7705132365226746f, -0.5877852439880371f, -0.3681245446205139f, -0.12533323466777802f, 0.12533323466777802f, 0.3681245446205139f, 0.5877852439880371f, 0.7705132365226746f, 0.9048270583152771f, 0.9822872281074524f, 0.9980267286300659f, 0.9510565400123596f, 0.8443279266357422f, 0.6845471262931824f, 0.4817536771297455f, 0.24868988990783691f};
  return make_float2(kRe[m], kIm[m]);
}
template <>
__device__ __forceinline__ float2 root<4>(int m) {
  constexpr float kRe[16] = {1.0f, 0.9238795042037964f, 0.7071067690849304f, 0.3826834261417389f, 6.123234262925839e-17f, -0.3826834261417389f, -0.7071067690849304f, -0.9238795042037964f, -1.0f, -0.9238795042037964f, -0.7071067690849304f, -0.3826834261417389f, -1.8369701465288538e-16f, 0.3826834261417389f, 0.7071067690849304f, 0.9238795042037964f};
  constexpr float kIm[16] = {0.0f, -0.3826834261417389f, -0.7071067690849304f, -0.9238795042037964f, -1.0f, -0.9238795042037964f, -0.7071067690849304f, -0.3826834261417389f, -1.2246468525851679e-16f, 0.3826834261417389f, 0.7071067690849304f, 0.9238795042037964f, 1.0f, 0.9238795042037964f, 0.7071067690849304f, 0.3826834261417389f};
  return make_float2(kRe[m], kIm[m]);
}

// Two consecutive stages of one radix R (4 or 5) in one pass: stage A on
// blocks of length `len` (stride m1 = len / R), then stage B on its
// sub-blocks (stride m2 = m1 / R). The R^2 points blk len + j1 m1 + j2 m2
// + n0, n0 < m2, are closed under both, so a thread loads them once, does
// both stages in registers (the same butterflies and twiddles, point for
// point, as two single stages) and stores them once.
//   kForward: A then B, each with its twiddle after the butterfly
//   kMiddle (the plan's last two stages, m2 = 1): A, B, -i gain, then the
//            inverse of B and the adjoint of A
//   kAdjoint: the adjoint of B, then the adjoint of A
//   Edge: the plan's first forward pass (real input: only the real parts
//         are read) or its last adjoint pass (only im, the real parts, is
//         computed and stored)
template <int R, int M, bool Edge>
__device__ __forceinline__ void fused_stages(float2* buf, int n, int len, const float2* __restrict__ tw,
                                             const float* __restrict__ gain) {
  const int m1 = len / R, m2 = m1 / R;
  const int step_a = n / len, step_b = n / m1;
  const float inv_m2 = 1.0f / static_cast<float>(m2);
  const int groups = n / (R * R);
  for (int i = threadIdx.x; i < groups * kSeries; i += kThreads) {
    const int s = i % kSeries;
    int blk, n0;
    divmod_small(i / kSeries, m2, inv_m2, blk, n0);
    const int base = blk * len + n0;
    float2 wb[R];  // stage B's twiddles w_m1^(n0 k), the same for every k1
#pragma unroll
    for (int k = 1; k < R; ++k) wb[k] = M == kMiddle ? make_float2(1.0f, 0.0f) : __ldg(tw + n0 * k * step_b);
    float2 v[R][R];  // v[j1][j2] at base + j1 m1 + j2 m2
    constexpr bool kRealIn = Edge && M == kForward;
#pragma unroll
    for (int j1 = 0; j1 < R; ++j1) {
#pragma unroll
      for (int j2 = 0; j2 < R; ++j2) {
        const int at = (base + j1 * m1 + j2 * m2) * kSeries + s;
        v[j1][j2] = kRealIn ? make_float2(buf[at].x, 0.0f) : buf[at];
      }
    }
    if (M != kAdjoint) {
      // stage A: over j1 for each j2 (its n0 is j2 m2 + n0)
#pragma unroll
      for (int j2 = 0; j2 < R; ++j2) {
        float2 u[R];
        if (kRealIn) {
          float a[R];
#pragma unroll
          for (int j1 = 0; j1 < R; ++j1) a[j1] = v[j1][j2].x;
          DftRealIn<R>::run(a, u);
        } else {
#pragma unroll
          for (int j1 = 0; j1 < R; ++j1) u[j1] = v[j1][j2];
          Dft<R, -1>::run(u);
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float2 w = M == kMiddle ? root<R>(j2 * k)
                                        : __ldg(tw + (j2 * m2 + n0) * k * step_a);
          v[k][j2] = k == 0 ? u[0] : cmul(u[k], w);
        }
      }
      // stage B: over j2 for each k1 (its n0 is n0)
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        Dft<R, -1>::run(v[k1]);
        if (M == kForward) {
#pragma unroll
          for (int k = 1; k < R; ++k) v[k1][k] = cmul(v[k1][k], wb[k]);
        } else {  // middle: n0 = 0, no twiddle; gain, then the inverse of B
#pragma unroll
          for (int k = 0; k < R; ++k) v[k1][k] = hilbert_gain(v[k1][k], __ldg(gain + base + k1 * m1 + k));
          Dft<R, +1>::run(v[k1]);
        }
      }
    } else {
      // adjoint of B: over k2 for each k1
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
#pragma unroll
        for (int k = 1; k < R; ++k) v[k1][k] = cmul_conj(v[k1][k], wb[k]);
        Dft<R, +1>::run(v[k1]);
      }
    }
    if (M != kForward) {
      // adjoint of A: over k1 for each j2
#pragma unroll
      for (int j2 = 0; j2 < R; ++j2) {
        float2 u[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float2 w = M == kMiddle ? root<R>(j2 * k)
                                        : __ldg(tw + (j2 * m2 + n0) * k * step_a);
          u[k] = k == 0 ? v[0][j2] : cmul_conj(v[k][j2], w);
        }
        if (Edge && M == kAdjoint) {  // the last pass: im only
          float re[R];
          DftRealOut<R>::run(u, re);
#pragma unroll
          for (int j1 = 0; j1 < R; ++j1) buf[(base + j1 * m1 + j2 * m2) * kSeries + s].x = re[j1];
        } else {
          Dft<R, +1>::run(u);
#pragma unroll
          for (int j1 = 0; j1 < R; ++j1) v[j1][j2] = u[j1];
        }
      }
    }
    if (!(Edge && M == kAdjoint)) {
#pragma unroll
      for (int j1 = 0; j1 < R; ++j1) {
#pragma unroll
        for (int j2 = 0; j2 < R; ++j2) buf[(base + j1 * m1 + j2 * m2) * kSeries + s] = v[j1][j2];
      }
    }
  }
}

// One stage of any radix q by a direct DFT (the prime factors above 5).
// Output k of group (b, s) needs all q inputs of that group, so outputs are
// computed in rounds of whole groups, held in registers, and written after
// a barrier. kForward multiplies by the gain when `last` (m = 1 then).
template <int M>
__device__ __noinline__ void generic_stage(float2* buf, int n, int len, int q, bool last, const float2* __restrict__ tw,
                              const float* __restrict__ gain) {
  const int m = len / q;
  const int step = n / len;
  const int qstep = n / q;  // w_q^j = w_n^(j qstep)
  const int groups = (n / q) * kSeries;
  const int per_round = kMaxDirect / q;  // >= 1: q <= T <= kMaxDirect
  const int rounds = (groups + per_round - 1) / per_round;
  for (int rd = 0; rd < rounds; ++rd) {
    float2 val[kGenOut];
    int pos[kGenOut];
#pragma unroll
    for (int u = 0; u < kGenOut; ++u) {
      const int o = threadIdx.x + u * kThreads;
      const int g = rd * per_round + o / q;
      pos[u] = -1;
      val[u] = make_float2(0.0f, 0.0f);
      if (o < per_round * q && g < groups) {
        const int k = o % q;
        const int s = g % kSeries, b = g / kSeries;
        const int n0 = b % m, base = (b / m) * len + n0;
        // q terms: a Kahan-compensated sum, so a long prime stage stays
        // within the rounding of the short ones
        float2 acc = make_float2(0.0f, 0.0f), lost = make_float2(0.0f, 0.0f);
        int idx = 0;  // (j k) mod q
        for (int j = 0; j < q; ++j) {
          float2 in = buf[(base + j * m) * kSeries + s];
          const float2 w = __ldg(tw + idx * qstep);
          float2 term;
          if (M == kAdjoint) {
            in = cmul_conj(in, __ldg(tw + n0 * j * step));
            term = cmul_conj(in, w);
          } else {
            term = cmul(in, w);
          }
          const float2 y = csub(term, lost);
          const float2 total = cadd(acc, y);
          lost = csub(csub(total, acc), y);
          acc = total;
          idx += k;
          if (idx >= q) idx -= q;
        }
        acc = csub(acc, lost);
        if (M == kForward) {
          acc = cmul(acc, __ldg(tw + n0 * k * step));
          if (last) acc = hilbert_gain(acc, __ldg(gain + base + k * m));
        }
        val[u] = acc;
        pos[u] = (base + k * m) * kSeries + s;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kGenOut; ++u) {
      if (pos[u] >= 0) buf[pos[u]] = val[u];
    }
    __syncthreads();
  }
}

// One pass of the plan: stage r alone, or with `fused` the two stages of
// radix r (4 or 5) from `len` on.
template <int M>
__device__ __forceinline__ void stage(float2* buf, int n, int len, int r, bool fused, bool last,
                                      const float2* __restrict__ tw, const float* __restrict__ gain) {
  if (fused) {
    const bool edge = M != kMiddle && len == n;  // the plan's first forward or last adjoint pass
    if (r == 5) {
      if (edge) {
        fused_stages<5, M, M != kMiddle>(buf, n, len, tw, gain);
      } else {
        fused_stages<5, M, false>(buf, n, len, tw, gain);
      }
    } else {
      if (edge) {
        fused_stages<4, M, M != kMiddle>(buf, n, len, tw, gain);
      } else {
        fused_stages<4, M, false>(buf, n, len, tw, gain);
      }
    }
    return;
  }
  switch (r) {
    case 2: fixed_stage<2, M>(buf, n, len, tw, gain); break;
    case 3: fixed_stage<3, M>(buf, n, len, tw, gain); break;
    case 4: fixed_stage<4, M>(buf, n, len, tw, gain); break;
    case 5: fixed_stage<5, M>(buf, n, len, tw, gain); break;
    default: generic_stage<M == kMiddle ? kForward : M>(buf, n, len, r, last, tw, gain); break;
  }
}

// im[t] of series s as the reference's dense float32 product: one FMA chain
// sum_k col[(t - k) mod T] x[k], k = 0 .. T-1, x in buf's imaginary parts;
// colr[u] = col[(-u) mod T], so col[(t - k) mod T] is colr[T - t + k] for
// k < t and colr[k - t] from k = t on: two ascending runs.
__device__ __forceinline__ float chain_run(const float2* buf, const float* c, int k, int end, int s, float acc) {
  constexpr int kAhead = 16;  // loads in flight ahead of the chain
  for (; k + kAhead <= end; k += kAhead) {
    float a[kAhead], v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      a[u] = c[k + u];
      v[u] = buf[(k + u) * kSeries + s].y;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = fmaf(a[u], v[u], acc);
  }
  for (; k < end; ++k) acc = fmaf(c[k], buf[k * kSeries + s].y, acc);
  return acc;
}

__device__ __forceinline__ float chain_im(const float2* buf, const float* colr, int n, int t, int s) {
  const float acc = chain_run(buf, colr + (n - t), 0, t, s, 0.0f);
  return chain_run(buf, colr - t, t, n, s, acc);
}

// c2 = cos 2 phi, s2 = sin 2 phi of z = re + i im, transcendental-free; an
// all-zero sample (|z|^2 below FLT_MIN) gives c2 = 1, s2 = 0 exactly.
__device__ __forceinline__ void cos_sin_2phi(float re, float im, float& c2, float& s2) {
  const float re2 = re * re;
  const float im2 = im * im;
  const float p2 = re2 + im2;
  const bool degenerate = p2 < 1.17549435e-38f;  // FLT_MIN
  // 1 / p2 within 2 ulp, in one instruction where the IEEE reciprocal takes
  // a sequence: c2 and s2 move by about 1e-7, far less than im's 2 / |z|
  const float inv = __fdividef(1.0f, degenerate ? 1.0f : p2);
  c2 = degenerate ? 1.0f : (re2 - im2) * inv;
  s2 = degenerate ? 0.0f : (2.0f * re * im) * inv;
}

// i mod n in [0, n), for any int i
__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Row t, channels 4h..4h+3 of window b, as one float4 (zero past the
// batch): a 16-byte load when x is 16-byte aligned.
__device__ __forceinline__ float4 load_x4(const float* __restrict__ x, bool aligned, int b, int batch, int n, int t,
                                          int h) {
  if (b >= batch) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* src = x + (static_cast<size_t>(b) * n + t) * kC + 4 * h;
  if (aligned) return __ldg(reinterpret_cast<const float4*>(src));
  return make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
pair_sums_kernel(const float* __restrict__ x, const float2* __restrict__ tw, const float* __restrict__ gain,
                 const float* __restrict__ hcol, float* __restrict__ out, int batch, int n, Plan plan) {
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);  // [n][kSeries]: series s = window * 8 + channel
  float* colr = reinterpret_cast<float*>(buf + n * kSeries);  // [n]: the operator column, reversed
  // [kSeries n]: the near-zero samples, t * kSeries + s; room for every sample
  unsigned short* queue = reinterpret_cast<unsigned short*>(colr + n);
  __shared__ float2 red[kWarps][kSeries][kDiag];  // (hi, lo) pairs
  __shared__ float energy[kSeries];               // mean x^2 of each series
  __shared__ int queued;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kWin;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // the x loads: item i is row t = i / 4 of window slot w = (i / 2) % 2,
  // channels 4h..4h+3, h = i % 2; a thread keeps its (w, h)
  const int total = n * kWin * 2;
  const int lw = (tid >> 1) % kWin, lh = tid & 1;
  const int lseries = lw * kC + 4 * lh;  // the first of this thread's 4 series

  // x -> real parts, imaginary parts 0, kBatch loads in flight a thread;
  // each series' sum of x^2; the operator's column, reversed
  float e4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i0 = tid; i0 < total; i0 += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < total ? load_x4(x, aligned, b0 + lw, batch, n, i / (2 * kWin), lh) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        float4* dst = reinterpret_cast<float4*>(buf + (i / (2 * kWin)) * kSeries + lseries);
        dst[0] = make_float4(v[u].x, 0.0f, v[u].y, 0.0f);
        dst[1] = make_float4(v[u].z, 0.0f, v[u].w, 0.0f);
        e4[0] = fmaf(v[u].x, v[u].x, e4[0]);
        e4[1] = fmaf(v[u].y, v[u].y, e4[1]);
        e4[2] = fmaf(v[u].z, v[u].z, e4[2]);
        e4[3] = fmaf(v[u].w, v[u].w, e4[3]);
      }
    }
  }
  for (int u = tid; u < n; u += kThreads) colr[u] = __ldg(hcol + (u == 0 ? 0 : n - u));
  // lanes l, l ^ 4, l ^ 8, l ^ 16 hold the same 4 series, then the warps
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float e = e4[c];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) e += __shfl_xor_sync(kFullMask, e, off);
    if (lane < 4) red[warp][lseries + c][0].x = e;
  }
  __syncthreads();
  if (tid < kSeries) {
    float e = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) e += red[q][tid][0].x;
    energy[tid] = e / static_cast<float>(n);
  }
  if (tid == 0) queued = 0;

  // forward transform, pass by pass; a fixed-radix last pass also does the
  // multiplier and the first inverse pass
  int len = n;
  for (int st = 0; st < plan.stages;) {
    const int r = plan.radix[st];
    const bool fused = (plan.fused >> st) & 1;
    const int span = fused ? 2 : 1;
    const bool last = st + span == plan.stages;
    if (last && r <= 5) {
      stage<kMiddle>(buf, n, len, r, fused, true, tw, gain);
    } else {
      stage<kForward>(buf, n, len, r, fused, last, tw, gain);
    }
    __syncthreads();
    len /= fused ? r * r : r;
    st += span;
  }
  if (plan.stages == 0) {  // T = 1: the multiplier alone (it is 0)
    if (tid < kSeries) buf[tid] = hilbert_gain(buf[tid], __ldg(gain));
    __syncthreads();
  }
  // inverse transform: the adjoint passes, last to first
  for (int st = plan.stages - 1; st >= 0;) {
    const bool fused = st > 0 && ((plan.fused >> (st - 1)) & 1);
    const int first = fused ? st - 1 : st;
    const int r = plan.radix[first];
    len *= fused ? r * r : r;
    if (!(st == plan.stages - 1 && r <= 5)) {  // else done by the middle pass
      stage<kAdjoint>(buf, n, len, r, fused, false, tw, gain);
      __syncthreads();
    }
    st = first - 1;
  }

  // x again (from L2), exact, into the imaginary parts (the inverse
  // transform leaves rounding noise about 0 there), and im = F x + N x, the
  // near taps summed after the FFT's part, nearest last: thread (series s,
  // chunk) walks its rows in order, kGroup at a time, with x[t - kNear ..
  // t + kGroup - 1 + kNear] in registers (its loads of a group in flight
  // together). The samples near z = 0 are queued.
  {
    const int s = tid % kSeries, chunk = tid / kSeries;
    const int w = s / kC;
    const float* xs = x + static_cast<size_t>(b0 + w) * n * kC + s % kC;  // x[t] of series s is xs[t kC]
    const bool live = b0 + w < batch;
    const int taps = min(kNear, (n - 1) / 2);
    float before[kNear], after[kNear];  // col[d] (times x[t - d]) and col[n - d] (times x[t + d])
#pragma unroll
    for (int d = 1; d <= kNear; ++d) {
      before[d - 1] = d <= taps ? colr[n - d] : 0.0f;
      after[d - 1] = d <= taps ? colr[d] : 0.0f;
    }
    const float limit = kRefineBelow * energy[s];
    const int span = (n + kThreads / kSeries - 1) / (kThreads / kSeries);
    const int t0 = chunk * span, t1 = min(n, t0 + span);
    // x[tu], tu < n + kNear + 2 kGroup: one subtraction wraps it when n is
    // at least that
    const bool short_n = n < kNear + 2 * kGroup;
    auto load = [&](int tu) {
      return live ? __ldg(xs + (short_n ? tu % n : (tu >= n ? tu - n : tu)) * kC) : 0.0f;
    };
    float win[2 * kNear + kGroup];  // x[t - kNear + j]
    float next[kGroup];             // the next group's new rows, in flight
    if (t0 < t1) {
#pragma unroll
      for (int j = 0; j < 2 * kNear; ++j) win[j] = live ? __ldg(xs + wrap(t0 - kNear + j, n) * kC) : 0.0f;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) next[u] = load(t0 + kNear + u);
    }
    for (int t = t0; t < t1; t += kGroup) {
      float far[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        win[2 * kNear + u] = next[u];
        far[u] = t + u < t1 ? buf[(t + u) * kSeries + s].x : 0.0f;
      }
      if (t + kGroup < t1) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) next[u] = load(t + kGroup + kNear + u);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (t + u < t1) {
          float im = far[u];
#pragma unroll
          for (int d = kNear; d >= 1; --d) {
            im = fmaf(before[d - 1], win[u + kNear - d], im);
            im = fmaf(after[d - 1], win[u + kNear + d], im);
          }
          const float re = win[u + kNear];
          buf[(t + u) * kSeries + s] = make_float2(im, re);
          if (fmaf(im, im, re * re) < limit) {
            queue[atomicAdd(&queued, 1)] = static_cast<unsigned short>((t + u) * kSeries + s);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * kNear; ++j) win[j] = win[j + kGroup];
    }
  }
  __syncthreads();

  // near z = 0, im as the reference's dense float32 product: the queued
  // chains side by side, a thread each, in rounds of kThreads (they read
  // only x, so writing im in place is safe)
  const int count = queued;
  for (int q = tid; q < count; q += kThreads) {
    const int i = queue[q];
    buf[i].x = chain_im(buf, colr, n, i / kSeries, i % kSeries);
  }
  __syncthreads();

  // c2/s2 and the 36 pair sums, kRows rows at a time: each group of rows
  // is summed, then added to the thread's Kahan-compensated sums
  const int s = tid % kSeries, c = s % kC;
  float sum[kDiag], comp[kDiag];
#pragma unroll
  for (int d = 0; d < kDiag; ++d) sum[d] = comp[d] = 0.0f;
  const int rows = (n + kRowStep - 1) / kRowStep;  // the same count on every lane: shuffles below
  for (int k0 = 0; k0 < rows; k0 += kRows) {
    float c2[kRows], s2[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = tid / kSeries + (k0 + u) * kRowStep;
      c2[u] = s2[u] = 0.0f;  // a row past the end adds nothing
      if (t < n) {
        const float2 v = buf[t * kSeries + s];
        cos_sin_2phi(v.y, v.x, c2[u], s2[u]);
      }
    }
#pragma unroll
    for (int d = 0; d < kDiag; ++d) {
      float group = 0.0f;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float c2d = d == 0 ? c2[u] : __shfl_sync(kFullMask, c2[u], (c + d) & 7, kC);
        const float s2d = d == 0 ? s2[u] : __shfl_sync(kFullMask, s2[u], (c + d) & 7, kC);
        group += c2[u] * c2d + s2[u] * s2d;
      }
      const float y = group - comp[d];
      const float total_d = sum[d] + y;
      comp[d] = (total_d - sum[d]) - y;
      sum[d] = total_d;
    }
  }

  // tree in (hi, lo) pairs, each sum rounded once at the end: lanes l and
  // l ^ 16 hold the same series, then the warps
#pragma unroll
  for (int d = 0; d < kDiag; ++d) {
    float hi = sum[d], lo = -comp[d];
    add_pair(hi, lo, __shfl_xor_sync(kFullMask, hi, 16), __shfl_xor_sync(kFullMask, lo, 16));
    if (lane < kSeries) red[warp][lane][d] = make_float2(hi, lo);
  }
  __syncthreads();
  if (tid < kSeries * kDiag) {
    const int so = tid / kDiag, d = tid % kDiag;
    const int co = so % kC, wo = so / kC;
    float hi[kWarps], lo[kWarps];
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      hi[q] = red[q][so][d].x;
      lo[q] = red[q][so][d].y;
    }
#pragma unroll
    for (int half = kWarps / 2; half > 0; half >>= 1) {
#pragma unroll
      for (int q = 0; q < half; ++q) add_pair(hi[q], lo[q], hi[q + half], lo[q + half]);
    }
    const float v = hi[0] + lo[0];
    if (b0 + wo < batch && (d < 4 || co < 4)) {  // d = 4: lanes 0..3 own the pairs (c, c + 4)
      const int j = (co + d) & 7;
      const int i = min(co, j), jj = max(co, j);
      float* g = out + static_cast<size_t>(b0 + wo) * kC * kC;
      g[i * kC + jj] = v;
      g[jj * kC + i] = v;
    }
  }
}

}  // namespace

extern "C" {

// Largest window length: its complex series, the operator column and
// the queue fit in one block's shared memory beside the reduction
// buffer, and a direct-DFT stage of that length fits one round.
int nsd_kuramoto_pair_sums_max_t() {
  const int by_smem = (kMaxSmemBytes - kRedBytes) / kBytesPerT;
  return by_smem < kMaxDirect ? by_smem : kMaxDirect;
}

// The near-zero threshold, kRefineBelow.
float nsd_kuramoto_pair_sums_refine_below() { return kRefineBelow; }

// x [batch, t_len, 8] float32, contiguous; tables [4 t_len] float32: the
// twiddles exp(-2 pi i m / t_len) as (re, im) pairs, the multiplier
// (h_k - 1) / t_len in the forward transform's output order, and the
// first column of the Hilbert operator (H[t, k] = col[(t - k) mod t_len]);
// radices
// [stages] on the host, product t_len; out [batch, 8, 8] float32. All
// device pointers on the current device. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success).
int nsd_kuramoto_pair_sums(const float* x, const float* tables, float* out, int batch, int t_len,
                           const int* radices, int stages, void* stream) {
  if (batch <= 0) return 0;
  if (t_len <= 0 || t_len > nsd_kuramoto_pair_sums_max_t() || stages < 0 || stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  plan.stages = stages;
  long long product = 1;
  for (int i = 0; i < kMaxStages; ++i) {
    plan.radix[i] = i < stages ? radices[i] : 0;
    if (i < stages) {
      if (radices[i] < 2) return static_cast<int>(cudaErrorInvalidValue);
      product *= radices[i];
    }
  }
  if (product != t_len) return static_cast<int>(cudaErrorInvalidValue);
  // pair equal radix-4 or radix-5 stages from the end, so that the last
  // pass (fused with the multiplier) is a pair whenever it can be
  plan.fused = 0;
  for (int st = stages - 1; st >= 1;) {
    const int r = plan.radix[st];
    if ((r == 4 || r == 5) && plan.radix[st - 1] == r) {
      plan.fused |= 1u << (st - 1);
      st -= 2;
    } else {
      st -= 1;
    }
  }
  const size_t smem = static_cast<size_t>(t_len) * kBytesPerT;
  cudaError_t err = cudaFuncSetAttribute(
      pair_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kWin - 1) / kWin;
  pair_sums_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const float2*>(tables), tables + 2 * static_cast<size_t>(t_len),
      tables + 3 * static_cast<size_t>(t_len), out, batch, t_len, plan);
  return static_cast<int>(cudaGetLastError());
}

const char* nsd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
