// One slice-sampling update (Neal 2003) of one hyperparameter coordinate,
// wholly on the card: the placement of the interval, the step-out on both
// sides and the shrinkage, each test of the loop taken by the warp itself.
//
// Replaces no TPU kernel: the JAX package runs the update as a bounded
// `lax.while_loop` inside one compiled program (common_tpu/kernels/
// slice_.py `slice_sample`). The port ran that loop from the host, a
// read of a device value at each test and about 150 small launches at each
// evaluation of the target (the whole [K, D] marginal likelihood), so a
// config-2 iteration of 129 updates was the host making some 130,000
// launches. Here one launch does an update.
//
// The target is the coordinate's own term, evaluated in float64:
// - a bbv Beta hyper of column c (kind 0: alpha, 1: beta), the other hyper
//   of the column fixed: log Exp(v | rate) + sum over the slots k that hold
//   rows of lbeta(a + h_kc, b + n_k - h_kc) - lbeta(a, b);
// - the CRP concentration (kind 2): log Exp(v | rate) + K+ log v +
//   lgamma(v) - lgamma(v + N), K+ and N reduced from the counts.
// The other columns' terms and the partition's sum of lgamma(n_k) are the
// same on both sides of every test, so leaving them out changes no
// decision; outside v > 0 the target is -inf.
//
// What bounds it on an H100: latency. An update makes a few to a few dozen
// evaluations one after another, each a float64 lgamma chain on every lane
// and a shuffle reduction; the bytes (K counts, n and one column of heads,
// read from L2 after the first evaluation) and operations are nothing.
// Design:
// - One warp, one slot a lane (K > 32 loops), the sum by an xor butterfly,
//   so every lane holds the same total bit for bit and every branch of the
//   loop is uniform across the warp; lane 0 writes the result.
// - The level's uniform u comes in from device memory (the caller draws it
//   first, with the package's own generator) and y = f(x0) + log u. The
//   other uniforms are Philox4x32-10 keyed on (seed, 0x5EED): draw 0 places
//   the interval, draw j the j-th shrink proposal, four draws a call with
//   counter (j / 4, 0, 0, 2) (`philox::slice_words`).
// - The interval and the proposals are float32 arithmetic, each product and
//   sum rounded on its own (__fmul_rn, __fadd_rn, never contracted into an
//   fma), so the points are the ones the host loop computed in float32 and
//   the plain version in ops/slice_update.py repeats them bit for bit; the
//   float64 terms avoid contraction in the same way.
// - The caps are arguments: at most max_stepout steps a side, clipped to
//   [lower, upper], and max_shrink proposals, after which x0 stays.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
enum Kind : int { kAlpha = 0, kBeta = 1, kCrp = 2 };

struct Target {
  int kind;
  int K;
  int stride;           // the row stride of heads (D)
  double rate;          // the Exp prior's rate, and its log (set on the card)
  double log_rate;
  const float* other_c; // the column's other Beta hyper (kinds 0 and 1)
  double other;         // its value (set on the card)
  const float* n;       // [K] rows a slot
  const float* heads;   // heads of column c: heads[k * stride]
  const int* counts;    // [K]: a slot holds rows where its count is above 0
  double kplus, total;  // the CRP's K+ and N (kind 2)
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

__device__ __forceinline__ double lbeta(double a, double b) { return lgamma(a) + lgamma(b) - lgamma(a + b); }

// The coordinate's log target at v, the same on every lane.
__device__ double target(const Target& t, float vf) {
  const double v = vf;
  if (!(v > 0.0)) return -INFINITY;
  const double prior = __dsub_rn(t.log_rate, __dmul_rn(t.rate, v));
  if (t.kind == kCrp) return prior + (__dadd_rn(__dmul_rn(t.kplus, log(v)), lgamma(v)) - lgamma(v + t.total));
  const double a = t.kind == kAlpha ? v : t.other;
  const double b = t.kind == kAlpha ? t.other : v;
  const double base = lbeta(a, b);
  double acc = 0.0;
  for (int k = threadIdx.x; k < t.K; k += kWarp) {
    if (t.counts[k] > 0) {
      const double h = t.heads[static_cast<size_t>(k) * t.stride];
      const double tails = static_cast<double>(t.n[k]) - h;
      acc = acc + (lbeta(a + h, b + tails) - base);
    }
  }
  return prior + warp_sum(acc);
}

__device__ __forceinline__ float draw(uint32_t seed, int j) {
  const uint4 words = philox::slice_words(seed, static_cast<uint32_t>(j) >> 2);
  const int w = j & 3;
  return philox::uniform_open(w == 0 ? words.x : w == 1 ? words.y : w == 2 ? words.z : words.w);
}

__device__ __forceinline__ float clip(float v, float lower, float upper) { return fminf(fmaxf(v, lower), upper); }

// Stepping out from `edge` by `step` while the target there lies above y.
__device__ float step_out(const Target& t, double y, float edge, float step, float lower, float upper,
                          int max_stepout) {
  bool grow = target(t, edge) > y;
  for (int i = 0; i < max_stepout && grow; ++i) {
    const float next = clip(__fadd_rn(edge, step), lower, upper);
    if (next == edge) break;
    edge = next;
    grow = target(t, edge) > y;
  }
  return edge;
}

__global__ void __launch_bounds__(kWarp) slice_update_kernel(const float* x0p, float* out, const float* level,
                                                             const int* seedp, Target t, float w, float lower,
                                                             float upper, int max_stepout, int max_shrink) {
  t.log_rate = log(t.rate);
  if (t.kind != kCrp) t.other = *t.other_c;
  if (t.kind == kCrp) {
    double kplus = 0.0, total = 0.0;
    for (int k = threadIdx.x; k < t.K; k += kWarp) {
      kplus += t.counts[k] > 0 ? 1.0 : 0.0;
      total += static_cast<double>(t.counts[k]);
    }
    t.kplus = warp_sum(kplus);
    t.total = warp_sum(total);
  }
  const float x0 = *x0p;
  const uint32_t seed = static_cast<uint32_t>(*seedp);
  const double y = target(t, x0) + log(static_cast<double>(*level));

  const float lo0 = fmaxf(__fsub_rn(x0, __fmul_rn(draw(seed, 0), w)), lower);
  const float hi0 = fminf(__fadd_rn(lo0, w), upper);
  float lo = step_out(t, y, lo0, -w, lower, upper, max_stepout);
  float hi = step_out(t, y, hi0, w, lower, upper, max_stepout);

  float x1 = x0;
  for (int j = 1; j <= max_shrink; ++j) {
    const float xp = __fadd_rn(lo, __fmul_rn(draw(seed, j), __fsub_rn(hi, lo)));
    if (target(t, xp) >= y) {
      x1 = xp;
      break;
    }
    if (xp < x0)
      lo = xp;
    else
      hi = xp;
  }
  if (threadIdx.x == 0) *out = x1;
}

constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

// One update of the coordinate x0 [1] float32; x1 goes to out [1]. level
// [1] float32, the level's uniform; seed [1] int32. Kinds 0 and 1: other
// [D], n [K], heads [K, D] float32 and counts [K] int32 of column c; kind
// 2: counts alone (other, n and heads may be null). All on device
// `device`; the launch goes to `stream`, the calling thread's current
// device set to `device` for it and restored after. Returns the CUDA error
// code of the launch (0 on success).
int slice_update_launch(const float* x0, float* out, const float* level, const int* seed, const float* other,
                        const float* n, const float* heads, const int* counts, int kind, int c, int K, int D,
                        float rate, float w, float lower, float upper, int max_stepout, int max_shrink, int device,
                        void* stream) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (kind < kAlpha || kind > kCrp || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  Target t{};
  t.kind = kind;
  t.K = K;
  t.stride = D;
  t.rate = static_cast<double>(rate);
  t.n = n;
  t.counts = counts;
  if (kind != kCrp) {
    t.heads = heads + c;
    t.other_c = other + c;
  }
  slice_update_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(x0, out, level, seed, t, w, lower, upper,
                                                                         max_stepout, max_shrink);
  int rc = static_cast<int>(cudaGetLastError());
  if (prev != device && (err = cudaSetDevice(prev)) != cudaSuccess && rc == 0) rc = static_cast<int>(err);
  return rc;
}

}  // extern "C"
