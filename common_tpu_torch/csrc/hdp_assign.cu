// Score-and-assign of the dense HDP-LDA sweep: for every valid token t of
// doc d with word w,
//
//     z_t = argmax_k [ log theta_dk + log phi_kw + Gumbel_tk ],
//
// the first k of the largest score, with the doc's topic counts n_dk of the
// new z. A masked token keeps its z and is counted nowhere.
//
// Replaces no TPU kernel: the JAX package runs this stage as plain `jnp`
// (common_tpu/topic/hdp.py `blocked_sweep_dense`), and the port ran it as
// about fifteen ATen launches a chunk of docs, which wrote and read a
// [docs, L, K] float32 score table some eight times (the gather of log phi,
// the uniform draw, its two logs, the argmax, the doc counts). Here the
// table never reaches device memory.
//
// What bounds it on an H100, at the benchmark's shape (1M docs of 50
// tokens, K = 32, V = 10,000; a launch takes 20,000 docs):
// - bytes, counted once: a token's word (8 B), mask (4 B) and old z (4 B)
//   read and its z written (4 B); log theta read and the counts written
//   ([D, K], 4 B each); log phi ([V, K], 1.28 MB) stays in the 50 MB L2.
//   Each token reads its word's 128 B row of log phi from L2: 6.4 GB a
//   sweep of L2 reads;
// - the noise: K Gumbel draws a token, each a quarter of a Philox4x32-10
//   call and two accurate logf, 1.6e9 draws a sweep if every one is made.
// So the kernel is bound by the noise's instructions, then by L2.
//
// Design:
// - A block takes whole docs: as many as its 256 threads hold tokens (5 of
//   50 tokens here), or one doc whose tokens its threads walk in turn where
//   a doc is longer than the block. It stages the docs' log theta rows and
//   their integer topic counters in shared memory; a thread takes a token,
//   with its running max and index over k in registers, and counts its
//   topic into the doc's counters with a shared-memory atomic (integer, so
//   the order does not matter). The counts are written once a doc, as
//   float32. No global atomics, no scratch column.
// - The loop over k runs in groups of four: one Philox call a group, its
//   words (x, y, z, w) the uniforms of topics 4 g .. 4 g + 3, counter
//   (token, g, token >> 32, 3) keyed on (seed, 0x5EED)
//   (`philox::hdp_words`); log phi and log theta as float4 loads where K is
//   a multiple of 4 (and log phi 16-byte aligned), else one float at a
//   time. The draws are a pure function of (seed, global token index, k):
//   the chunking and the launch geometry change nothing.
// - The arithmetic is the plain version's (ops/hdp_assign.py
//   `hdp_assign_plain`): (log theta + log phi) + Gumbel in float32, each
//   sum rounded on its own; the max moves only on a strictly greater score
//   in increasing k, so the lowest k wins ties, as in torch.argmax.
// - A logarithm only where it can matter. Each draw's Philox word is made,
//   but its two logarithms are taken only where the topic can still win. A
//   draw is less than (n + 1) ln 2, n the leading ones of its uniform's 24
//   bits (`gumbel_above`: -log u > 1 - u), and at least -2.77996, so the
//   winner scores at least the doc's top topic's noise-free score less that
//   (`kLeast`). A topic whose score plus its bound lies below that, or below
//   the best drawn so far, cannot win, and its logarithms are not taken.
//   Both bounds hold for the draws as rounded, and a rounded sum is monotone
//   in its terms, so z is the same, bit for bit, as with every logarithm
//   taken. A warp takes a topic's logarithms where
//   any of its tokens needs them, so only topics out of contention for the
//   whole warp are saved.
//
// Shapes: any D, L >= 0 and 1 <= K <= kMaxTopics (the shared memory of one
// doc); word ids must lie in [0, V).
#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;
// a doc's log theta row and counters, plus its top topic, in kSmemBytes
constexpr int kMaxTopics = (kSmemBytes - 4) / 8;

// The least a draw of `philox::gumbel_of_bits` can be, -log(-log(1e-7)) =
// -2.77996, with a margin for the draw's own rounding (its two logf err by
// about 1e-6). Rounding a sum is monotone, so the scores need no margin.
constexpr float kLeast = 2.781f;

// An upper bound of `philox::gumbel_of_bits(bits)` without a logarithm. With
// n the leading ones of the uniform's 24 bits (at most 24), u < 1 - 2^-(n+1),
// and -log(-log u) < -log(2^-(n+1)) = (n+1) ln 2, since -log u > 1 - u; the
// 1e-3 covers the rounding of the draw (about 1e-6) and of this product.
__device__ __forceinline__ float gumbel_above(uint32_t bits) {
  const int ones = min(__clz(~bits), 24);
  return __fmaf_rn(static_cast<float>(ones + 1), 0.69314718f, 1e-3f);
}

__device__ __forceinline__ void load4(const float* p, int q, int K, bool vec, float out[4]) {
  if (vec) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r] = 4 * q + r < K ? p[4 * q + r] : 0.0f;
  }
}

__device__ __forceinline__ void ldg4(const float* p, int q, int K, bool vec, float out[4]) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r] = 4 * q + r < K ? __ldg(p + 4 * q + r) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    hdp_assign_kernel(const long long* __restrict__ words, const float* __restrict__ mask,
                      const int* __restrict__ z_old, const float* __restrict__ log_theta,
                      const float* __restrict__ log_phi_t, const int* __restrict__ seed_ptr, int* __restrict__ z,
                      float* __restrict__ dk, int D, int L, int K, int V, long long doc0, int docs_per_block,
                      bool vec) {
  extern __shared__ float4 smem4[];
  float* theta = reinterpret_cast<float*>(smem4);                    // [docs, K] log theta
  int* counts = reinterpret_cast<int*>(theta + docs_per_block * K);  // [docs, K]
  int* top = counts + docs_per_block * K;                            // [docs]: each doc's largest log theta
  const int d_first = blockIdx.x * docs_per_block;
  const int nd = min(docs_per_block, D - d_first);
  const long long row0 = static_cast<long long>(d_first) * K;
  for (int i = threadIdx.x; i < nd * K; i += blockDim.x) {
    theta[i] = log_theta[row0 + i];
    counts[i] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nd; j += blockDim.x) {
    const float* th = theta + j * K;
    int arg = 0;
    for (int k = 1; k < K; ++k) arg = th[k] > th[arg] ? k : arg;
    top[j] = arg;
  }
  __syncthreads();

  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_ptr));
  const int groups = (K + 3) / 4;
  const long long tok0 = static_cast<long long>(d_first) * L;
  for (int i = threadIdx.x; i < nd * L; i += blockDim.x) {
    const long long t = tok0 + i;  // the token within the launch
    if (!(mask[t] > 0.0f)) {
      z[t] = z_old[t];
      continue;
    }
    const int j = i / L;
    const long long w = words[t];
    assert(w >= 0 && w < V);
    const float* phi = log_phi_t + w * K;
    const float* th = theta + j * K;
    const unsigned long long g = static_cast<unsigned long long>(doc0) * L + t;  // the corpus's token index
    const uint32_t lo = static_cast<uint32_t>(g), hi = static_cast<uint32_t>(g >> 32);
    // the doc's top topic scores at least this with its noise, so the winner does too
    const float least = __fadd_rn(__fadd_rn(th[top[j]], __ldg(phi + top[j])), -kLeast);
    float best = -INFINITY;
    int arg = 0;
    for (int q = 0; q < groups; ++q) {
      float a[4], p[4];
      load4(th, q, K, vec, a);
      ldg4(phi, q, K, vec, p);
      const uint4 bits = philox::hdp_words(seed, lo, static_cast<uint32_t>(q), hi);
      const uint32_t b[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (4 * q + r >= K) break;
        const float s = __fadd_rn(a[r], p[r]);
        if (__fadd_rn(s, gumbel_above(b[r])) < fmaxf(least, best)) continue;  // it cannot win: no logarithm
        const float v = __fadd_rn(s, philox::gumbel_of_bits(b[r]));
        if (v > best) {
          best = v;
          arg = 4 * q + r;
        }
      }
    }
    z[t] = arg;
    atomicAdd(counts + j * K + arg, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nd * K; i += blockDim.x) dk[row0 + i] = static_cast<float>(counts[i]);
}

constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

int hdp_assign_max_topics() { return kMaxTopics; }

// words [D, L] int64, mask [D, L] float32, z_old [D, L] int32, log_theta
// [D, K] float32, log_phi_t [V, K] float32, seed [1] int32; outputs z [D, L]
// int32 and dk [D, K] float32. `doc0` is the corpus index of the first doc
// (the noise's token index is (doc0 + d) L + l). All on device `device`,
// contiguous; 1 <= K <= hdp_assign_max_topics(). The launch goes to
// `stream`; the calling thread's current device is set to `device` for it
// and restored after. Returns the CUDA error code of the launch (0 on
// success).
int hdp_assign_launch(const long long* words, const float* mask, const int* z_old, const float* log_theta,
                      const float* log_phi_t, const int* seed, int* z, float* dk, int D, int L, int K, int V,
                      long long doc0, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (K < 1 || K > kMaxTopics || D < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int by_tokens = L < kThreads ? kThreads / (L > 0 ? L : 1) : 1;
  const int by_smem = kSmemBytes / (8 * K + 4);
  const int per_block = by_tokens < by_smem ? by_tokens : by_smem;
  const int blocks = (D + per_block - 1) / per_block;
  const size_t bytes = static_cast<size_t>(per_block) * (8 * K + 4);
  const auto s = static_cast<cudaStream_t>(stream);
  // float4 rows of log phi where K is a multiple of 4 and the table is 16-byte aligned
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(log_phi_t) % 16 == 0;
  hdp_assign_kernel<<<blocks, kThreads, bytes, s>>>(words, mask, z_old, log_theta, log_phi_t, seed, z, dk, D, L, K,
                                                    V, doc0, per_block, vec);
  const int rc = static_cast<int>(cudaGetLastError());
  if (prev != device && (err = cudaSetDevice(prev)) != cudaSuccess && rc == 0) return static_cast<int>(err);
  return rc;
}

}  // extern "C"
