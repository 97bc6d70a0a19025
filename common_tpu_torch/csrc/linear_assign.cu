// Fused linear score + Gumbel + argmax: the blocked-Gibbs assignment draw for
// likelihoods whose score is affine in the row,
//
//     z_n = argmax_k [ base_k + x_n . w_k + Gumbel_nk ].
//
// For the vector Beta-Bernoulli (bbv), w_k = log p_k - log(1 - p_k) and
// base_k = log w_k + sum_d log(1 - p_kd).
//
// Replaces the Pallas kernel common_tpu/ops/linear_assign.py `_linear_kernel`
// (called by `fused_linear_assign`). Like it, the [N, K] score and noise
// tables never reach device memory: X is read once and z written once.
//
// What bounds it on an H100, at config 2's shape (N = 100k, D = 64, K = 32):
// - bytes: X once, 25.6 MB, and z, 0.4 MB: 7.8 us at 3.35 TB/s;
// - the product, 2*N*K*D = 4.1e8 operations: 6.1 us on the CUDA cores at
//   67 TFLOP/s of fp32, 2.5 us as three TF32 passes at 495 TFLOP/s (about
//   twice that at mma.sync's rate);
// - the noise, N*K = 3.2M Gumbel draws if every one is drawn: a
//   Philox4x32-10 call (tens of integer instructions) and two accurate logf
//   (about 20 instructions each) a draw, more issue slots than the product;
// - latency: the grid is under three 128-row tiles deep on each SM, so each
//   tile's chain of dependent steps (the product, the row's top score, the
//   noise, the argmax across a quad) is what a step costs.
// The kernel is bound by those chains and the instructions in them, not by
// bytes (0.47 of the byte bound with X in L2; PERF.md).
//
// Design (each point was timed against its alternative on one H100;
// scripts/linear_variants.py rebuilds the alternatives, PERF.md has the
// numbers):
// - Noise only where it can matter. A draw lies in [-2.79, 16.64] (u in
//   [1e-7, 1 - 2^-24]), so a cluster more than 19.42 nats below the top
//   score of its panel cannot win, whatever its noise (philox::kReach).
//   Each lane marks its clusters within reach; the warp lists the groups of
//   four that hold one (ballots in slot order), and each lane makes the
//   Philox call of one listed group a round and takes its four words'
//   logarithms side by side, keeping those of its clusters within reach
//   (-inf for the others). After a few sweeps of config 2 about one cluster
//   a row is within reach; at the chain's CRP start, with the clusters
//   close together, about 8 of 32 are, and the kernel takes longer (PERF.md).
//   The draw is the same as with every draw made: the noise of a cluster
//   that is drawn is the stream's own.
// - Four draws a Philox call: the counter (row, k / 4, 0, 1) gives its four
//   words to clusters 4 (k / 4) .. 4 (k / 4) + 3 (`philox::linear_words`), a
//   pure function of (seed, row, k), so the draws do not depend on the
//   tiling. The counter's last word, 1, keeps the stream apart from the
//   Gaussian kernels' (last word 0). The seed is read from device memory.
// - The product on the tensor cores as 3xTF32 split products (tf32x3.cuh,
//   m16n8k8): each operand split into a TF32 high part and the fp32 rest,
//   three passes accumulated in fp32, so the scores keep fp32 accuracy; no
//   product is a single TF32 pass. On the CUDA cores the same product took
//   twice as long. Each warp scores 16 rows against a panel of 32
//   clusters, four n8 tiles. The panel's rows sit in shared memory permuted
//   (`panel_cluster`) so that lane (g, t) holds clusters 16q + 4t .. 16q +
//   4t + 3 of its two rows for q = 0, 1: a group of four clusters is one
//   lane's, and a row's 32 scores are spread over its quad. The running
//   (max, argmax) moves only on a strictly greater score within a lane, in
//   increasing k, and the quad's shuffles keep the lower k on a tie, so the
//   lowest k wins ties, as in Pallas and torch.argmax. Where a tile takes
//   one step (K <= 32, D <= 64: config 2), W's fragments are split into
//   their TF32 halves once a block and stay in shared memory.
// - A pipelined, persistent grid: as many blocks of 8 warps as fit on the
//   SMs (two per SM), each walking 128-row tiles through a ring of two
//   stages filled by cp.async, with no register staging; the next step's
//   copy is queued right after the barrier that frees its stage, ahead of
//   the products. A block's steps are (tile, 32-cluster panel, 64-input
//   chunk); where W is not resident each stage also holds the panel's W
//   chunk.
//
// Shapes: any N, D and K. Rows past N, inputs past D and clusters past K
// are zero-filled in shared memory and add exactly 0; a cluster past K gets
// -inf and is never chosen. Rows of 16-byte-aligned width go by 16-byte
// copies, other widths by 4-byte copies. K above 32 takes more panels, D
// above 64 more chunks (X is then read again for each panel, from L2).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // a tile: one m16 tile a warp
constexpr int kPanel = 32;          // clusters of a panel: four n8 tiles
constexpr int kChunk = 64;          // inputs of a step
constexpr int kStages = 2;
// Row stride of X and W in a stage, 8 mod 16 floats: the 8-byte fragment
// loads of a half-warp hit 32 distinct banks.
constexpr int kLd = kChunk + 8;
constexpr int kXFloats = kRows * kLd;                    // a stage's X chunk
constexpr int kWFloats = kPanel * kLd;                   // a stage's chunk of the panel's W
constexpr int kSplitFloats = (kChunk / 8) * 4 * 32 * 4;  // W split: 8 steps x 4 n8 tiles x 32 lanes x {hi, hi, lo, lo}
constexpr int kSlots = 4;                                // a lane's (row, group of four clusters) pairs of a panel
constexpr int kListFloats = kWarps * kSlots * 32;        // each warp's list of the slots it draws noise for
constexpr int kDrawFloats = kWarps * 32 * 4;             // each warp's round of draws, a float4 a lane

// Shared memory: the lists and draws; where W is resident, its split
// fragments; then the stages, each an X chunk and, where W is not
// resident, the panel's W chunk.
constexpr int smem_floats(bool resident) {
  return kListFloats + kDrawFloats + (resident ? kSplitFloats + kStages * kXFloats : kStages * (kXFloats + kWFloats));
}
static_assert(smem_floats(false) >= smem_floats(true), "the launch sets the streamed layout's size");

// W is resident, split once a block, where a tile takes one step.
__host__ __device__ inline bool w_resident(int D, int K) { return K <= kPanel && D <= kChunk; }

// The panel cluster that row r = 8j + c of a stage's W chunk holds, j = 2p +
// h the n8 tile, c its fragment column: 16p + 4(c / 2) + 2h + c % 2. So
// accumulator columns 2t and 2t + 1 of tiles 2p and 2p + 1 are clusters
// 16p + 4t .. 16p + 4t + 3.
__device__ __forceinline__ int panel_cluster(int r) {
  const int j = r >> 3, c = r & 7;
  return 16 * (j >> 1) + 4 * (c >> 1) + 2 * (j & 1) + (c & 1);
}

__global__ void __launch_bounds__(kThreads, 2)
linear_assign_kernel(const float* __restrict__ X, const float* __restrict__ W,
                     const float* __restrict__ base, const int* __restrict__ seed_ptr,
                     int* __restrict__ z, int N, int D, int K, bool vec) {
  using namespace tf32x3;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragment layouts' group and thread
  const int wrow = 16 * warp + g;         // this lane's rows of a tile: wrow, wrow + 8
  const bool resident = w_resident(D, K);
  int* reqs = reinterpret_cast<int*>(smem) + warp * kSlots * 32;
  float4* draws = reinterpret_cast<float4*>(smem + kListFloats) + warp * 32;
  uint4* wsplit = reinterpret_cast<uint4*>(smem + kListFloats + kDrawFloats);
  float* stages = smem + kListFloats + kDrawFloats + (resident ? kSplitFloats : 0);
  const int stage_floats = kXFloats + (resident ? 0 : kWFloats);
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const int n_tiles = (N + kRows - 1) / kRows;
  const int n_chunks = D > kChunk ? (D + kChunk - 1) / kChunk : 1;
  const int per_tile = ((K + kPanel - 1) / kPanel) * n_chunks;
  const int T = ((n_tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1) * per_tile;

  // Queue this block's next step (tile, panel, chunk) into its stage;
  // always commit a group, so the wait below counts uniformly. The counters
  // advance by one step a call, so no division runs per step.
  int nx_p = 0, nx_st = 0, nx_tile = blockIdx.x, nx_k0 = 0, nx_d0 = 0;
  auto enqueue = [&]() {
    if (nx_p < T) {
      float* xs = stages + nx_st * stage_floats;
      float* ws = xs + kXFloats;
      const int row0 = nx_tile * kRows;
      const bool with_w = !resident && (per_tile > 1 || nx_p < kStages);
      if (vec) {
        // thread tid copies piece tid % 16 of rows tid / 16 + 16i
        constexpr int kPieces = kChunk / 4, kRowStep = kThreads / kPieces;
        const int r = tid / kPieces, q = (tid % kPieces) * 4;
        const bool q_in = nx_d0 + q < D;
        const float* src = X + static_cast<size_t>(row0 + r) * D + nx_d0 + q;
#pragma unroll
        for (int i = 0; i < kRows / kRowStep; ++i) {
          const bool in = q_in && row0 + r + kRowStep * i < N;
          cp_async16(xs + (r + kRowStep * i) * kLd + q, in ? src + static_cast<size_t>(kRowStep * i) * D : X,
                     in ? 16 : 0);
        }
        if (with_w) {
#pragma unroll
          for (int c = tid; c < kPanel * kPieces; c += kThreads) {
            const int r = c / kPieces, q = (c % kPieces) * 4;
            const int k = nx_k0 + panel_cluster(r);
            const bool in = k < K && nx_d0 + q < D;
            cp_async16(ws + r * kLd + q, in ? W + static_cast<size_t>(k) * D + nx_d0 + q : W, in ? 16 : 0);
          }
        }
      } else {
        for (int c = tid; c < kRows * kChunk; c += kThreads) {
          const int r = c / kChunk, q = c % kChunk;
          const bool in = row0 + r < N && nx_d0 + q < D;
          cp_async4(xs + r * kLd + q, in ? X + static_cast<size_t>(row0 + r) * D + nx_d0 + q : X, in ? 4 : 0);
        }
        if (with_w) {
          for (int c = tid; c < kPanel * kChunk; c += kThreads) {
            const int r = c / kChunk, q = c % kChunk;
            const int k = nx_k0 + panel_cluster(r);
            const bool in = k < K && nx_d0 + q < D;
            cp_async4(ws + r * kLd + q, in ? W + static_cast<size_t>(k) * D + nx_d0 + q : W, in ? 4 : 0);
          }
        }
      }
      ++nx_p;
      nx_st = nx_st + 1 == kStages ? 0 : nx_st + 1;
      if ((nx_d0 += kChunk) >= D) {
        nx_d0 = 0;
        if ((nx_k0 += kPanel) >= K) {
          nx_k0 = 0;
          nx_tile += gridDim.x;
        }
      }
    }
    cp_async_commit();
  };

  for (int p = 0; p < kStages - 1; ++p) enqueue();

  if (resident) {
    // lane l's B fragments of step s and n8 tile j, split once
    for (int e = tid; e < (kChunk / 8) * 4 * 32; e += kThreads) {
      const int l = e & 31, j = (e >> 5) & 3, s = e >> 7;
      const int k = panel_cluster(8 * j + (l >> 2)), d = 8 * s + 2 * (l & 3);
      const float w0 = k < K && d < D ? W[k * D + d] : 0.0f;
      const float w1 = k < K && d + 1 < D ? W[k * D + d + 1] : 0.0f;
      uint4 v;
      split(w0, v.x, v.z);
      split(w1, v.y, v.w);
      wsplit[e] = v;
    }
    __syncthreads();
  }

  // acc[j]: n8 tile j, in the accumulator layout: (row g, column 2t), (g,
  // 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Slot 2h + q of a lane is row
  // wrow + 8h with the group of panel clusters 16q + 4t .. 16q + 4t + 3;
  // its cluster 16q + 4t + i is column 2t + i % 2 of tile 2q + i / 2.
  float acc[4][4];
  float best[2];
  int arg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best[h] = -INFINITY;
    arg[h] = 0;
  }
  int tile = blockIdx.x, k0 = 0, d0 = 0, st = 0;

  for (int p = 0; p < T; ++p) {
    if (d0 == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }

    cp_async_wait<kStages - 2>();
    __syncthreads();  // step p has landed; the stage of step p - 1 is free
    enqueue();

    const float* xs = stages + st * stage_floats;
    const float* ws = xs + kXFloats;
    const int steps = min(kChunk / 8, (D - d0 + 7) / 8);  // 8-input steps holding inputs below D
    // fragment input t is column 2t of the step and input t + 4 column 2t +
    // 1, in both operands; b_fragments(s, j, bh, bl) gives n8 tile j's split
    // B fragment of step s
    const float* xw = xs + wrow * kLd + 2 * t;
    auto product = [&](auto b_fragments) {
#pragma unroll
      for (int s = 0; s < kChunk / 8; ++s) {
        if (s < steps) {
          uint32_t ah[4], al[4];
          const float2 x0 = *reinterpret_cast<const float2*>(xw + 8 * s);
          const float2 x1 = *reinterpret_cast<const float2*>(xw + 8 * kLd + 8 * s);
          split(x0.x, ah[0], al[0]);  // row g,     input t
          split(x1.x, ah[1], al[1]);  // row g + 8, input t
          split(x0.y, ah[2], al[2]);  // row g,     input t + 4
          split(x1.y, ah[3], al[3]);  // row g + 8, input t + 4
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t bh[2], bl[2];
            b_fragments(s, j, bh, bl);
            mma(acc[j], al, bh);
            mma(acc[j], ah, bl);
            mma(acc[j], ah, bh);
          }
        }
      }
    };
    if (resident) {
      product([&](int s, int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
        const uint4 v = wsplit[(s * 4 + j) * 32 + lane];
        bh[0] = v.x;
        bh[1] = v.y;
        bl[0] = v.z;
        bl[1] = v.w;
      });
    } else {
      const float* bw = ws + g * kLd + 2 * t;
      product([&](int s, int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
        const float2 b = *reinterpret_cast<const float2*>(bw + j * 8 * kLd + 8 * s);
        split(b.x, bh[0], bl[0]);
        split(b.y, bh[1], bl[1]);
      });
    }

    if (d0 + kChunk >= D) {
      // The panel is scored. s: base_k + x . w_k, -inf past K.
      float bk[8];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 16 * q + 4 * t + i;
          bk[4 * q + i] = k < K ? __ldg(base + k) : -INFINITY;
        }
      float s[2][8], top[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[h][4 * q + i] = acc[2 * q + (i >> 1)][2 * h + (i & 1)] + bk[4 * q + i];
        top[h] = fmaxf(fmaxf(fmaxf(s[h][0], s[h][1]), fmaxf(s[h][2], s[h][3])),
                       fmaxf(fmaxf(s[h][4], s[h][5]), fmaxf(s[h][6], s[h][7])));
        top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
        top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
      }
      // The slots whose noise can matter, listed across the warp in slot
      // order: a cluster more than philox::kReach (plus 1e-5 of the top
      // score, for rounding) below the panel's top score can never win.
      int idx[kSlots], total = 0;
#pragma unroll
      for (int slot = 0; slot < kSlots; ++slot) {
        const int h = slot >> 1, q = slot & 1;
        unsigned words = 0;  // the slot's clusters within reach
        if (tile * kRows + wrow + 8 * h < N && k0 + 16 * q + 4 * t < K) {
          const float floor_h = top[h] - (philox::kReach + 1e-5f * fabsf(top[h]));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (s[h][4 * q + i] >= floor_h) words |= 1u << i;
        }
        const unsigned ball = __ballot_sync(0xffffffffu, words != 0u);
        idx[slot] = words ? total + __popc(ball & ((1u << lane) - 1u)) : -1;
        if (words) reqs[idx[slot]] = (words << 8) | (slot << 5) | lane;
        total += __popc(ball);
      }
      __syncwarp();
      // Each lane draws one listed slot's numbers a round: the four words'
      // logarithms side by side, as independent chains, kept only for the
      // clusters within reach (-inf for the others, which cannot win). Where
      // the rows lie near several clusters most words of a listed group are
      // within reach, and a chain for each word in turn was the longer wait.
      // Each slot's lane folds them in, in increasing k.
      float b[2];
      int a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[h] = -INFINITY;
        a[h] = 0;
      }
      for (int r0 = 0; r0 < total; r0 += 32) {
        if (r0 + lane < total) {
          const int v = reqs[r0 + lane], slot = (v >> 5) & 3, o = v & 31;
          const uint32_t row = tile * kRows + 16 * warp + (o >> 2) + 8 * (slot >> 1);
          const uint32_t group = (k0 >> 2) + 4 * (slot & 1) + (o & 3);
          const unsigned words = static_cast<unsigned>(v) >> 8;
          const uint4 bits = philox::linear_words(seed, row, group);
          const float g0 = philox::gumbel_of_bits(bits.x), g1 = philox::gumbel_of_bits(bits.y);
          const float g2 = philox::gumbel_of_bits(bits.z), g3 = philox::gumbel_of_bits(bits.w);
          draws[lane] = make_float4(words & 1u ? g0 : -INFINITY, words & 2u ? g1 : -INFINITY,
                                    words & 4u ? g2 : -INFINITY, words & 8u ? g3 : -INFINITY);
        }
        __syncwarp();
#pragma unroll
        for (int slot = 0; slot < kSlots; ++slot) {
          const int h = slot >> 1, q = slot & 1, j = idx[slot] - r0;
          if (j >= 0 && j < 32) {
            const float4 gv = draws[j];
            const float gum[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float lp = s[h][4 * q + i] + gum[i];
              if (lp > b[h]) {
                b[h] = lp;
                a[h] = k0 + 16 * q + 4 * t + i;
              }
            }
          }
        }
        __syncwarp();
      }
      // each row's best over its quad, then over panels
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, b[h], m);
          const int oa = __shfl_xor_sync(0xffffffffu, a[h], m);
          if (ob > b[h] || (ob == b[h] && oa < a[h])) {
            b[h] = ob;
            a[h] = oa;
          }
        }
        if (b[h] > best[h]) {  // later panels hold higher k: strictly greater only
          best[h] = b[h];
          arg[h] = a[h];
        }
      }
      if (k0 + kPanel >= K) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = tile * kRows + wrow + 8 * h;
          if (t == 0 && row < N) z[row] = arg[h];
          best[h] = -INFINITY;
          arg[h] = 0;
        }
      }
    }

    st = st + 1 == kStages ? 0 : st + 1;
    if ((d0 += kChunk) >= D) {
      d0 = 0;
      if ((k0 += kPanel) >= K) {
        k0 = 0;
        tile += gridDim.x;
      }
    }
  }
  cp_async_wait<0>();
}

// What a launch needs to know of a card, asked once a device: the SMs, and
// how many blocks fit on one, with W resident and without. Asking on every
// launch costs more host time than the kernel runs.
constexpr int kMaxDevices = 64;
struct DeviceFit {
  int sms = 0;
  int fit[2] = {0, 0};
};

// The launch on the current device, `dev`.
int launch(const float* X, const float* W, const float* base, const int* seed, int* z, int N, int D, int K,
           int dev, cudaStream_t stream) {
  static DeviceFit fits[kMaxDevices];
  const bool resident = w_resident(D, K);
  const int bytes = static_cast<int>(sizeof(float)) * smem_floats(resident);
  cudaError_t err;
  DeviceFit& f = fits[dev];
  if (f.sms == 0) {
    // the larger layout's shared memory, once: a smaller launch needs no other
    const int most = static_cast<int>(sizeof(float)) * smem_floats(false);
    if ((err = cudaFuncSetAttribute(linear_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most)) !=
        cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
  }
  int& fit = f.fit[resident];
  if (fit == 0 &&
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, linear_assign_kernel, kThreads, bytes)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int n_tiles = (N + kRows - 1) / kRows;
  const int blocks = fit * f.sms < n_tiles ? fit * f.sms : n_tiles;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = D % 4 == 0 && (addr(X) | addr(W)) % 16 == 0;
  linear_assign_kernel<<<blocks, kThreads, bytes, stream>>>(X, W, base, seed, z, N, D, K, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// X [N, D], W [K, D], base [K] float32; seed [1] int32; z [N] int32 output.
// All on device `device`, contiguous; N, K >= 1. The launch goes to
// `stream`; the calling thread's current device is set to `device` for it
// and restored after. Returns the CUDA error code of the launch (0 on
// success).
int linear_assign_launch(const float* X, const float* W, const float* base, const int* seed, int* z,
                         int N, int D, int K, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int rc = launch(X, W, base, seed, z, N, D, K, device, static_cast<cudaStream_t>(stream));
  if (prev != device && (err = cudaSetDevice(prev)) != cudaSuccess && rc == 0) return static_cast<int>(err);
  return rc;
}

}  // extern "C"
