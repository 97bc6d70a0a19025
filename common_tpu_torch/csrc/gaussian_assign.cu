// Fused Gaussian score + Gumbel + argmax: one blocked-Gibbs assignment draw
// for every row,
//
//     z_n = argmax_k [ base_k - 1/2 ||B_k (x_n - mu_k)||^2 + Gumbel_nk ].
//
// Replaces the Pallas kernels common_tpu/ops/gaussian_assign.py
// `_assign_kernel` (called by `fused_gaussian_assign`) and
// `_assign_chains_kernel` (called by `fused_gaussian_assign_chains`). Like
// them, the [N, K] score and noise tables never reach device memory: X is
// read once and z written once.
//
// The multi-chain form is the same kernel instantiated with kChains: C
// chains share X and own consecutive runs of K slots of mu, B and base
// (chain c owns slots cK .. cK + K - 1). The block loops over all C*K slots
// with its row tile still in shared memory, resets its running (max,
// argmax) at each chain's first slot and writes z[c, row] at its last, as
// the Pallas kernel does; so X is read once for all chains.
//
// What bounds it on Hopper: N*K*D^2 multiply-adds (4.3e12 at 1M x 256,
// K = 64), in fp32 FMA on the CUDA cores -- no TF32, no tensor cores, since
// reduced precision in this quadratic form biases the sampler
// (common_tpu/likelihoods/niw.py, sample_params_prec). So the design aims
// at keeping the FMA pipes fed from registers.
//
// Design: one block takes TILE_N = 128 rows and loops over the K clusters;
// the row tile stays in shared memory (transposed) for the whole launch.
// For each cluster, y = (x - mu_k) B_k^T is computed as a register-tiled
// product: each of the 256 threads owns an 8-row x 8-output tile of y
// (16 x 16 threads cover 128 rows x 128 outputs, and D = 256 takes two such
// output chunks), so each step over the inner dimension does 64 FMAs from
// 4 shared-memory vector loads (plus 8 subtractions forming x - mu in
// registers). One B_k at D = 256 is 256 KB, more than a block's 227 KB of
// shared memory, so B_k streams through shared memory in panels of
// 128 outputs x 32 inputs; the next panel is fetched into registers while
// the current one is used. The squares of each finished output chunk fold
// into 8 per-row partial forms, which a half-warp shuffle sums at the end
// of each cluster. The running (max, argmax) lives in registers and is
// updated only on a strictly greater score, so the lowest k wins ties, as
// in Pallas and torch.argmax.
//
// Gumbel noise: Philox4x32-10 keyed on the per-sweep seed with counter
// (row, k, c), k the slot within chain c, so the draws do not depend on the
// tiling and chain 0 draws exactly the single-chain kernel's noise. The seed
// is read from device memory, so the host never waits for the device to
// draw it.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kTileN = 128;           // rows per block
constexpr int kChunk = 128;           // outputs of y per chunk
constexpr int kPanel = 32;            // inputs (columns of B_k) per panel
constexpr int kThreads = 256;         // 16 row groups x 16 output groups
constexpr int kLd = 132;              // row stride of xt and bt: 16-byte aligned
constexpr int kPanelLoads = kChunk * kPanel / kThreads;  // panel values per thread

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Where value `idx` of a panel goes: input jj (0..31), output ii (0..127).
// A warp covers 8 consecutive inputs of 4 outputs, so its global reads are
// whole 32-byte sectors and its transposed stores hit 32 distinct banks.
__device__ __forceinline__ void panel_coords(int idx, int& jj, int& ii) {
  jj = (idx & 7) | (((idx >> 5) & 3) << 3);
  ii = ((idx >> 3) & 3) | ((idx >> 7) << 2);
}

// Fetch panel `t` of the flattened (cluster, chunk, panel) sequence into
// registers: bt[jj][ii] = B_k[c * kChunk + ii][p * kPanel + jj], 0 outside D.
__device__ __forceinline__ void fetch_panel(const float* __restrict__ binv, int t, int n_chunks,
                                            int n_panels, int D, float (&pre)[kPanelLoads]) {
  const int k = t / (n_chunks * n_panels);
  const int rem = t - k * n_chunks * n_panels;
  const int i0 = (rem / n_panels) * kChunk;
  const int j0 = (rem % n_panels) * kPanel;
  const float* bk = binv + static_cast<size_t>(k) * D * D;
#pragma unroll
  for (int r = 0; r < kPanelLoads; ++r) {
    int jj, ii;
    panel_coords(threadIdx.x + r * kThreads, jj, ii);
    const int i = i0 + ii, j = j0 + jj;
    pre[r] = (i < D && j < D) ? bk[static_cast<size_t>(i) * D + j] : 0.0f;
  }
}

// K is the number of slots per chain; C the number of chains (1 unless
// kChains). z is [C, N].
template <bool kChains>
__global__ void __launch_bounds__(kThreads, 1)
gaussian_assign_kernel(const float* __restrict__ X, const float* __restrict__ mu,
                       const float* __restrict__ binv, const float* __restrict__ base,
                       const int* __restrict__ seed_ptr, int* __restrict__ z, int N,
                       int D, int K, int C) {
  extern __shared__ float4 smem4[];
  const int Dp = round_up(D, kPanel);
  float* xt = reinterpret_cast<float*>(smem4);  // [Dp][kLd], row tile transposed
  float* bt = xt + static_cast<size_t>(Dp) * kLd;  // [kPanel][kLd], one panel of B_k^T
  float* mus = bt + kPanel * kLd;                 // [Dp], mu_k

  const int tid = threadIdx.x;
  const int tn = tid & 15;  // outputs 4tn..4tn+3 and 64+4tn..64+4tn+3 of a chunk
  const int tm = tid >> 4;  // rows 8tm..8tm+7 of the tile
  const int row0 = blockIdx.x * kTileN;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const int n_chunks = (D + kChunk - 1) / kChunk;
  const int n_panels = Dp / kPanel;
  const int per_cluster = n_chunks * n_panels;
  const int T = C * K * per_cluster;

  for (int idx = tid; idx < kTileN * Dp; idx += kThreads) {
    const int r = idx / Dp, j = idx - r * Dp;
    const int row = row0 + r;
    xt[j * kLd + r] = (row < N && j < D) ? X[static_cast<size_t>(row) * D + j] : 0.0f;
  }

  // lanes tn = 0..7 own row 8tm + tn of the running argmax
  const int my_row = row0 + tm * 8 + tn;
  float best = -INFINITY;
  int arg = 0;

  float pre[kPanelLoads];
  fetch_panel(binv, 0, n_chunks, n_panels, D, pre);
  float acc[8][8];
  float q[8];

  for (int t = 0; t < T; ++t) {
    const int k = t / per_cluster;  // slot over all chains
    const int rem = t - k * per_cluster;
    const int p = rem % n_panels;
    const bool first_of_cluster = rem == 0;
    const bool last_of_chunk = p == n_panels - 1;

    __syncthreads();  // the last panel (and, at a new cluster, mu) is consumed
#pragma unroll
    for (int r = 0; r < kPanelLoads; ++r) {
      int jj, ii;
      panel_coords(tid + r * kThreads, jj, ii);
      bt[jj * kLd + ii] = pre[r];
    }
    if (first_of_cluster) {
      for (int j = tid; j < Dp; j += kThreads) mus[j] = j < D ? mu[static_cast<size_t>(k) * D + j] : 0.0f;
    }
    __syncthreads();
    if (t + 1 < T) fetch_panel(binv, t + 1, n_chunks, n_panels, D, pre);

    if (first_of_cluster) {
#pragma unroll
      for (int a = 0; a < 8; ++a) q[a] = 0.0f;
    }
    if (p == 0) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
      }
    }

    const int j0 = p * kPanel;
#pragma unroll 4
    for (int jj = 0; jj < kPanel; ++jj) {
      const float m = mus[j0 + jj];
      const float4 xa = *reinterpret_cast<const float4*>(&xt[(j0 + jj) * kLd + tm * 8]);
      const float4 xb = *reinterpret_cast<const float4*>(&xt[(j0 + jj) * kLd + tm * 8 + 4]);
      const float4 ba = *reinterpret_cast<const float4*>(&bt[jj * kLd + tn * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&bt[jj * kLd + 64 + tn * 4]);
      const float d[8] = {xa.x - m, xa.y - m, xa.z - m, xa.w - m,
                          xb.x - m, xb.y - m, xb.z - m, xb.w - m};
      const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(d[a], b[c], acc[a][c]);
      }
    }

    if (last_of_chunk) {
      // outputs past D have zero rows of B_k and add exactly 0
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int c = 0; c < 8; ++c) q[a] = fmaf(acc[a][c], acc[a][c], q[a]);
      }
    }
    if (rem == per_cluster - 1) {
      // sum the partial forms over the 16 lanes of the half-warp that share tm
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) q[a] += __shfl_xor_sync(0xffffffffu, q[a], off);
      }
      float quad = q[0];
#pragma unroll
      for (int a = 1; a < 8; ++a) quad = tn == a ? q[a] : quad;
      int c = 0, kc = k;  // chain, and slot within it
      if constexpr (kChains) {
        c = k / K;
        kc = k - c * K;
      }
      if (tn < 8 && my_row < N) {
        const float lp = base[k] - 0.5f * quad +
                         philox::gumbel(seed, static_cast<uint32_t>(my_row), static_cast<uint32_t>(kc),
                                        static_cast<uint32_t>(c));
        if (lp > best) {
          best = lp;
          arg = kc;
        }
      }
      if constexpr (kChains) {
        if (kc == K - 1) {  // this chain's last slot: emit, then start the next chain
          if (tn < 8 && my_row < N) z[static_cast<size_t>(c) * N + my_row] = arg;
          best = -INFINITY;
          arg = 0;
        }
      }
    }
  }
  if constexpr (!kChains) {
    if (tn < 8 && my_row < N) z[my_row] = arg;
  }
}

size_t smem_bytes(int D) {
  const size_t Dp = static_cast<size_t>(round_up(D, kPanel));
  return sizeof(float) * (Dp * kLd + static_cast<size_t>(kPanel) * kLd + Dp);
}

template <bool kChains>
int launch(const float* X, const float* mu, const float* binv, const float* base, const int* seed,
           int* z, int N, int D, int K, int C, void* stream) {
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(gaussian_assign_kernel<kChains>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + kTileN - 1) / kTileN;
  gaussian_assign_kernel<kChains><<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      X, mu, binv, base, seed, z, N, D, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest D whose working set fits a block's shared memory.
int gaussian_assign_max_dim(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  int d = 0;
  while (smem_bytes(d + kPanel) <= static_cast<size_t>(optin)) d += kPanel;
  return d;
}

// X [N, D], mu [K, D], binv [K, D, D], base [K] float32; seed [1] int32;
// z [N] int32 output. All on the device, contiguous. Returns the CUDA error
// code of the launch (0 on success).
int gaussian_assign_launch(const float* X, const float* mu, const float* binv, const float* base,
                           const int* seed, int* z, int N, int D, int K, void* stream) {
  return launch<false>(X, mu, binv, base, seed, z, N, D, K, 1, stream);
}

// The multi-chain form: mu [C*K, D], binv [C*K, D, D], base [C*K] chain-major,
// z [C, N] int32 output; K is the number of slots per chain.
int gaussian_assign_chains_launch(const float* X, const float* mu, const float* binv,
                                  const float* base, const int* seed, int* z, int N, int D, int K,
                                  int C, void* stream) {
  return launch<true>(X, mu, binv, base, seed, z, N, D, K, C, stream);
}

}  // extern "C"
