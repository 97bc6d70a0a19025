// Per-cluster scatter matrices from rows already grouped by cluster:
//
//     sum_xxT[k] = sum over rows n with z_n = k of x_n x_n^T      [K, D, D]
//
// Replaces the Pallas kernel common_tpu/ops/suffstat.py `_restat_kernel`
// (called by `fused_scatter_stats`). That kernel runs one masked
// [tile, D]^T x [tile, D] product per cluster, K times the FLOPs needed, so
// it is not copied. The wrapper (ops/suffstat.py) instead orders the rows by
// cluster with a stable sort and cuts the sorted rows into chunks of equal
// size (a cluster's last chunk shorter), each within one cluster; this
// kernel then does N*D^2 multiply-adds, not N*K*D^2.
//
// What bounds it on Hopper: N*D(D+1)/2 multiply-adds for the upper
// triangle (3.3e10 at 1M x 256) at fp32 accuracy, which run on the tensor
// cores as 3xTF32 split products (tf32x3.cuh): 0.40 ms at 495 TFLOP/s,
// against 0.98 ms for fp32 on the CUDA cores; X's 1.05 GB read once takes
// 0.31 ms. And the balance between clusters: a few clusters often hold most
// rows, so the work is cut by rows, not by cluster, and a 333k-row cluster
// spreads over as many blocks as its rows need.
//
// Design: a block owns one (chunk of rows, 64 x 64 output tile on or above
// the diagonal): at D = 256, 10 of the 16 tiles. Its 4 warps each hold a
// 32 x 32 quarter of the tile in m16n8k8 accumulators, C = X_I^T X_J, with
// A = X_I^T and B = X_J both read from one staged [rows][cols] slice, so the
// rows are the product's inner dimension. Each pipeline step gathers 64
// rows of the chunk, the tile's two 64-column slices of each (one for a
// diagonal tile), through `order` with 16-byte cp.async copies into a ring
// of three stages, so the gathers of later steps overlap this one's
// products. Each step's products go into one accumulator, which is then
// added to the running total held in separate registers: a single serial
// fp32 sum over hundreds of thousands of rows drifts (5.5e-4 relative to a
// float64 sum at 333k rows of the main path's data, measured on an H100),
// the two-level sum does not (3.5e-6).
//
// A block writes its tile and the tile's mirror into its chunk's partial
// [D, D] (of a diagonal tile, the upper triangle and its mirror), so the
// result is exactly symmetric; a second kernel adds each cluster's chunk
// partials in chunk order. No atomics: every sum runs in a fixed order, so
// the result is deterministic.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kStep = 64;      // rows gathered per pipeline step
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2 quarters of the tile
constexpr int kLd = kTile + 8; // 72: fragment loads hit 32 distinct banks
constexpr int kSliceFloats = kStep * kLd;
constexpr int kReduceThreads = 256;

size_t smem_bytes() { return sizeof(float) * kStages * 2 * kSliceFloats; }

__global__ void __launch_bounds__(kThreads)
scatter_tiles_kernel(const float* __restrict__ X, const int* __restrict__ order,
                     const int* __restrict__ chunk_lo, const int* __restrict__ chunk_hi,
                     float* __restrict__ partial, int D, int tiles_per_dim, bool vec) {
  using namespace tf32x3;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // kStages x (slice I, slice J)

  // blockIdx.x: upper tile (I <= J) in row-major order; blockIdx.y: chunk
  int I = 0, rest = blockIdx.x;
  while (rest >= tiles_per_dim - I) {
    rest -= tiles_per_dim - I;
    ++I;
  }
  const int J = I + rest;
  const bool diag = I == J;
  const int i0 = I * kTile, j0 = J * kTile;
  const int lo = chunk_lo[blockIdx.y], hi = chunk_hi[blockIdx.y];
  if (lo >= hi) return;  // a chunk slot past the schedule's end
  const int n_steps = (hi - lo + kStep - 1) / kStep;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // output rows i0 + wm*32.., columns j0 + wn*32..
  const int g = lane >> 2, t = lane & 3;

  // Queue step `st`: rows order[lo + st*kStep ..] of the chunk, the
  // columns of slice I (and of slice J off the diagonal); zeros past the
  // chunk and past D. Always commit a group, so the wait counts uniformly.
  auto enqueue = [&](int st) {
    if (st < n_steps) {
      float* si = ring + (st % kStages) * 2 * kSliceFloats;
      const int s0 = lo + st * kStep;
      const int n_slices = diag ? 1 : 2;
      if (vec) {
        for (int c = tid; c < n_slices * kStep * (kTile / 4); c += kThreads) {
          const int sl = c / (kStep * (kTile / 4));
          const int r = (c / (kTile / 4)) % kStep, q = (c % (kTile / 4)) * 4;
          const int col = (sl ? j0 : i0) + q;
          const bool in = s0 + r < hi && col < D;
          const float* src = in ? X + static_cast<size_t>(order[s0 + r]) * D + col : X;
          cp_async16(si + sl * kSliceFloats + r * kLd + q, src, in ? 16 : 0);
        }
      } else {
        for (int c = tid; c < n_slices * kStep * kTile; c += kThreads) {
          const int sl = c / (kStep * kTile);
          const int r = (c / kTile) % kStep, q = c % kTile;
          const int col = (sl ? j0 : i0) + q;
          const bool in = s0 + r < hi && col < D;
          const float* src = in ? X + static_cast<size_t>(order[s0 + r]) * D + col : X;
          cp_async4(si + sl * kSliceFloats + r * kLd + q, src, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  for (int st = 0; st < kStages - 1; ++st) enqueue(st);

  float tot[2][4][4] = {};
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step st has landed; the stage of step st - 1 is free
    enqueue(st + kStages - 1);

    const float* si = ring + (st % kStages) * 2 * kSliceFloats;
    const float* sj = diag ? si : si + kSliceFloats;
    const float* aw = si + t * kLd + wm * 32 + g;  // A[m][k] = slice I[k][m]
    const float* bw = sj + t * kLd + wn * 32 + g;  // B[k][n] = slice J[k][n]
    float part[2][4][4] = {};
    // padding rows and columns are zero in both slices and add exactly 0
#pragma unroll 2
    for (int kk = 0; kk < kStep; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = aw + kk * kLd + i * 16;
        split(a[0], ah[i][0], al[i][0]);             // m = g,     k = t
        split(a[8], ah[i][1], al[i][1]);             // m = g + 8, k = t
        split(a[4 * kLd], ah[i][2], al[i][2]);       // m = g,     k = t + 4
        split(a[4 * kLd + 8], ah[i][3], al[i][3]);   // m = g + 8, k = t + 4
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* b = bw + kk * kLd + j * 8;
        split(b[0], bh[j][0], bl[j][0]);             // k = t,     n = g
        split(b[4 * kLd], bh[j][1], bl[j][1]);       // k = t + 4, n = g
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(part[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(part[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(part[i][j], ah[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // tot[i][j][e] is C[m][n], m = wm*32 + i*16 + g (+8 for e >= 2),
  // n = wn*32 + j*8 + 2t (+1 for odd e); write it and its mirror
  float* out = partial + static_cast<size_t>(blockIdx.y) * D * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i0 + wm * 32 + i * 16 + g + (e >> 1) * 8;
        const int c = j0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (r >= D || c >= D || (diag && r > c)) continue;
        out[static_cast<size_t>(r) * D + c] = tot[i][j][e];
        out[static_cast<size_t>(c) * D + r] = tot[i][j][e];
      }
}

// out[k] = sum of cluster k's chunk partials, chunks cstart[k] ..
// cstart[k + 1] - 1, in order.
__global__ void __launch_bounds__(kReduceThreads)
scatter_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ cstart,
                      float* __restrict__ out, int DD) {
  const int k = blockIdx.y;
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= DD) return;
  float s = 0.0f;
  for (int u = cstart[k]; u < cstart[k + 1]; ++u) s += partial[static_cast<size_t>(u) * DD + e];
  out[static_cast<size_t>(k) * DD + e] = s;
}

}  // namespace

extern "C" {

// X [N, D] float32; order [N] int32, the row indices grouped by cluster;
// chunk_lo, chunk_hi [U] int32, chunk u owning order[chunk_lo[u]:chunk_hi[u]]
// (empty past the schedule's end); cstart [K + 1] int32, cluster k owning
// chunks cstart[k] .. cstart[k + 1] - 1; partial [U, D, D] float32 scratch;
// out [K, D, D] float32, fully written. All on the device, contiguous.
// Returns the CUDA error code of the launches (0 on success).
int scatter_stats_launch(const float* X, const int* order, const int* chunk_lo, const int* chunk_hi,
                         const int* cstart, float* partial, float* out, int D, int K, int U,
                         void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const int tiles_per_dim = (D + kTile - 1) / kTile;
  const int n_tiles = tiles_per_dim * (tiles_per_dim + 1) / 2;
  const size_t bytes = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(scatter_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (U > 0) {
    scatter_tiles_kernel<<<dim3(n_tiles, U), kThreads, bytes, s>>>(X, order, chunk_lo, chunk_hi, partial,
                                                                   D, tiles_per_dim, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int DD = D * D;
  scatter_reduce_kernel<<<dim3((DD + kReduceThreads - 1) / kReduceThreads, K), kReduceThreads, 0, s>>>(
      partial, cstart, out, DD);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
