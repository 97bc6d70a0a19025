// Per-cluster scatter matrices from rows already grouped by cluster:
//
//     sum_xxT[k] = sum over rows n with z_n = k of x_n x_n^T      [K, D, D]
//
// Replaces the Pallas kernel common_tpu/ops/suffstat.py `_restat_kernel`
// (called by `fused_scatter_stats`). That kernel runs one masked
// [tile, D]^T x [tile, D] product per cluster, K times the FLOPs needed, so
// it is not copied. The wrapper (ops/suffstat.py) instead orders the rows by
// cluster with a stable sort and passes the row order with the per-cluster
// offsets; this kernel then does N*D^2 multiply-adds, not N*K*D^2.
//
// What bounds it on Hopper: N*D^2 fp32 FMA (6.7e10 at 1M x 256) on the CUDA
// cores -- no TF32, no tensor cores -- and the balance between clusters: a
// few clusters often hold most rows, and one block walking all of a large
// cluster's rows would set the time while most SMs idle. So each cluster's
// rows are cut into SPLITS equal slices, and a block owns one
// (cluster, slice, 64 x 64 output tile) and writes a partial sum; the
// wrapper adds the SPLITS partials in a fixed order.
//
// Design: each block gathers ROWS rows of its slice at a time, the two
// 64-column slices of each row its output tile needs, into shared memory;
// each of the 256 threads keeps a 4 x 4 register tile of the output. No
// atomics: every partial element is summed by one thread, in row order, so
// the result is deterministic.
//
// Precision: fp32 FMA. A cluster can hold hundreds of thousands of rows,
// and one serial fp32 sum over all of them drifts (5.5e-4 relative to a
// float64 sum at 333k rows of the main path's data, measured on an H100);
// so each step's ROWS products go into a partial sum first, which is then
// added to the running total (3.5e-6 relative on the same data, no slower).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;    // output tile edge
constexpr int kRows = 32;    // rows gathered per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_stats_kernel(const float* __restrict__ X, const int* __restrict__ order,
                     const int* __restrict__ offsets, float* __restrict__ out, int D,
                     int tiles_per_dim) {
  // blockIdx: x = output tile, y = cluster, z = slice of the cluster's rows
  __shared__ __align__(16) float xi[kRows][kTile];
  __shared__ __align__(16) float xj[kRows][kTile];
  __shared__ int rows[kRows];

  const int k = blockIdx.y;
  const int ti0 = (blockIdx.x / tiles_per_dim) * kTile;
  const int tj0 = (blockIdx.x % tiles_per_dim) * kTile;
  const int tid = threadIdx.x;
  const int a0 = (tid >> 4) * 4;
  const int b0 = (tid & 15) * 4;
  const long long first = offsets[k], count = offsets[k + 1] - first;
  const int start = static_cast<int>(first + count * blockIdx.z / gridDim.z);
  const int end = static_cast<int>(first + count * (blockIdx.z + 1) / gridDim.z);

  float acc[4][4] = {};
  for (int s = start; s < end; s += kRows) {
    const int nr = min(kRows, end - s);
    __syncthreads();  // the previous step's rows are consumed
    if (tid < kRows) rows[tid] = tid < nr ? order[s + tid] : -1;
    __syncthreads();
    for (int idx = tid; idx < kRows * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx - r * kTile;
      const int row = rows[r];
      float vi = 0.0f, vj = 0.0f;
      if (row >= 0) {
        const float* xr = X + static_cast<size_t>(row) * D;
        if (ti0 + c < D) vi = xr[ti0 + c];
        if (tj0 + c < D) vj = xr[tj0 + c];
      }
      xi[r][c] = vi;
      xj[r][c] = vj;
    }
    __syncthreads();
    // padding rows are zero in both slices and add exactly 0
    float part[4][4] = {};
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(&xi[r][a0]);
      const float4 v = *reinterpret_cast<const float4*>(&xj[r][b0]);
      const float ua[4] = {u.x, u.y, u.z, u.w};
      const float vb[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) part[a][b] = fmaf(ua[a], vb[b], part[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += part[a][b];
    }
  }

  float* outk = out + (static_cast<size_t>(blockIdx.z) * gridDim.y + k) * D * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti0 + a0 + a;
    if (i >= D) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj0 + b0 + b;
      if (j < D) outk[static_cast<size_t>(i) * D + j] = acc[a][b];
    }
  }
}

}  // namespace

extern "C" {

// X [N, D] float32; order [N] int32, the row indices grouped by cluster;
// offsets [K + 1] int32, cluster k owning order[offsets[k]:offsets[k + 1]];
// out [splits, K, D, D] float32, fully written: slice s of every cluster's
// rows sums into out[s]. All on the device, contiguous. Returns the CUDA
// error code of the launch (0 on success).
int scatter_stats_launch(const float* X, const int* order, const int* offsets, float* out, int D,
                         int K, int splits, void* stream) {
  const int tiles_per_dim = (D + kTile - 1) / kTile;
  const dim3 grid(tiles_per_dim * tiles_per_dim, K, splits);
  scatter_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      X, order, offsets, out, D, tiles_per_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
