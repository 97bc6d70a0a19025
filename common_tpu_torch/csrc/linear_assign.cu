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
// What bounds it on Hopper: at the config-2 shape (100k x 64, K = 32) the
// product is only N*K*D = 2e8 fp32 multiply-adds (a few microseconds of the
// CUDA cores); the work is reading X once (N*D*4 bytes, 25.6 MB) and the
// N*K Philox4x32-10 draws with two logarithms each (3.2M draws, about a
// hundred integer instructions apiece). So the design keeps the product
// simple and spends its care on reading X once, coalesced, and on keeping
// every warp busy with noise: one thread per row.
//
// Design: a block takes kRows = 128 rows, one per thread. Columns of its row
// tile are staged through shared memory kDChunk = 32 at a time (transposed,
// with a padded stride, so the coalesced global reads and the per-row
// shared reads are both free of bank conflicts), together with the same
// columns of a panel of kKPanel = 32 clusters of W. Each thread keeps the
// panel's 32 partial scores in registers, reading W as broadcast float4
// loads. After the last column chunk it adds base_k and its Philox noise
// and updates the running (max, argmax), which lives in registers and moves
// only on a strictly greater score, so the lowest k wins ties, as in Pallas
// and torch.argmax. K larger than the panel takes more passes over the row
// tile (X is then read again, from L2). Any D and K are taken.
//
// Gumbel noise: Philox4x32-10 keyed on the per-sweep seed with counter
// (row, k), the same stream as the Gaussian assignment kernel, so the draws
// do not depend on the tiling. The seed is read from device memory.
//
// Precision: fp32 FMA on the CUDA cores; no TF32, no tensor cores.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kRows = 128;         // rows per block, one per thread
constexpr int kDChunk = 32;        // columns staged per step
constexpr int kKPanel = 32;        // clusters scored per pass over the row tile
constexpr int kLdX = kRows + 1;    // padded stride of the transposed row tile

__global__ void __launch_bounds__(kRows)
linear_assign_kernel(const float* __restrict__ X, const float* __restrict__ W,
                     const float* __restrict__ base, const int* __restrict__ seed_ptr,
                     int* __restrict__ z, int N, int D, int K) {
  __shared__ float xs[kDChunk * kLdX];                  // xs[j][r] = X[row0 + r][d0 + j]
  __shared__ __align__(16) float ws[kDChunk * kKPanel];  // ws[j][kk] = W[k0 + kk][d0 + j]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + tid;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  float best = -INFINITY;
  int arg = 0;

  for (int k0 = 0; k0 < K; k0 += kKPanel) {
    float acc[kKPanel];
#pragma unroll
    for (int kk = 0; kk < kKPanel; ++kk) acc[kk] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += kDChunk) {
      __syncthreads();  // the previous chunk is consumed
      // consecutive threads read consecutive columns of one row
      for (int idx = tid; idx < kRows * kDChunk; idx += kRows) {
        const int r = idx / kDChunk, j = idx - r * kDChunk;
        const int gr = row0 + r, gj = d0 + j;
        xs[j * kLdX + r] = (gr < N && gj < D) ? X[static_cast<size_t>(gr) * D + gj] : 0.0f;
      }
      for (int idx = tid; idx < kKPanel * kDChunk; idx += kRows) {
        const int j = idx / kKPanel, kk = idx - j * kKPanel;
        const int gk = k0 + kk, gj = d0 + j;
        ws[j * kKPanel + kk] = (gk < K && gj < D) ? W[static_cast<size_t>(gk) * D + gj] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kDChunk; ++j) {
        const float x = xs[j * kLdX + tid];
        const float4* w4 = reinterpret_cast<const float4*>(&ws[j * kKPanel]);
#pragma unroll
        for (int q = 0; q < kKPanel / 4; ++q) {
          const float4 w = w4[q];
          acc[4 * q + 0] = fmaf(x, w.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(x, w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(x, w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(x, w.w, acc[4 * q + 3]);
        }
      }
    }

    if (row < N) {
#pragma unroll
      for (int kk = 0; kk < kKPanel; ++kk) {
        const int k = k0 + kk;
        if (k < K) {
          const float lp = acc[kk] + base[k] +
                           philox::gumbel(seed, static_cast<uint32_t>(row), static_cast<uint32_t>(k));
          if (lp > best) {
            best = lp;
            arg = k;
          }
        }
      }
    }
  }
  if (row < N) z[row] = arg;
}

}  // namespace

extern "C" {

// X [N, D], W [K, D], base [K] float32; seed [1] int32; z [N] int32 output.
// All on the device, contiguous. Returns the CUDA error code of the launch
// (0 on success).
int linear_assign_launch(const float* X, const float* W, const float* base, const int* seed, int* z,
                         int N, int D, int K, void* stream) {
  const int blocks = (N + kRows - 1) / kRows;
  linear_assign_kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(X, W, base, seed, z,
                                                                                N, D, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
