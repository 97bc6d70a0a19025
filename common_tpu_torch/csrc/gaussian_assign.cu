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
// What bounds it on Hopper: 2*N*K*D^2 operations (8.4e12 at 1M x 256,
// K = 64), which must keep fp32 accuracy: a single TF32 pass in this
// quadratic form biases the sampler (common_tpu/likelihoods/niw.py,
// sample_params_prec). They run on the tensor cores as 3xTF32 split
// products (tf32x3.cuh): three TF32 passes, a bound of 3 * 8.4e12 / 495
// TFLOP/s = 50.8 ms, against 125 ms for fp32 on the CUDA cores. The kernel
// has two routes, chosen by the wrapper from D and X's alignment alone
// (ops/gaussian_assign.py wgmma_route); both draw the same noise and argmax.
//
// The warpgroup route (D a multiple of 4 up to 256, X 16-byte aligned:
// every D of the main path, path A, config 3 and the sharded sweep).
// wgmma is the only instruction that reaches the tensor cores' full TF32
// rate on an H100; mma.sync runs at about half of it. For TF32, wgmma
// reads B from shared memory, K-major, and A from registers or shared
// memory. B_k is row-major [out][in], which is K-major for
// Y = (X - mu_k) B_k^T. So A, the centred and split rows, is still made in
// registers: each thread loads its fragment from the row tile in shared
// memory, subtracts mu_k in fp32 and splits it. B's TF32 halves must lie
// in shared memory, so a first small kernel (wg_split_kernel) splits
// every B_k once a call into a scratch laid out as the stages are (12
// bytes per element of B: 50 MB read and written at K = 64, D = 256), mu
// padded beside it. A producer thread fills each stage with one TMA bulk
// copy that completes on the stage's mbarrier; no consumer thread spends
// an instruction on a copy.
//
// A block is one producer warpgroup (40 registers a thread by setmaxnreg)
// and two consumer warpgroups (232), 64 rows each: 128 rows, as on the
// other route. A consumer's m64nNk8 product holds all N outputs of its
// rows (N = 256 at D = 256: 128 accumulators a thread), so each row's
// squared form is summed over its 4-lane quad by two shuffles, with no
// pass through shared memory. Each 8-input step runs three products,
// lo * hi, hi * lo, hi * hi, into fp32 accumulators; only the order of the
// sums differs from the other route.
//
// Shared memory at D = 256: the row tile, 128 x 256 x 4 = 131,072 B, with
// no padding but its columns swizzled (column j of row r at j ^ 8 (r & 3),
// so a warp's fragment loads take two wavefronts, the least for 256
// bytes); three stages of 256 outputs x 16 inputs x (hi + lo) = 32,768 B;
// their mu slices, 3 x 64 B; six mbarriers, 48 B; 1 KB to align the
// stages: 230,640 of the 232,448 B a block may have. A 32-input panel
// (65,536 B a stage) would leave room for one stage only. At N = 128 six
// stages fit, at N = 64 eight. B's layout in a stage is K-major with the
// 64-byte swizzle (wgmma.cuh), and within each 8-input step the inputs are
// permuted as on the other route (input j at place j / 2 + 4 (j % 2)), so
// that a thread's fragment columns t and t + 4 are neighbours in the row
// tile.
//
// L2: each 128-row block streams all of B_hi and B_lo, 2 x 16.8 MB at
// K = 64, D = 256: 7,813 blocks at N = 10^6 x 33.6 MB = 262 GB a call,
// twice the other route's bytes. Measured on an H100 80GB HBM3 at 700 W,
// the kernel runs at 0.89 of the three-pass bound (57.2 ms a call), so it
// reads 4.6 TB/s from L2 and the L2 does not bind it.
//
// Pipeline: per panel a consumer warpgroup waits on the stage's full
// barrier, makes its A fragments, issues six products and commits them as
// a group, then waits for the panel before (wgmma.wait_group 1) and gives
// that stage back (lane 0 of each warp arrives on its empty barrier). Two
// register sets of A fragments alternate, so a set is rewritten only once
// its products are done. At a slot's end the group is waited for and the
// squared forms reduced; base_k, the Philox Gumbel and the argmax of that
// slot run after the next slot's first products are issued, while the
// tensor cores work.
//
// The mma.sync route (D of 257 to `gaussian_assign_max_dim`, 384 on an
// H100; D not a multiple of 4; an unaligned X). One block of 8 warps takes
// 128 rows; its row tile stays in shared
// memory for the whole launch. For each slot k, Y = (X_tile - mu_k) B_k^T
// runs as 128 rows x 256 outputs at a time (one output chunk at D = 256),
// each warp a 64 x 64 share of it in 4 x 8 m16n8k8 accumulator tiles. B_k
// is row-major [out][in], which is the K-major layout the instruction's B
// operand takes. One B_k at D = 256 is 256 KB, more than a block's 227 KB
// of shared memory, so B_k streams through two stages of 256 outputs x 32
// inputs (with the matching 32 values of mu_k), filled by cp.async one
// panel ahead of the one in use, no register staging. Each warp loads its
// fragments from shared memory, subtracts mu_k in fp32 as the plain
// version does (centring before the split: the expanded X B_k^T - B_k mu_k
// would subtract two products that grow with ||x|| to get the small y of a
// row's own cluster), splits them into TF32 halves, then runs the three
// passes. Within each 8-input step the inputs are
// permuted so that fragment columns t and t + 4 are neighbours in memory
// (8-byte loads); the row strides (+8 floats) keep those loads free of bank
// conflicts. Each panel costs one barrier, so the panels are as deep as
// shared memory allows, and the next panel's copies are queued after the
// first step's products (by counters, no division), so the tensor cores
// are not left idle behind them. Above D = 256 the 128-row tile leaves
// less room, so the warps take 64 x 32 shares of 128-output chunks and the
// panels 16 inputs; every D up to `gaussian_assign_max_dim` (384 on an
// H100) runs.
//
// Its epilogue per slot: each thread squares its accumulators into 8 per-row
// partial forms, the 4 lanes of a quad that share rows add theirs by
// shuffles, the 4 warps that share rows add through shared memory, and 128
// threads, one per row, add base_k and the Philox Gumbel and update the
// running (max, argmax) in registers, only on a strictly greater score, so
// the lowest k wins ties, as in Pallas and torch.argmax.
//
// Shapes: a ragged N and any D run with zero padding in shared memory,
// which adds exactly 0: rows past N, inputs and outputs past D. Rows of
// 16-byte-aligned width go by 16-byte copies, other widths by 4-byte
// copies.
//
// Gumbel noise: Philox4x32-10 keyed on the per-sweep seed with counter
// (row_offset + row, k, c), k the slot within chain c, so the draws do not
// depend on the tiling, chain 0 draws exactly the single-chain kernel's
// noise, and a shard of rows launched with its first row's index as
// row_offset draws what a launch over all rows draws for them. The seed
// is read from device memory, so the host never waits for the device to
// draw it.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 128;     // rows per block
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along outputs
constexpr int kWarpRows = 64;  // rows of one warp's share
constexpr int kMT = kWarpRows / 16;  // m16 tiles per warp

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// One tiling: kPanel inputs per stage, kStages stages, kWarpCols outputs
// per warp (the chunk is 4 * kWarpCols outputs).
template <int kPanel, int kStages, int kWarpCols>
struct Tiling {
  static constexpr int kChunk = 4 * kWarpCols;           // outputs of y per chunk
  static constexpr int kNT = kWarpCols / 8;              // n8 tiles per warp
  static constexpr int kBLd = kPanel + 8;                // row stride of a B panel
  static constexpr int kStageFloats = kChunk * kBLd + kPanel;  // B panel, then the mu slice

  // Row stride of the row tile: 8 mod 16 floats, so the 8-byte fragment
  // loads of a half-warp hit 32 distinct banks (kBLd likewise).
  __host__ __device__ static int x_ld(int D) { return round_up(D, kPanel) + 8; }

  static size_t smem_bytes(int D) {
    return sizeof(float) * (static_cast<size_t>(kRows) * x_ld(D) +
                            static_cast<size_t>(kStages) * kStageFloats + 4 * kRows);
  }
};

template <bool kChains, int kPanel, int kStages, int kWarpCols>
__global__ void __launch_bounds__(kThreads, 1)
gaussian_assign_kernel(const float* __restrict__ X, const float* __restrict__ mu,
                       const float* __restrict__ binv, const float* __restrict__ base,
                       const int* __restrict__ seed_ptr, int* __restrict__ z, int N, int D,
                       int K, int C, int row_offset, bool vec) {
  using namespace tf32x3;
  using Tl = Tiling<kPanel, kStages, kWarpCols>;
  constexpr int kChunk = Tl::kChunk, kNT = Tl::kNT, kBLd = Tl::kBLd, kStageFloats = Tl::kStageFloats;
  extern __shared__ float4 smem4[];
  const int xld = Tl::x_ld(D);
  float* xs = reinterpret_cast<float*>(smem4);            // [kRows][xld] row tile
  float* stages = xs + static_cast<size_t>(kRows) * xld;  // kStages x (B panel, mu slice)
  float* qs = stages + kStages * kStageFloats;            // [4][kRows] forms by warp column

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // rows wm*64.., outputs wn*kWarpCols.. of a chunk
  const int g = lane >> 2, t = lane & 3;    // the fragment layouts' group and thread
  const int row0 = blockIdx.x * kRows;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const int Dp = round_up(D, kPanel);
  const int n_panels = Dp / kPanel;
  const int per_slot = ((D + kChunk - 1) / kChunk) * n_panels;
  const int T = C * K * per_slot;  // panels over all slots, chunks and inputs

  // Queue the next panel of the flattened (slot, chunk, input panel)
  // sequence into its stage, with the matching slice of mu_k; always commit
  // a group, so the wait below counts uniformly. The counters advance by
  // one panel a call, so no division runs per panel.
  int nx_p = 0, nx_s = 0, nx_o0 = 0, nx_i0 = 0, nx_st = 0;
  auto enqueue = [&]() {
    if (nx_p < T) {
      float* bs = stages + nx_st * kStageFloats;
      float* ms = bs + kChunk * kBLd;
      const float* bk = binv + static_cast<size_t>(nx_s) * D * D;
      const float* mk = mu + static_cast<size_t>(nx_s) * D;
      const int o0 = nx_o0, i0 = nx_i0;
      if (vec) {
        constexpr int kPieces = kPanel / 4;  // 16-byte pieces of a panel row
#pragma unroll
        for (int c = tid; c < kChunk * kPieces; c += kThreads) {
          const int r = c / kPieces, q = (c % kPieces) * 4;
          const bool in = o0 + r < D && i0 + q < D;
          cp_async16(bs + r * kBLd + q, in ? bk + static_cast<size_t>(o0 + r) * D + i0 + q : bk,
                     in ? 16 : 0);
        }
        if (tid < kPieces) {
          const bool in = i0 + tid * 4 < D;
          cp_async16(ms + tid * 4, in ? mk + i0 + tid * 4 : mk, in ? 16 : 0);
        }
      } else {
        for (int c = tid; c < kChunk * kPanel; c += kThreads) {
          const int r = c / kPanel, q = c % kPanel;
          const bool in = o0 + r < D && i0 + q < D;
          cp_async4(bs + r * kBLd + q, in ? bk + static_cast<size_t>(o0 + r) * D + i0 + q : bk,
                    in ? 4 : 0);
        }
        if (tid < kPanel) {
          const bool in = i0 + tid < D;
          cp_async4(ms + tid, in ? mk + i0 + tid : mk, in ? 4 : 0);
        }
      }
      ++nx_p;
      nx_st = nx_st + 1 == kStages ? 0 : nx_st + 1;
      if ((nx_i0 += kPanel) >= Dp) {
        nx_i0 = 0;
        if ((nx_o0 += kChunk) >= D) {
          nx_o0 = 0;
          ++nx_s;
        }
      }
    }
    cp_async_commit();
  };

  for (int p = 0; p < kStages - 1; ++p) enqueue();

  // the row tile, zero past N and past D
  if (vec) {
    const int per_row = Dp / 4;
    for (int c = tid; c < kRows * per_row; c += kThreads) {
      const int r = c / per_row, j = (c - r * per_row) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row0 + r < N && j < D) v = *reinterpret_cast<const float4*>(X + static_cast<size_t>(row0 + r) * D + j);
      *reinterpret_cast<float4*>(xs + r * xld + j) = v;
    }
  } else {
    for (int c = tid; c < kRows * Dp; c += kThreads) {
      const int r = c / Dp, j = c - r * Dp;
      xs[r * xld + j] = (row0 + r < N && j < D) ? X[static_cast<size_t>(row0 + r) * D + j] : 0.0f;
    }
  }

  float acc[kMT][kNT][4];
  float q[kMT][2];         // partial forms of rows wm*64 + i*16 + g (+ 8)
  float best = -INFINITY;  // threads tid < kRows own row row0 + tid
  int arg = 0;

  for (int p = 0; p < T; ++p) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // panel p has landed; the stage of panel p - 1 is free

    const int s = p / per_slot;  // slot over all chains
    const int rem = p - s * per_slot;
    const int ip = rem % n_panels;
    if (rem == 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) q[i][0] = q[i][1] = 0.0f;
    }
    if (ip == 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }

    const float* bs = stages + (p % kStages) * kStageFloats;
    const float* ms = bs + kChunk * kBLd;
    const float* xw = xs + (wm * kWarpRows + g) * xld + ip * kPanel + 2 * t;
    const float* bw = bs + (wn * kWarpCols + g) * kBLd + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kPanel; kk += 8) {
      // fragment input t is column 2t of the step and input t + 4 column
      // 2t + 1; rows g and g + 8 of each m16 tile
      uint32_t ah[kMT][4], al[kMT][4];
      const float2 m = *reinterpret_cast<const float2*>(ms + kk + 2 * t);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float2 x0 = *reinterpret_cast<const float2*>(xw + i * 16 * xld + kk);
        const float2 x1 = *reinterpret_cast<const float2*>(xw + (i * 16 + 8) * xld + kk);
        split(x0.x - m.x, ah[i][0], al[i][0]);  // row g,     input t
        split(x1.x - m.x, ah[i][1], al[i][1]);  // row g + 8, input t
        split(x0.y - m.y, ah[i][2], al[i][2]);  // row g,     input t + 4
        split(x1.y - m.y, ah[i][3], al[i][3]);  // row g + 8, input t + 4
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t bh[2], bl[2];
        const float2 b = *reinterpret_cast<const float2*>(bw + j * 8 * kBLd + kk);
        split(b.x, bh[0], bl[0]);
        split(b.y, bh[1], bl[1]);
        // the small passes first, then hi * hi; kMT independent tiles a pass
#pragma unroll
        for (int i = 0; i < kMT; ++i) mma(acc[i][j], al[i], bh);
#pragma unroll
        for (int i = 0; i < kMT; ++i) mma(acc[i][j], ah[i], bl);
#pragma unroll
        for (int i = 0; i < kMT; ++i) mma(acc[i][j], ah[i], bh);
      }
      // queue the next panel once this step's products keep the tensor
      // cores busy, not ahead of them
      if (kk == 0) enqueue();
    }

    if (ip == n_panels - 1) {
      // the chunk is done; outputs past D have zero rows of B_k and add 0
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          q[i][0] = fmaf(acc[i][j][0], acc[i][j][0], fmaf(acc[i][j][1], acc[i][j][1], q[i][0]));
          q[i][1] = fmaf(acc[i][j][2], acc[i][j][2], fmaf(acc[i][j][3], acc[i][j][3], q[i][1]));
        }
    }
    if (rem == per_slot - 1) {
      // the slot is done: sum each row's form over its quad, then its warps
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          q[i][h] += __shfl_xor_sync(0xffffffffu, q[i][h], 1);
          q[i][h] += __shfl_xor_sync(0xffffffffu, q[i][h], 2);
          if (t == 0) qs[wn * kRows + wm * kWarpRows + i * 16 + h * 8 + g] = q[i][h];
        }
      __syncthreads();
      if (tid < kRows) {
        const float quad = (qs[tid] + qs[kRows + tid]) + (qs[2 * kRows + tid] + qs[3 * kRows + tid]);
        int c = 0, kc = s;  // chain, and slot within it
        if constexpr (kChains) {
          c = s / K;
          kc = s - c * K;
        }
        const int row = row0 + tid;
        if (row < N) {
          const float lp = base[s] - 0.5f * quad +
                           philox::gumbel(seed, static_cast<uint32_t>(row_offset + row), static_cast<uint32_t>(kc),
                                          static_cast<uint32_t>(c));
          if (lp > best) {
            best = lp;
            arg = kc;
          }
        }
        if constexpr (kChains) {
          if (kc == K - 1) {  // this chain's last slot: emit, then start the next chain
            if (row < N) z[static_cast<size_t>(c) * N + row] = arg;
            best = -INFINITY;
            arg = 0;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (!kChains) {
    if (tid < kRows && row0 + tid < N) z[row0 + tid] = arg;
  }
}

int optin_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return optin;
}

template <bool kChains, int kPanel, int kStages, int kWarpCols>
int launch_tiling(const float* X, const float* mu, const float* binv, const float* base,
                  const int* seed, int* z, int N, int D, int K, int C, int row_offset, void* stream) {
  const auto kernel = gaussian_assign_kernel<kChains, kPanel, kStages, kWarpCols>;
  const size_t bytes = Tiling<kPanel, kStages, kWarpCols>::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = D % 4 == 0 && (addr(X) | addr(mu) | addr(binv)) % 16 == 0;
  const int blocks = (N + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(X, mu, binv, base, seed, z, N,
                                                                         D, K, C, row_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

// The two tilings: 64 x 64 warp tiles and 32-input panels where they fit
// (D <= 256 on an H100), else 64 x 32 tiles and 16-input panels, which fit
// every D up to the maximum.
using Wide = Tiling<32, 2, 64>;
using Narrow = Tiling<16, 2, 32>;

template <bool kChains>
int launch(const float* X, const float* mu, const float* binv, const float* base, const int* seed,
           int* z, int N, int D, int K, int C, int row_offset, void* stream) {
  if (Wide::smem_bytes(D) <= static_cast<size_t>(optin_smem()))
    return launch_tiling<kChains, 32, 2, 64>(X, mu, binv, base, seed, z, N, D, K, C, row_offset, stream);
  return launch_tiling<kChains, 16, 2, 32>(X, mu, binv, base, seed, z, N, D, K, C, row_offset, stream);
}

// ---------------------------------------------------------------------------
// The warpgroup route: every D up to 256 whose rows are whole 16-byte
// pieces (D % 4 == 0, X 16-byte aligned); the head note gives its design.

constexpr int kConsumers = 2;                        // consumer warpgroups, 64 rows each
constexpr int kWgThreads = 128 * (kConsumers + 1);   // and one producer warpgroup
constexpr int kWPanel = 16;                          // inputs a panel: one 64-byte swizzled row

// The output width of one product (wgmma's N): D rounded up to 64, 128 or 256.
__host__ __device__ inline int wg_width(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <int kN>
struct Wg {
  static constexpr int kStages = kN == 256 ? 3 : kN == 128 ? 6 : 8;
  static constexpr int kHalf = kN * kWPanel;  // floats of one of a panel's hi, lo halves
  static constexpr int kStage = 2 * kHalf;    // floats of a stage: B_hi panel, then B_lo panel

  // Row stride of the row tile: a multiple of 32 floats, so the XOR of a
  // column with 8 (r & 3) stays inside its row.
  __host__ __device__ static int x_ld(int D) { return round_up(D, 32); }

  // 1 KB to align the stages, the stages, their mu slices, the full and
  // empty barriers, the row tile
  static size_t smem_bytes(int D) {
    return 1024 + sizeof(float) * (static_cast<size_t>(kStages) * (kStage + kWPanel) + static_cast<size_t>(kRows) * x_ld(D)) +
           2 * kStages * sizeof(uint64_t);
  }

  // Floats of the per-call scratch: B_hi and B_lo panels of every slot, then mu padded to Dp.
  static size_t scratch_floats(int D, int S) {
    const int Dp = round_up(D, kWPanel);
    return static_cast<size_t>(S) * (Dp / kWPanel) * kStage + static_cast<size_t>(S) * Dp;
  }
};

size_t wg_smem_bytes(int D) {
  const int n = wg_width(D);
  return n == 64 ? Wg<64>::smem_bytes(D) : n == 128 ? Wg<128>::smem_bytes(D) : Wg<256>::smem_bytes(D);
}

// Split each B_k once a call into the stages' layout: slot s, panel p is
// kStage floats, B_hi then B_lo, each [kN outputs][16 inputs] K-major with
// the 64-byte swizzle; zero past D. Within each 8-input step, input j sits
// at place j / 2 + 4 (j % 2), so that the A fragment's inputs t and t + 4
// are the row tile's neighbours 2t and 2t + 1. mu goes to [S][Dp], zero
// past D.
template <int kN>
__global__ void wg_split_kernel(const float* __restrict__ mu, const float* __restrict__ binv, float* __restrict__ bsplit,
                                float* __restrict__ mus, int S, int D) {
  using W = Wg<kN>;
  const int Dp = round_up(D, kWPanel), n_panels = Dp / kWPanel;
  const long long total = static_cast<long long>(S) * kN * Dp;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(e % Dp);
    const long long r = e / Dp;
    const int n = static_cast<int>(r % kN), s = static_cast<int>(r / kN);
    const float v = n < D && i < D ? binv[(static_cast<size_t>(s) * D + n) * D + i] : 0.0f;
    uint32_t hi, lo;
    tf32x3::split(v, hi, lo);
    const int k = i % kWPanel, place = (k & 8) | ((k & 7) >> 1) | ((k & 1) << 2);
    const uint32_t off = wgmma::swizzle64(static_cast<uint32_t>(n * kWPanel + place) * 4u) / 4u;
    float* blk = bsplit + (static_cast<size_t>(s) * n_panels + i / kWPanel) * W::kStage;
    blk[off] = __uint_as_float(hi);
    blk[W::kHalf + off] = __uint_as_float(lo);
    if (n == 0) mus[static_cast<size_t>(s) * Dp + i] = i < D ? mu[static_cast<size_t>(s) * D + i] : 0.0f;
  }
}

template <bool kChains, int kN>
__global__ void __launch_bounds__(kWgThreads, 1)
gaussian_assign_wgmma_kernel(const float* __restrict__ X, const float* __restrict__ bsplit,
                             const float* __restrict__ mus, const float* __restrict__ base,
                             const int* __restrict__ seed_ptr, int* __restrict__ z, int N, int D, int K, int C,
                             int row_offset) {
  using W = Wg<kN>;
  constexpr int kStages = W::kStages;
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  float* mslices = stages + kStages * W::kStage;  // [kStages][16] slices of mu
  uint64_t* full = reinterpret_cast<uint64_t*>(mslices + kStages * kWPanel);
  uint64_t* empty = full + kStages;
  float* xs = reinterpret_cast<float*>(empty + kStages);  // [kRows][xld] row tile, swizzled
  const int xld = W::x_ld(D);
  const int n_panels = round_up(D, kWPanel) / kWPanel;
  const int T = C * K * n_panels;  // panels over all slots
  const int row0 = blockIdx.x * kRows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wgmma::bar_init(&full[i], 1);
      wgmma::bar_init(&empty[i], 4 * kConsumers);  // lane 0 of every consumer warp
    }
    wgmma::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring of stages filled by TMA
    wgmma::shrink_registers<40>();
    if (threadIdx.x == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int p = 0; p < T; ++p) {
        wgmma::bar_wait(&empty[st], phase ^ 1u);  // a fresh stage passes at once
        wgmma::bar_expect(&full[st], sizeof(float) * (W::kStage + kWPanel));
        wgmma::bulk_load(stages + st * W::kStage, bsplit + static_cast<size_t>(p) * W::kStage,
                         sizeof(float) * W::kStage, &full[st]);
        wgmma::bulk_load(mslices + st * kWPanel, mus + static_cast<size_t>(p) * kWPanel, sizeof(float) * kWPanel,
                         &full[st]);
        if (++st == kStages) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    wgmma::grow_registers<232>();
    using tf32x3::split;
    const int ct = threadIdx.x - 128;
    const int cw = ct >> 7, wt = ct & 127;  // consumer warpgroup, thread within it
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    const int rb = cw * 64;  // the warpgroup's first row of the tile

    // its 64 rows of X, zero past N and D; column j of tile row r at j ^ 8 (r & 3)
    const int per_row = xld / 4;
    for (int c = wt; c < 64 * per_row; c += 128) {
      const int r = c / per_row, j = (c - r * per_row) * 4, row = row0 + rb + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < N && j < D) v = *reinterpret_cast<const float4*>(X + static_cast<size_t>(row) * D + j);
      *reinterpret_cast<float4*>(xs + (rb + r) * xld + (j ^ (8 * (r & 3)))) = v;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

    // rows g and g + 8 of the warp's m16 share; both have r & 3 == g & 3
    const float* xrow0 = xs + (rb + 16 * warp + g) * xld;
    const float* xrow1 = xrow0 + 8 * xld;
    const int sw = 8 * (g & 3);
    const int my_row = row0 + rb + 16 * warp + g + 8 * t;  // lanes t = 0, 1 own rows g, g + 8
    const uint32_t seed = static_cast<uint32_t>(*seed_ptr);

    float acc[kN / 2];
    uint32_t frag[2][2][2][4];  // A of a panel, two sets: [8-input step][hi, lo][fragment]
    float best = -INFINITY;
    int arg = 0;
    int st = 0, held = -1;  // stage of panel p; stage of the panel before, not yet given back
    uint32_t phase = 0;
    int ip = 0, s = 0, kc = 0, c = 0;  // panel p's panel within its slot, slot, slot within chain, chain
    bool pending = false;              // a finished slot's forms wait for their noise and argmax
    float q0 = 0.0f, q1 = 0.0f;
    int ps = 0, pkc = 0, pc = 0;

    // base + the Philox Gumbel + the running argmax for the slot whose forms are q0, q1
    auto finish = [&]() {
      if (t < 2) {
        if (my_row < N) {
          const float lp = base[ps] - 0.5f * (t == 0 ? q0 : q1) +
                           philox::gumbel(seed, static_cast<uint32_t>(row_offset + my_row), static_cast<uint32_t>(pkc),
                                          static_cast<uint32_t>(pc));
          if (lp > best) {
            best = lp;
            arg = pkc;
          }
        }
        if constexpr (kChains) {
          if (pkc == K - 1) {  // the chain's last slot: emit, then start the next chain
            if (my_row < N) z[static_cast<size_t>(pc) * N + my_row] = arg;
            best = -INFINITY;
            arg = 0;
          }
        }
      }
    };

    auto panel = [&](uint32_t (&a)[2][2][4]) {
      wgmma::bar_wait(&full[st], phase);
      const float* bs = stages + st * W::kStage;
      const float* ms = mslices + st * kWPanel;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // centre in fp32, then split: fragment inputs t and t + 4 are the
        // step's columns 2t and 2t + 1; rows g and g + 8
        const float2 m = *reinterpret_cast<const float2*>(ms + 8 * h + 2 * t);
        const int col = (ip * kWPanel + 8 * h + 2 * t) ^ sw;
        const float2 x0 = *reinterpret_cast<const float2*>(xrow0 + col);
        const float2 x1 = *reinterpret_cast<const float2*>(xrow1 + col);
        split(x0.x - m.x, a[h][0][0], a[h][1][0]);
        split(x1.x - m.x, a[h][0][1], a[h][1][1]);
        split(x0.y - m.y, a[h][0][2], a[h][1][2]);
        split(x1.y - m.y, a[h][0][3], a[h][1][3]);
      }
      wgmma::fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t bh = wgmma::desc_sw64(bs + 8 * h);  // the step's 32 bytes of each 64-byte row
        const uint64_t bl = wgmma::desc_sw64(bs + W::kHalf + 8 * h);
        // the small passes first, then hi * hi; a slot's first product starts the sum
        wgmma::mma_async(acc, a[h][1], bh, ip > 0 || h > 0);
        wgmma::mma_async(acc, a[h][0], bl, 1);
        wgmma::mma_async(acc, a[h][0], bh, 1);
      }
      wgmma::commit();

      // the last slot's noise and argmax run while these products do
      if (pending) {
        finish();
        pending = false;
      }
      if (ip == n_panels - 1) {
        // the slot is done: every output of B_k is in acc; outputs past D
        // have zero rows of B_k and add 0
        wgmma::wait<0>();
        wgmma::fence_operand(acc);
        if (lane == 0) {
          if (held >= 0) wgmma::bar_arrive(&empty[held]);
          wgmma::bar_arrive(&empty[st]);
        }
        held = -1;
        float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          f0 = fmaf(acc[4 * j], acc[4 * j], fmaf(acc[4 * j + 1], acc[4 * j + 1], f0));
          f1 = fmaf(acc[4 * j + 2], acc[4 * j + 2], fmaf(acc[4 * j + 3], acc[4 * j + 3], f1));
        }
        f0 += __shfl_xor_sync(0xffffffffu, f0, 1);
        f0 += __shfl_xor_sync(0xffffffffu, f0, 2);
        f1 += __shfl_xor_sync(0xffffffffu, f1, 1);
        f1 += __shfl_xor_sync(0xffffffffu, f1, 2);
        q0 = f0;
        q1 = f1;
        ps = s;
        pkc = kc;
        pc = c;
        pending = true;
      } else {
        wgmma::wait<1>();  // the panel before is done: give its stage back
        if (lane == 0 && held >= 0) wgmma::bar_arrive(&empty[held]);
        held = st;
      }
      if (++st == kStages) {
        st = 0;
        phase ^= 1u;
      }
      if (++ip == n_panels) {
        ip = 0;
        ++s;
        if (++kc == K) {
          kc = 0;
          ++c;
        }
      }
    };

    for (int p = 0; p < T; p += 2) {
      panel(frag[0]);
      if (p + 1 < T) panel(frag[1]);
    }
    if (pending) finish();
    if constexpr (!kChains) {
      if (t < 2 && my_row < N) z[my_row] = arg;
    }
  }
}

template <bool kChains, int kN>
int launch_wgmma_width(const float* X, const float* mu, const float* binv, const float* base, const int* seed, int* z,
                       float* scratch, int N, int D, int K, int C, int row_offset, void* stream) {
  using W = Wg<kN>;
  const auto st = static_cast<cudaStream_t>(stream);
  const int S = C * K, Dp = round_up(D, kWPanel);
  float* bsplit = scratch;
  float* mus = scratch + static_cast<size_t>(S) * (Dp / kWPanel) * W::kStage;
  const long long total = static_cast<long long>(S) * kN * Dp;
  const int split_blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  wg_split_kernel<kN><<<split_blocks, 256, 0, st>>>(mu, binv, bsplit, mus, S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = gaussian_assign_wgmma_kernel<kChains, kN>;
  const size_t bytes = W::smem_bytes(D);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(N + kRows - 1) / kRows, kWgThreads, bytes, st>>>(X, bsplit, mus, base, seed, z, N, D, K, C, row_offset);
  return static_cast<int>(cudaGetLastError());
}

template <bool kChains>
int launch_wgmma(const float* X, const float* mu, const float* binv, const float* base, const int* seed, int* z,
                 float* scratch, int N, int D, int K, int C, int row_offset, void* stream) {
  switch (wg_width(D)) {
    case 64:
      return launch_wgmma_width<kChains, 64>(X, mu, binv, base, seed, z, scratch, N, D, K, C, row_offset, stream);
    case 128:
      return launch_wgmma_width<kChains, 128>(X, mu, binv, base, seed, z, scratch, N, D, K, C, row_offset, stream);
    default:
      return launch_wgmma_width<kChains, 256>(X, mu, binv, base, seed, z, scratch, N, D, K, C, row_offset, stream);
  }
}

}  // namespace

extern "C" {

// Largest D whose working set (row tile, two stages) fits a block's shared memory.
int gaussian_assign_max_dim(void) {
  const size_t optin = static_cast<size_t>(optin_smem());
  int d = 0;
  while (Narrow::smem_bytes(d + 16) <= optin) d += 16;
  return d;
}

// X [N, D], mu [K, D], binv [K, D, D], base [K] float32; seed [1] int32;
// z [N] int32 output. All on the device, contiguous. row_offset is added to
// the Philox counter's row word, not to any index: rows of X drawn as rows
// row_offset .. row_offset + N - 1 of a larger X, so a row shard draws the
// noise a launch over the whole X draws for those rows. Returns the CUDA
// error code of the launch (0 on success).
int gaussian_assign_launch(const float* X, const float* mu, const float* binv, const float* base,
                           const int* seed, int* z, int N, int D, int K, int row_offset,
                           void* stream) {
  return launch<false>(X, mu, binv, base, seed, z, N, D, K, 1, row_offset, stream);
}

// The multi-chain form: mu [C*K, D], binv [C*K, D, D], base [C*K] chain-major,
// z [C, N] int32 output; K is the number of slots per chain.
int gaussian_assign_chains_launch(const float* X, const float* mu, const float* binv,
                                  const float* base, const int* seed, int* z, int N, int D, int K,
                                  int C, void* stream) {
  return launch<true>(X, mu, binv, base, seed, z, N, D, K, C, 0, stream);
}

// The warpgroup route (`launch_wgmma`): the largest D it takes on this
// device, a multiple of 4 up to 256 whose working set fits shared memory.
int gaussian_assign_wgmma_max_dim(void) {
  const size_t optin = static_cast<size_t>(optin_smem());
  int d = 0;
  while (d + 4 <= 256 && wg_smem_bytes(d + 4) <= optin) d += 4;
  return d;
}

// Bytes of shared memory a warpgroup launch at width D asks for.
long long gaussian_assign_wgmma_smem(int D) { return static_cast<long long>(wg_smem_bytes(D)); }

// Floats of the scratch a warpgroup launch over S = C * K slots at width D needs.
long long gaussian_assign_wgmma_scratch(int D, int S) {
  switch (wg_width(D)) {
    case 64:
      return static_cast<long long>(Wg<64>::scratch_floats(D, S));
    case 128:
      return static_cast<long long>(Wg<128>::scratch_floats(D, S));
    default:
      return static_cast<long long>(Wg<256>::scratch_floats(D, S));
  }
}

// `gaussian_assign_launch` on the warpgroup route: D % 4 == 0, D at most
// `gaussian_assign_wgmma_max_dim()`, X 16-byte aligned; `scratch` holds
// `gaussian_assign_wgmma_scratch(D, K)` floats on the device.
int gaussian_assign_wgmma_launch(const float* X, const float* mu, const float* binv, const float* base,
                                 const int* seed, int* z, float* scratch, int N, int D, int K, int row_offset,
                                 void* stream) {
  return launch_wgmma<false>(X, mu, binv, base, seed, z, scratch, N, D, K, 1, row_offset, stream);
}

// `gaussian_assign_chains_launch` on the warpgroup route; scratch of
// `gaussian_assign_wgmma_scratch(D, C * K)` floats.
int gaussian_assign_chains_wgmma_launch(const float* X, const float* mu, const float* binv, const float* base,
                                        const int* seed, int* z, float* scratch, int N, int D, int K, int C,
                                        void* stream) {
  return launch_wgmma<true>(X, mu, binv, base, seed, z, scratch, N, D, K, C, 0, stream);
}

}  // extern "C"
