"""Fused Gaussian score + Gumbel + argmax: the blocked-Gibbs assignment draw.

    z_n = argmax_k [ base_k - 1/2 ||B_k (x_n - mu_k)||^2 + Gumbel_nk ]

`fused_gaussian_assign` replaces the Pallas kernel
`common_tpu/ops/gaussian_assign.py:fused_gaussian_assign`
(`_assign_kernel`), and `fused_gaussian_assign_chains` replaces its
multi-chain form of the same name (`_assign_chains_kernel`): C chains
share X, chain c owns slots cK .. cK + K - 1 of mu, B and base, and the
argmax is taken within each chain, z [C, N]. Both are one CUDA kernel,
instantiated with and without the chain axis. Like the Pallas kernels,
the [N, K] score and noise tables never reach device memory: X is read
once for all chains and z written once. The CUDA kernel
(`csrc/gaussian_assign.cu`) runs the N*K*D^2 multiply-adds on the tensor
cores as 3xTF32 split products (`csrc/tf32x3.cuh`: each operand split
into a TF32 high part and the fp32 rest, three TF32 products summed in
fp32), which keeps fp32 accuracy; no product is a single TF32 pass. It
streams each B_k through shared memory in panels, because one B_k at
D = 256 (256 KB) does not fit a block's 227 KB, and takes any D up to
`gaussian_assign_max_dim` (384 on an H100); wider rows raise. It has two
routes, chosen by `wgmma_route` from D and X's alignment alone: Hopper's
warpgroup products (`wgmma`, B's split panels brought by TMA from a
scratch the wrapper allocates) for every D up to 256 that is a multiple
of 4 with X 16-byte aligned, and `mma.sync` for the rest. Each launch on
the first route adds one to the wrapper's `wgmma` and to the program
counter `assign.wgmma`.
Its Gumbel noise is a Philox4x32-10 stream keyed on the seed with
counter (row_offset + row, k, c), k the slot within chain c, so the draws
do not depend on the tiling, chain 0 draws the single-chain stream, and a
shard of rows given its first row's global index as `row_offset` draws
what a launch over all rows draws for them (the data-sharded sweep,
`parallel/sharded.py`). The seed is read
from a device int32 tensor, so the host never waits for it. The Pallas
kernels' tiling arguments (`tile_n`, `k_tile`, `interpret`) and their
padding of K exist for the TPU's VMEM tiling and have no counterpart here.

Inputs
  X     [N, D]     rows
  mu    [K, D]     cluster means
  binv  [K, D, D]  B_k = L_k^{-1} with L_k = chol(Sigma_k)
  base  [K]        log w_k - 1/2 log|Sigma_k| - D/2 log 2 pi
  seed  [1] int32  per-sweep seed, on the device of X
Returns z [N] int32.
"""

from __future__ import annotations

import torch

from common_tpu_torch.ops import _build
from common_tpu_torch.ops.philox import GAUSSIAN_STREAM, gumbel_from_bits, philox4x32_10, philox_key
from common_tpu_torch.rng import gumbel_argmax, gumbel_argmax_rows
from common_tpu_torch.utils import profiling


def gaussian_scores(X: torch.Tensor, mu: torch.Tensor, binv: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
    """[N, K] table base_k - 1/2 ||(x_n - mu_k) B_k^T||^2, one matmul per cluster."""
    cols = []
    for k in range(mu.shape[0]):
        y = (X - mu[k]) @ binv[k].T
        cols.append(base[k] - 0.5 * torch.sum(y * y, dim=-1))
    return torch.stack(cols, dim=-1)


def gaussian_assign_plain(X, mu, binv, base, generator: torch.Generator,
                          row_offset: int = 0) -> torch.Tensor:
    """Plain version: the score table, Gumbel noise from `generator`, argmax.

    With a row_offset the noise is rows row_offset .. row_offset + N - 1
    of the [row_offset + N, K] table the generator draws, so a shard of
    rows draws what a call over all rows draws for them.
    """
    return gumbel_argmax_rows(gaussian_scores(X, mu, binv, base), generator, row_offset).to(torch.int32)


def gaussian_assign_chains_plain(X, mu, binv, base, n_chains: int,
                                 generator: torch.Generator) -> torch.Tensor:
    """Plain version of the multi-chain draw: z [C, N].

    The score table of every chain's slots, Gumbel noise from `generator`,
    and the argmax within each chain.
    """
    logp = gaussian_scores(X, mu, binv, base).reshape(X.shape[0], n_chains, -1)
    return gumbel_argmax(logp, generator).T.contiguous().to(torch.int32)


def philox_gumbel(seed: torch.Tensor, rows: torch.Tensor, k: int, chain: int = 0) -> torch.Tensor:
    """[len(rows), k] float32: the Gumbel noise the Gaussian kernels add, in plain ops.

    Philox4x32-10 keyed on (seed, 0x5EED) with counter (row, cluster,
    chain, GAUSSIAN_STREAM) (`csrc/philox.cuh` gumbel), the uniform from
    the top 24 bits of the first word, floored at 1e-7. `rows` are global
    row indices, so any slice of X can be checked draw for draw against a
    kernel; `cluster` counts from 0 within `chain`.
    """
    r = rows.to(torch.int64)[:, None].expand(-1, k)
    c = torch.arange(k, device=rows.device, dtype=torch.int64)[None, :].expand_as(r)
    zero = torch.zeros_like(r)
    return gumbel_from_bits(philox4x32_10((r, c, zero + chain, zero + GAUSSIAN_STREAM), philox_key(seed))[0])


def philox_scores(X, mu, binv, base, seed: torch.Tensor, row0: int = 0,
                  chain: int = 0) -> torch.Tensor:
    """[N, K] scores plus a kernel's own noise for rows row0 .. row0 + N - 1.

    Its argmax is the draw the CUDA kernel makes with `seed`, up to fp32
    rounding, so the kernel can be checked row for row. For the multi-chain
    kernel, pass chain c's slots of mu, binv and base and `chain=c`.
    """
    rows = torch.arange(row0, row0 + X.shape[0], device=X.device)
    return gaussian_scores(X, mu, binv, base) + philox_gumbel(seed, rows, mu.shape[0], chain)


def _check(X, mu, binv, base, seed) -> None:
    if X.dim() != 2 or mu.dim() != 2 or binv.dim() != 3 or base.dim() != 1:
        raise ValueError("expected X [N, D], mu [K, D], binv [K, D, D], base [K]")
    (N, D), K = X.shape, mu.shape[0]
    if mu.shape != (K, D) or binv.shape != (K, D, D) or base.shape != (K,) or K < 1:
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, mu {tuple(mu.shape)}, "
            f"binv {tuple(binv.shape)}, base {tuple(base.shape)}"
        )
    if seed.numel() != 1:
        raise ValueError(f"seed must hold one value, got shape {tuple(seed.shape)}")
    for name, t in (("mu", mu), ("binv", binv), ("base", base), ("seed", seed)):
        if t.device != X.device:
            raise ValueError(f"X is on {X.device} but {name} is on {t.device}")


def wgmma_route(X: torch.Tensor, max_dim: int) -> bool:
    """True where a launch takes the warpgroup kernel, False for `mma.sync`.

    The warpgroup kernel loads X's rows as 16-byte pieces and its products'
    width stops at 256: D a multiple of 4, at most `max_dim` (the device's
    `gaussian_assign_wgmma_max_dim`, 256 on an H100), X 16-byte aligned.
    """
    D = X.shape[1]
    return 0 < D <= max_dim and D % 4 == 0 and X.data_ptr() % 16 == 0


def _launch_checks(X, mu, binv, base, seed, what: str):
    """Device, type, layout and width checks before a launch; the kernel
    library and whether the launch takes the warpgroup route."""
    if X.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {X.device}")
    for name, t in (("X", X), ("mu", mu), ("binv", binv), ("base", base)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
    if seed.dtype != torch.int32:
        raise ValueError(f"seed must be int32, got {seed.dtype}")
    lib = _build.library()
    with torch.cuda.device(X.device):
        max_dim, wgmma_dim = lib.gaussian_assign_max_dim(), lib.gaussian_assign_wgmma_max_dim()
    if X.shape[1] > max_dim:
        raise ValueError(f"{what} supports D <= {max_dim}, got {X.shape[1]}")
    return lib, wgmma_route(X, wgmma_dim)


def _scratch(lib, X, slots: int) -> torch.Tensor:
    """The warpgroup route's B_hi, B_lo panels and padded mu for `slots` slots."""
    return torch.empty(lib.gaussian_assign_wgmma_scratch(X.shape[1], slots), device=X.device, dtype=torch.float32)


def fused_gaussian_assign(X: torch.Tensor, mu: torch.Tensor, binv: torch.Tensor,
                          base: torch.Tensor, seed: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Sample z_n ~ Cat(softmax_k(base_k - 1/2 Mahalanobis^2)) for all rows.

    row_offset: the global index of X's first row, when X is a shard of a
    larger X. It moves the noise, not the rows: the kernel's Philox counter
    of row n is (row_offset + n, k, 0), so the shard draws the noise that a
    launch over the whole X draws for those rows.

    CUDA: float32 inputs and an int32 seed, contiguous; launches
    `csrc/gaussian_assign.cu`. CPU: `gaussian_assign_plain`, its noise
    drawn from a generator seeded with `seed`. Any other device raises.
    """
    _check(X, mu, binv, base, seed)
    if row_offset < 0 or row_offset + X.shape[0] > 2**31 - 1:
        raise ValueError(f"row_offset {row_offset} + {X.shape[0]} rows must lie in [0, 2^31)")
    if X.device.type == "cpu":
        g = torch.Generator().manual_seed(int(seed.reshape(())))
        return gaussian_assign_plain(X, mu, binv, base, g, row_offset)
    lib, wgmma = _launch_checks(X, mu, binv, base, seed, "fused_gaussian_assign")
    N, D = X.shape
    K = mu.shape[0]
    z = torch.empty(N, device=X.device, dtype=torch.int32)
    if N == 0:
        return z
    ptrs = (X.data_ptr(), mu.data_ptr(), binv.data_ptr(), base.data_ptr(), seed.data_ptr(), z.data_ptr())
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if wgmma:
            scratch = _scratch(lib, X, K)
            err = lib.gaussian_assign_wgmma_launch(*ptrs, scratch.data_ptr(), N, D, K, row_offset, stream)
        else:
            err = lib.gaussian_assign_launch(*ptrs, N, D, K, row_offset, stream)
    _build.check(err, "gaussian_assign_launch")
    fused_gaussian_assign.launches += 1
    if wgmma:
        fused_gaussian_assign.wgmma += 1
        profiling.count("assign.wgmma")
    return z


fused_gaussian_assign.launches = 0
fused_gaussian_assign.wgmma = 0  # launches on the warpgroup route


def fused_gaussian_assign_chains(X: torch.Tensor, mu: torch.Tensor, binv: torch.Tensor,
                                 base: torch.Tensor, seed: torch.Tensor,
                                 n_chains: int) -> torch.Tensor:
    """Per-chain draws for C chains sharing X: z [C, N] int32.

    mu [C*K, D], binv [C*K, D, D] (any square B_k, not only triangular),
    base [C*K], chain-major. CUDA: float32 inputs and an int32 seed,
    contiguous; launches the chain form of `csrc/gaussian_assign.cu`. CPU:
    `gaussian_assign_chains_plain`, its noise drawn from a generator seeded
    with `seed`. Any other device raises.
    """
    _check(X, mu, binv, base, seed)
    if n_chains < 1 or mu.shape[0] % n_chains:
        raise ValueError(f"mu rows {mu.shape[0]} must be n_chains * K, n_chains={n_chains}")
    if X.device.type == "cpu":
        g = torch.Generator().manual_seed(int(seed.reshape(())))
        return gaussian_assign_chains_plain(X, mu, binv, base, n_chains, g)
    lib, wgmma = _launch_checks(X, mu, binv, base, seed, "fused_gaussian_assign_chains")
    N, D = X.shape
    K = mu.shape[0] // n_chains
    z = torch.empty((n_chains, N), device=X.device, dtype=torch.int32)
    if N == 0:
        return z
    ptrs = (X.data_ptr(), mu.data_ptr(), binv.data_ptr(), base.data_ptr(), seed.data_ptr(), z.data_ptr())
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if wgmma:
            scratch = _scratch(lib, X, n_chains * K)
            err = lib.gaussian_assign_chains_wgmma_launch(*ptrs, scratch.data_ptr(), N, D, K, n_chains, stream)
        else:
            err = lib.gaussian_assign_chains_launch(*ptrs, N, D, K, n_chains, stream)
    _build.check(err, "gaussian_assign_chains_launch")
    fused_gaussian_assign_chains.launches += 1
    if wgmma:
        fused_gaussian_assign_chains.wgmma += 1
        profiling.count("assign.wgmma")
    return z


fused_gaussian_assign_chains.launches = 0
fused_gaussian_assign_chains.wgmma = 0  # launches on the warpgroup route
