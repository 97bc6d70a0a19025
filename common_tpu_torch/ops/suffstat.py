"""Per-cluster scatter matrices for the blocked-Gibbs restat.

    sum_xxT[k] = sum over rows n with z_n = k of x_n x_n^T      [K, D, D]

`fused_scatter_stats` replaces the Pallas kernel
`common_tpu/ops/suffstat.py:fused_scatter_stats` (`_make_restat_kernel`).
That kernel runs one masked product per cluster, K times the needed
multiply-adds. Here the rows are first ordered by cluster (a stable sort,
plain tensor code around the kernel, as the JAX package left its one-hot
to XLA), and the CUDA kernel (`csrc/suffstat.cu`) gives each block one
(cluster, slice of that cluster's rows, output tile): N*D^2 multiply-adds
instead of N*K*D^2. Each slice writes a partial sum, and the partials are
added here in a fixed order, so a large cluster does not leave the other
SMs idle, no atomics are needed and the result is deterministic. What
bounds it on the card and how it deals with that is in the source.

Precision: fp32 FMA on the CUDA cores, no TF32 and no tensor cores.

Rows with z outside [0, K) (masked rows routed to K) add nothing.
"""

from __future__ import annotations

import torch

from common_tpu_torch.ops import _build

# Each cluster's rows are cut into this many slices, one partial sum each;
# fewer where the [splits, K, D, D] partials would pass SCRATCH_FLOATS.
MAX_SPLITS = 8
SCRATCH_FLOATS = 1 << 26


def scatter_stats_plain(X: torch.Tensor, z: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version: one one-hot-weighted X^T X per cluster, [K, D, D]."""
    ks = torch.arange(K, device=z.device)
    onehot = (z.reshape(-1, 1) == ks).to(X.dtype)  # [N, K]
    return torch.stack([(X * onehot[:, k, None]).T @ X for k in range(K)])


def _check(X: torch.Tensor, z: torch.Tensor, K: int) -> None:
    if X.dim() != 2 or z.dim() != 1 or z.shape[0] != X.shape[0]:
        raise ValueError(
            f"expected X [N, D] and z [N], got {tuple(X.shape)} and {tuple(z.shape)}"
        )
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    if z.device != X.device:
        raise ValueError(f"X is on {X.device} but z is on {z.device}")


def fused_scatter_stats(X: torch.Tensor, z: torch.Tensor, K: int) -> torch.Tensor:
    """sum_xxT [K, D, D] from rows X [N, D] and assignments z [N].

    CUDA: float32 X, int32 z, both contiguous; launches `csrc/suffstat.cu`.
    CPU: `scatter_stats_plain`. Any other device raises.
    """
    _check(X, z, K)
    if X.device.type == "cpu":
        return scatter_stats_plain(X, z, K)
    if X.device.type != "cuda":
        raise ValueError(f"fused_scatter_stats: no kernel for device {X.device}")
    if X.dtype != torch.float32 or z.dtype != torch.int32:
        raise ValueError(f"expected float32 X and int32 z, got {X.dtype} and {z.dtype}")
    if not (X.is_contiguous() and z.is_contiguous()):
        raise ValueError("fused_scatter_stats needs contiguous X and z")
    N, D = X.shape
    zi = torch.where((z >= 0) & (z < K), z, K)
    # Stable order groups the rows by cluster, masked rows (K) last; the
    # offsets come from a search of the sorted ids, not torch.bincount,
    # whose CUDA version waits for the device to size its output.
    zs, order = torch.sort(zi, stable=True)
    offsets = torch.searchsorted(
        zs, torch.arange(K + 1, device=X.device, dtype=torch.int32)
    ).to(torch.int32)
    order = order.to(torch.int32)
    splits = max(1, min(MAX_SPLITS, SCRATCH_FLOATS // max(1, K * D * D)))
    partial = torch.empty((splits, K, D, D), device=X.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(X.device):
        err = lib.scatter_stats_launch(
            X.data_ptr(), order.data_ptr(), offsets.data_ptr(), partial.data_ptr(),
            D, K, splits, torch.cuda.current_stream(X.device).cuda_stream,
        )
    _build.check(err, "scatter_stats_launch")
    fused_scatter_stats.launches += 1
    return partial.sum(0)


fused_scatter_stats.launches = 0
