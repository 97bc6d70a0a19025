"""Per-cluster scatter matrices for the blocked-Gibbs restat.

    sum_xxT[k] = sum over rows n with z_n = k of x_n x_n^T      [K, D, D]

`fused_scatter_stats` replaces the Pallas kernel
`common_tpu/ops/suffstat.py:fused_scatter_stats` (`_make_restat_kernel`).
That kernel runs one masked product per cluster, K times the needed
multiply-adds. Here the rows are first ordered by cluster (a stable sort,
plain tensor code around the kernel, as the JAX package left its one-hot
to XLA; `sort_by_cluster`), the sorted rows are cut into chunks of equal
size, each within one cluster (`chunk_schedule`, on the device, so the
host never waits), and the CUDA kernel (`csrc/suffstat.cu`) gives each
block one (chunk, 64 x 64 output tile on or above the diagonal): N*D^2
multiply-adds instead of N*K*D^2, with a 333k-row cluster spread over as
many blocks as its rows need. Each chunk writes a partial sum and its
mirror, and a second kernel adds each cluster's partials in chunk order,
so no atomics are needed, the result is deterministic and exactly
symmetric. What bounds it on the card and how it deals with that is in the
source.

Precision: 3xTF32 split products on the tensor cores, fp32 accumulation
(`csrc/tf32x3.cuh`); no single-pass TF32.

Rows with z outside [0, K) (masked rows routed to K) add nothing.
"""

from __future__ import annotations

import torch

from common_tpu_torch.ops import _build

# Rows of a chunk; more where the [U, D, D] chunk partials would pass
# SCRATCH_FLOATS.
ROWS_PER_CHUNK = 8192
SCRATCH_FLOATS = 1 << 26


def weighted_stats_plain(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[K, D, D] sum_n w[n, k] x_n x_n^T: one weighted X^T X per cluster,
    so no [N, D, D] or [N, K, D] tensor is made."""
    return torch.stack([(X * w[:, k, None]).T @ X for k in range(w.shape[1])])


def scatter_stats_plain(X: torch.Tensor, z: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version: one one-hot-weighted X^T X per cluster, [K, D, D]."""
    ks = torch.arange(K, device=z.device)
    return weighted_stats_plain(X, (z.reshape(-1, 1) == ks).to(X.dtype))


def _check(X: torch.Tensor, z: torch.Tensor, K: int) -> None:
    if X.dim() != 2 or z.dim() != 1 or z.shape[0] != X.shape[0]:
        raise ValueError(
            f"expected X [N, D] and z [N], got {tuple(X.shape)} and {tuple(z.shape)}"
        )
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    if z.device != X.device:
        raise ValueError(f"X is on {X.device} but z is on {z.device}")


def rows_per_chunk(n_rows: int, D: int, K: int) -> int:
    """Rows of a chunk: ROWS_PER_CHUNK, or more where the partials of
    n_rows // rows + K chunks would pass SCRATCH_FLOATS."""
    room = SCRATCH_FLOATS // max(1, D * D) - K
    if room < 1:
        return max(1, n_rows)
    return max(ROWS_PER_CHUNK, -(-n_rows // room))


def chunk_schedule(offsets: torch.Tensor, n_rows: int, rows: int):
    """Cut each cluster's sorted rows into chunks of `rows` (its last shorter).

    offsets [K + 1]: cluster k owns sorted positions offsets[k] ..
    offsets[k + 1] - 1. Returns int32 tensors on offsets' device: cstart
    [K + 1] (cluster k owns chunks cstart[k] .. cstart[k + 1] - 1) and lo, hi
    [U] (chunk u owns positions lo[u] .. hi[u] - 1; empty past the last
    chunk), with U = n_rows // rows + K, which bounds the chunk count. All
    fixed-size tensor ops: nothing waits for the device.
    """
    K = offsets.numel() - 1
    off = offsets.to(torch.int64)
    cstart = torch.zeros(K + 1, dtype=torch.int64, device=off.device)
    cstart[1:] = torch.cumsum((off[1:] - off[:-1] + rows - 1) // rows, 0)
    u = torch.arange(n_rows // rows + K, dtype=torch.int64, device=off.device)
    k = torch.searchsorted(cstart[1:], u, right=True).clamp_(max=K - 1)
    lo = off[k] + (u - cstart[k]) * rows
    hi = torch.minimum(lo + rows, off[k + 1])
    valid = u < cstart[K]
    lo = torch.where(valid, lo, 0)
    hi = torch.where(valid, hi, 0)
    return cstart.to(torch.int32), lo.to(torch.int32), hi.to(torch.int32)


def sort_by_cluster(z: torch.Tensor, K: int):
    """(order, offsets): row indices grouped by cluster with a stable sort,
    masked rows (z outside [0, K)) last; cluster k owns
    order[offsets[k]:offsets[k + 1]]. Both int32, on z's device.

    The offsets come from a search of the sorted ids, not torch.bincount,
    whose CUDA version waits for the device to size its output.
    """
    zi = torch.where((z >= 0) & (z < K), z, K)
    zs, order = torch.sort(zi, stable=True)
    offsets = torch.searchsorted(zs, torch.arange(K + 1, device=z.device, dtype=zs.dtype))
    return order.to(torch.int32), offsets.to(torch.int32)


def scatter_sorted(X: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """sum_xxT [K, D, D] from rows grouped by `sort_by_cluster`: the launch.

    CUDA only: float32 X, int32 order and offsets, contiguous.
    """
    N, D = X.shape
    K = offsets.numel() - 1
    rows = rows_per_chunk(N, D, K)
    cstart, lo, hi = chunk_schedule(offsets, N, rows)
    partial = torch.empty((lo.numel(), D, D), device=X.device, dtype=torch.float32)
    out = torch.empty((K, D, D), device=X.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(X.device):
        err = lib.scatter_stats_launch(
            X.data_ptr(), order.data_ptr(), lo.data_ptr(), hi.data_ptr(), cstart.data_ptr(),
            partial.data_ptr(), out.data_ptr(), D, K, lo.numel(),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _build.check(err, "scatter_stats_launch")
    fused_scatter_stats.launches += 1
    return out


def fused_scatter_stats(X: torch.Tensor, z: torch.Tensor, K: int) -> torch.Tensor:
    """sum_xxT [K, D, D] from rows X [N, D] and assignments z [N].

    CUDA: float32 X, int32 z, both contiguous; `sort_by_cluster`, then
    `scatter_sorted` launches `csrc/suffstat.cu`. CPU:
    `scatter_stats_plain`. Any other device raises.
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
    order, offsets = sort_by_cluster(z, K)
    return scatter_sorted(X, order, offsets)


fused_scatter_stats.launches = 0
