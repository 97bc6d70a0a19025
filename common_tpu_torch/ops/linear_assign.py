"""Fused linear score + Gumbel + argmax: the assignment draw for affine scores.

    z_n = argmax_k [ base_k + x_n . w_k + Gumbel_nk ]

This covers the vector Beta-Bernoulli (bbv: w_k = logit p_k, base_k = log
mixture weight + sum_d log(1 - p_kd)). `fused_linear_assign` replaces the
Pallas kernel `common_tpu/ops/linear_assign.py:fused_linear_assign`
(`_linear_kernel`). Like it, the [N, K] score and noise tables never reach
device memory: X is read once and z written once. The CUDA kernel
(`csrc/linear_assign.cu`) computes the product itself, on the CUDA cores in
fp32, one row per thread; at the config-2 shape it is bound by reading X
and drawing N*K Philox numbers, not by the product (see the source). Its
noise is the Gaussian kernel's stream, Philox4x32-10 keyed on the seed with
counter (row, k), so `linear_philox_scores` checks it draw for draw. The
Pallas kernel's tiling arguments and its padding of K have no counterpart.

Inputs
  X     [N, D]  rows (0/1 for bbv), float32
  W     [K, D]  per-cluster weights
  base  [K]     per-cluster offsets
  seed  [1] int32, on the device of X
Returns z [N] int32.
"""

from __future__ import annotations

import torch

from common_tpu_torch.ops import _build
from common_tpu_torch.ops.gaussian_assign import philox_gumbel
from common_tpu_torch.rng import gumbel_argmax


def linear_scores(X: torch.Tensor, W: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """[N, K] table X @ W^T + base."""
    return X @ W.T + base


def linear_assign_plain(X, W, base, generator: torch.Generator) -> torch.Tensor:
    """Plain version: the score table, Gumbel noise from `generator`, argmax."""
    return gumbel_argmax(linear_scores(X, W, base), generator).to(torch.int32)


def linear_philox_scores(X, W, base, seed: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """[N, K] scores plus the kernel's own noise for rows row0 .. row0 + N - 1.

    Its argmax is the draw the CUDA kernel makes with `seed`, up to fp32
    rounding, so the kernel can be checked row for row.
    """
    rows = torch.arange(row0, row0 + X.shape[0], device=X.device)
    return linear_scores(X, W, base) + philox_gumbel(seed, rows, W.shape[0])


def _check(X, W, base, seed) -> None:
    if X.dim() != 2 or W.dim() != 2 or base.dim() != 1:
        raise ValueError("expected X [N, D], W [K, D], base [K]")
    (N, D), K = X.shape, W.shape[0]
    if W.shape != (K, D) or base.shape != (K,) or K < 1:
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, W {tuple(W.shape)}, base {tuple(base.shape)}"
        )
    if seed.numel() != 1:
        raise ValueError(f"seed must hold one value, got shape {tuple(seed.shape)}")
    for name, t in (("W", W), ("base", base), ("seed", seed)):
        if t.device != X.device:
            raise ValueError(f"X is on {X.device} but {name} is on {t.device}")


def fused_linear_assign(X: torch.Tensor, W: torch.Tensor, base: torch.Tensor,
                        seed: torch.Tensor) -> torch.Tensor:
    """Sample z_n ~ Cat(softmax_k(base_k + x_n . w_k)) for all rows.

    CUDA: float32 inputs and an int32 seed, contiguous; launches
    `csrc/linear_assign.cu`. CPU: `linear_assign_plain`, its noise drawn
    from a generator seeded with `seed`. Any other device raises.
    """
    _check(X, W, base, seed)
    if X.device.type == "cpu":
        g = torch.Generator().manual_seed(int(seed.reshape(())))
        return linear_assign_plain(X, W, base, g)
    if X.device.type != "cuda":
        raise ValueError(f"fused_linear_assign: no kernel for device {X.device}")
    for name, t in (("X", X), ("W", W), ("base", base)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
    if seed.dtype != torch.int32:
        raise ValueError(f"seed must be int32, got {seed.dtype}")
    N, D = X.shape
    K = W.shape[0]
    z = torch.empty(N, device=X.device, dtype=torch.int32)
    if N == 0:
        return z
    lib = _build.library()
    with torch.cuda.device(X.device):
        err = lib.linear_assign_launch(
            X.data_ptr(), W.data_ptr(), base.data_ptr(), seed.data_ptr(), z.data_ptr(),
            N, D, K, torch.cuda.current_stream(X.device).cuda_stream,
        )
    _build.check(err, "linear_assign_launch")
    fused_linear_assign.launches += 1
    return z


fused_linear_assign.launches = 0
