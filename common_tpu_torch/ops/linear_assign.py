"""Fused linear score + Gumbel + argmax: the assignment draw for affine scores.

    z_n = argmax_k [ base_k + x_n . w_k + Gumbel_nk ]

This covers the vector Beta-Bernoulli (bbv: w_k = logit p_k, base_k = log
mixture weight + sum_d log(1 - p_kd)). `fused_linear_assign` replaces the
Pallas kernel `common_tpu/ops/linear_assign.py:fused_linear_assign`
(`_linear_kernel`). Like it, the [N, K] score and noise tables never reach
device memory: X is read once and z written once. The CUDA kernel
(`csrc/linear_assign.cu`) runs the product on the tensor cores as 3xTF32
split products (fp32-accurate, as the Gaussian kernels do) and draws noise
only for the clusters that can still win: a cluster more than REACH nats
below its panel's top score cannot, whatever its noise (see the source;
`noise_work` counts what given inputs need). Its noise takes four draws
from each Philox4x32-10 call: counter (row, k // 4, 0, 1), word j for
cluster 4 (k // 4) + j, its last word the kernel's own stream
(`ops/philox.py` LINEAR_STREAM), so `linear_philox_scores` checks the
kernel draw for draw. The Pallas kernel's tiling arguments and its padding
of K have no counterpart.

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
from common_tpu_torch.ops.philox import LINEAR_STREAM, gumbel_from_bits, philox4x32_10, philox_key
from common_tpu_torch.rng import gumbel_argmax

# A draw lies in [-2.78, 16.64] (u in [1e-7, 1 - 2^-24]): a cluster more than
# their spread, 19.42 nats, below another's score never wins. The kernel
# draws no noise for a cluster more than REACH (plus 1e-5 of the top score,
# for rounding) below the top score of its 32-cluster panel, and makes no
# Philox call for a group of four such clusters. The kernel's constant is
# `philox::kReach` in csrc/philox.cuh; a test holds both to the draw's range.
REACH = 19.5


def linear_scores(X: torch.Tensor, W: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """[N, K] table X @ W^T + base."""
    return X @ W.T + base


def noise_work(X, W, base) -> dict:
    """The noise these inputs need from the kernel, worked out from the
    scores by the kernel's rule: `calls`, the Philox calls a row (groups of
    four clusters holding a cluster within reach, at most ceil(K / 4)),
    `draws`, the Gumbel draws a row (clusters within reach, at most K), and
    `single`, the share of rows with a single cluster within reach of each
    32-cluster panel's top score, the rows for which the kernel draws the
    least."""
    s = linear_scores(X, W, base)
    n, k = s.shape
    s = torch.nn.functional.pad(s, (0, -(-k // 32) * 32 - k), value=-torch.inf).reshape(n, -1, 32)
    top = s.amax(-1, keepdim=True)
    near = s >= top - (REACH + 1e-5 * top.abs())
    draws = near.sum((1, 2))
    return {"calls": near.reshape(n, -1, 8, 4).any(-1).sum((1, 2)).double().mean().item(),
            "draws": draws.double().mean().item(),
            "single": (draws == near.shape[1]).double().mean().item()}


def linear_assign_plain(X, W, base, generator: torch.Generator) -> torch.Tensor:
    """Plain version: the score table, Gumbel noise from `generator`, argmax."""
    return gumbel_argmax(linear_scores(X, W, base), generator).to(torch.int32)


def linear_philox_gumbel(seed: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    """[len(rows), k] float32: the Gumbel noise the CUDA kernel adds, in plain ops.

    One Philox4x32-10 call keyed on (seed, 0x5EED) for each row and group
    of four clusters g, counter (row, g, 0, LINEAR_STREAM) (`csrc/philox.cuh`
    linear_words); its word j (x, y, z, w) gives cluster 4g + j, each word
    its own uniform from its top 24 bits, floored at 1e-7. The last group of a K that is not a multiple of 4 uses
    only its first words. `rows` are global row indices, so any slice of X
    can be checked draw for draw against the kernel.
    """
    groups = -(-k // 4)
    r = rows.to(torch.int64)[:, None].expand(-1, groups)
    g = torch.arange(groups, device=rows.device, dtype=torch.int64)[None, :].expand_as(r)
    zero = torch.zeros_like(r)
    words = philox4x32_10((r, g, zero, zero + LINEAR_STREAM), philox_key(seed))
    bits = torch.stack(words, dim=-1).reshape(r.shape[0], 4 * groups)[:, :k]
    return gumbel_from_bits(bits)


def linear_philox_scores(X, W, base, seed: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """[N, K] scores plus the kernel's own noise for rows row0 .. row0 + N - 1.

    Its argmax is the draw the CUDA kernel makes with `seed`, up to fp32
    rounding, so the kernel can be checked row for row.
    """
    rows = torch.arange(row0, row0 + X.shape[0], device=X.device)
    return linear_scores(X, W, base) + linear_philox_gumbel(seed, rows, W.shape[0])


def _check(X, W, base, seed) -> None:
    if X.dim() != 2 or W.dim() != 2 or base.dim() != 1:
        raise ValueError("expected X [N, D], W [K, D], base [K]")
    (N, D), (K, D_w) = X.shape, W.shape
    if D_w != D or base.shape[0] != K or K < 1:
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, W {tuple(W.shape)}, base {tuple(base.shape)}"
        )
    if seed.numel() != 1:
        raise ValueError(f"seed must hold one value, got shape {tuple(seed.shape)}")
    device = X.device
    if W.device != device or base.device != device or seed.device != device:
        for name, t in (("W", W), ("base", base), ("seed", seed)):
            if t.device != device:
                raise ValueError(f"X is on {device} but {name} is on {t.device}")


def fused_linear_assign(X: torch.Tensor, W: torch.Tensor, base: torch.Tensor,
                        seed: torch.Tensor) -> torch.Tensor:
    """Sample z_n ~ Cat(softmax_k(base_k + x_n . w_k)) for all rows.

    CUDA: float32 inputs and an int32 seed, contiguous; launches
    `csrc/linear_assign.cu`. CPU: `linear_assign_plain`, its noise drawn
    from a generator seeded with `seed`. Any other device raises.
    """
    # At config 2's shape the kernel runs for tens of microseconds, about as
    # long as this call takes on the host, and the sweep waits on the host:
    # so the checks test all at once before they name the culprit, the
    # launch sets X's device itself (no `torch.cuda.device` context), and the
    # stream is read as a raw handle (torch's own generated code does the
    # same) instead of through a `torch.cuda.Stream` object.
    _check(X, W, base, seed)
    device = X.device
    if device.type == "cpu":
        g = torch.Generator().manual_seed(int(seed.reshape(())))
        return linear_assign_plain(X, W, base, g)
    if device.type != "cuda":
        raise ValueError(f"fused_linear_assign: no kernel for device {device}")
    if not (X.dtype == W.dtype == base.dtype == torch.float32
            and X.is_contiguous() and W.is_contiguous() and base.is_contiguous()):
        for name, t in (("X", X), ("W", W), ("base", base)):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
    if seed.dtype != torch.int32:
        raise ValueError(f"seed must be int32, got {seed.dtype}")
    N, D = X.shape
    K = W.shape[0]
    z = torch.empty(N, device=device, dtype=torch.int32)
    if N == 0:
        return z
    index = device.index
    err = _build.library().linear_assign_launch(
        X.data_ptr(), W.data_ptr(), base.data_ptr(), seed.data_ptr(), z.data_ptr(),
        N, D, K, index, torch._C._cuda_getCurrentRawStream(index),
    )
    _build.check(err, "linear_assign_launch")
    fused_linear_assign.launches += 1
    return z


fused_linear_assign.launches = 0
