"""One slice-sampling update of one hyperparameter coordinate, on the card.

`slice_update` runs Neal's (2003) update of one coordinate against its own
target, the placement of the interval, the step-out and the shrinkage, in
one launch of `csrc/slice_update.cu`: the host neither tests the loop nor
launches the target's evaluations. It replaces no TPU kernel (the JAX
package runs the loop as a `lax.while_loop`); `kernels/slice_.py`
`slice_sample` takes it when its target is a `HyperTarget`.

A `HyperTarget` is the part of a coordinate's log target that moves with
it, in float64:

- a bbv column's Beta hyper (`KIND_ALPHA`, `KIND_BETA`): log Exp(v | rate)
  plus, over the slots that hold rows, lbeta(a + h_kc, b + n_k - h_kc) -
  lbeta(a, b), the column's other hyper fixed;
- the CRP concentration (`KIND_CRP`): log Exp(v | rate) + K+ log v +
  lgamma(v) - lgamma(v + N).

The terms it leaves out (the other columns, the partition's lgamma(n_k))
are the same at every point, so no test of the update changes. Outside v >
0 it is -inf. It reads the state's tensors in place and is callable, so
the host loop can evaluate it too.

The level's uniform comes in as a device tensor; the interval's placement
(draw 0) and the shrink proposals (draw j) are Philox4x32-10 uniforms
keyed on (seed, 0x5EED) with counter (j // 4, 0, 0, SLICE_STREAM), word
j % 4 (`csrc/philox.cuh` slice_words; the stream words of all the kernels
are listed in `ops/philox.py`). The interval and the proposals are
float32, each operation rounded on its own, so `slice_update_plain`, the
plain version, repeats the kernel's points bit for bit and its float64
sums in the kernel's order (one slot a lane, an xor butterfly). It is the
CPU route; its tests are host reads, recorded as the host loop's are.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import torch

from common_tpu_torch.ops import _build
from common_tpu_torch.ops.philox import SLICE_STREAM, philox4x32_10, philox_key, uniform_from_bits
from common_tpu_torch.utils import profiling

KIND_ALPHA, KIND_BETA, KIND_CRP = 0, 1, 2
_LANES = 32
_DTYPES = {"x0": torch.float32, "level": torch.float32, "seed": torch.int32, "counts": torch.int32,
           "other": torch.float32, "n": torch.float32, "heads": torch.float32}


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _lane_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order: slot k to lane k % 32,
    each lane's slots in turn, then an xor butterfly across the lanes."""
    k = terms.shape[-1]
    t = torch.nn.functional.pad(terms, (0, -k % _LANES)).unflatten(-1, (-1, _LANES))
    acc = t[..., 0, :]
    for i in range(1, t.shape[-2]):
        acc = acc + t[..., i, :]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


@dataclasses.dataclass(frozen=True)
class HyperTarget:
    """The log target of one hyper coordinate under an Exp(rate) prior.

    kind: KIND_ALPHA or KIND_BETA (a bbv column c: `other` [D] the column
    hypers of the other kind, `n` [K], `heads` [K, D] float32) or KIND_CRP
    (the concentration); `counts` [K] int32 in both, every tensor
    contiguous and on one device. The tensors are checked once, here;
    `column` moves a checked target to another column.
    """

    kind: int
    rate: float
    counts: torch.Tensor
    c: int = 0
    other: Optional[torch.Tensor] = None
    n: Optional[torch.Tensor] = None
    heads: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.kind not in (KIND_ALPHA, KIND_BETA, KIND_CRP):
            raise ValueError(f"HyperTarget: unknown kind {self.kind}")
        dev = self.counts.device
        tensors = {"counts": self.counts}
        if self.kind != KIND_CRP:
            tensors.update(other=self.other, n=self.n, heads=self.heads)
        for name, t in tensors.items():
            if t is None or t.device != dev or t.dtype != _DTYPES[name] or not t.is_contiguous():
                raise ValueError(f"HyperTarget: {name} must be a contiguous {_DTYPES[name]} tensor on {dev}")
        K = self.counts.shape[0] if self.counts.dim() == 1 else 0
        if K < 1:
            raise ValueError(f"HyperTarget: counts must be [K], K >= 1, got {tuple(self.counts.shape)}")
        if self.kind != KIND_CRP:
            D = self.other.shape[-1]
            if self.other.dim() != 1 or self.n.shape != (K,) or self.heads.shape != (K, D):
                raise ValueError(f"HyperTarget: other {tuple(self.other.shape)}, n {tuple(self.n.shape)}, "
                                 f"heads {tuple(self.heads.shape)} for {K} slots")
            self._check_column(self.c)

    def _check_column(self, c: int) -> None:
        if not 0 <= c < self.other.shape[0]:
            raise ValueError(f"HyperTarget: column {c} of {self.other.shape[0]}")

    def column(self, c: int) -> "HyperTarget":
        """This target at column c of the same tensors, not checked again."""
        self._check_column(c)
        out = copy.copy(self)
        object.__setattr__(out, "c", c)
        return out

    def __call__(self, v) -> torch.Tensor:
        """float64 log target at each entry of v."""
        dev = self.counts.device
        v = torch.as_tensor(v, device=dev).to(torch.float64)
        rate = torch.tensor(self.rate, dtype=torch.float64, device=dev)
        prior = torch.log(rate) - rate * v
        if self.kind == KIND_CRP:
            kplus = (self.counts > 0).sum().to(torch.float64)
            total = self.counts.to(torch.float64).sum()
            f = prior + ((kplus * torch.log(v) + torch.lgamma(v)) - torch.lgamma(v + total))
        else:
            other = self.other[self.c].to(torch.float64)
            a, b = (v, other) if self.kind == KIND_ALPHA else (other, v)
            a, b = a[..., None], b[..., None]
            h = self.heads[:, self.c].to(torch.float64)
            tails = self.n.to(torch.float64) - h
            terms = _lbeta(a + h, b + tails) - _lbeta(a, b)
            f = prior + _lane_sum(torch.where(self.counts > 0, terms, torch.zeros_like(terms)))
        return torch.where(v > 0, f, torch.full_like(f, -math.inf))


def exponential_rate(prior, x0: torch.Tensor) -> Optional[float]:
    """The rate of `prior` where a `HyperTarget` can score the coordinate x0:
    a `scalar_functions.log_exponential` prior (it carries `exponential_rate`)
    and a float32 x0. None for any other prior or dtype (the host loop)."""
    rate = getattr(prior, "exponential_rate", None)
    return rate if x0.dtype == torch.float32 else None


def slice_draws(seed: torch.Tensor, count: int) -> torch.Tensor:
    """[count] float32: the kernel's uniforms 0 .. count - 1 for `seed`."""
    groups = torch.arange(-(-count // 4), device=seed.device, dtype=torch.int64)
    zero = torch.zeros_like(groups)
    words = philox4x32_10((groups, zero, zero, zero + SLICE_STREAM), philox_key(seed))
    return uniform_from_bits(torch.stack(words, dim=-1).reshape(-1)[:count])


def slice_update_plain(x0, level, seed, target: HyperTarget, w: float, lower: float, upper: float,
                       max_stepout: int, max_shrink: int) -> torch.Tensor:
    """Plain version, on x0's device: the kernel's update step by step, each
    test a host `if`. The tests are the host loop's reads,
    `read.slice.step_out` and `read.slice.shrink`, and each evaluation of
    the target counts `slice.evals` (`utils.profiling`). Returns x1, a new
    0-d float32 tensor."""
    def f(v):
        profiling.count("slice.evals")
        return target(v)

    x0 = x0.reshape(()).to(torch.float32)
    u = slice_draws(seed, 1 + max_shrink)
    y = f(x0) + torch.log(level.reshape(()).to(torch.float64))
    lo = torch.clamp(x0 - u[0] * w, min=lower)
    hi = torch.clamp(lo + w, max=upper)

    def step_out(edge, step):
        grow = profiling.read(f(edge) > y, "slice.step_out")
        for _ in range(max_stepout):
            if not grow:
                break
            # an edge held by its bound stops the side (the kernel stops
            # before evaluating there; the value is not used either way)
            nxt = torch.clamp(edge + step, lower, upper)
            grow = profiling.read((nxt != edge) & (f(nxt) > y), "slice.step_out")
            edge = nxt
        return edge

    lo, hi = step_out(lo, -w), step_out(hi, w)
    for j in range(1, max_shrink + 1):
        xp = lo + u[j] * (hi - lo)
        if profiling.read(f(xp) >= y, "slice.shrink"):
            return xp
        left = xp < x0
        lo, hi = torch.where(left, xp, lo), torch.where(left, hi, xp)
    return x0.clone()


def _check(x0, level, seed, target: HyperTarget) -> None:
    """The update's own inputs; the target's tensors were checked when it was built."""
    for name, t in (("x0", x0), ("level", level), ("seed", seed)):
        if t.device != target.counts.device or t.dtype != _DTYPES[name] or t.numel() != 1:
            raise ValueError(f"slice_update: {name} must hold one {_DTYPES[name]} value on {target.counts.device}")


def slice_update(x0: torch.Tensor, level: torch.Tensor, seed: torch.Tensor, target: HyperTarget, w: float,
                 lower: float, upper: float, max_stepout: int, max_shrink: int) -> torch.Tensor:
    """One slice update of the coordinate x0 (one value) under `target`.

    level: the level's uniform (one value); seed: [1]. At most max_stepout
    steps of width w a side, clipped to [lower, upper], then at most
    max_shrink proposals, after which x0 stays. float32 x0 and level, int32
    seed, on the target's device. Returns x1, a new 0-d float32 tensor.
    CUDA: one launch of `csrc/slice_update.cu`, nothing read on the host;
    CPU: `slice_update_plain`, its tests the host loop's reads. Any other
    device raises.
    """
    _check(x0, level, seed, target)
    dev = x0.device
    if dev.type == "cpu":
        return slice_update_plain(x0, level, seed, target, w, lower, upper, max_stepout, max_shrink)
    if dev.type != "cuda":
        raise ValueError(f"slice_update: no kernel for device {dev}")
    out = torch.empty((), device=dev, dtype=torch.float32)
    other = n = heads = None
    D = 0
    if target.kind != KIND_CRP:
        other, n, heads = target.other.data_ptr(), target.n.data_ptr(), target.heads.data_ptr()
        D = target.heads.shape[1]
    index = dev.index
    err = _build.library().slice_update_launch(
        x0.data_ptr(), out.data_ptr(), level.data_ptr(), seed.data_ptr(), other, n, heads,
        target.counts.data_ptr(), target.kind, target.c, target.counts.shape[0], D, target.rate, w, lower, upper,
        max_stepout, max_shrink, index, torch._C._cuda_getCurrentRawStream(index),
    )
    _build.check(err, "slice_update_launch")
    slice_update.launches += 1
    return out


slice_update.launches = 0
