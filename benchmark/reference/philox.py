"""The assignment kernels' Gumbel noise, worked out again from its seed.

Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) in int64 tensor ops, keyed on (seed, 0x5EED). The uniform of
a 32-bit word is its top 24 bits over 2^24, floored at 1e-7, and the
Gumbel draw is -log(-log u), here in float64. Counters:

- the Gaussian assignment, one or C chains: (row, cluster, chain, 0), the
  first word;
- the linear assignment: (row, k // 4, 0, 1), word k % 4 for cluster k.

On the CPU the program's plain versions draw from a CPU `torch.Generator`
seeded with the kernel seed instead: `cpu_uniforms` gives that stream.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
KEY1 = 0x5EED
GAUSSIAN_STREAM = 0
LINEAR_STREAM = 1


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x, x an int64 tensor of uint32 values."""
    t = m * (x & 0xFFFF)
    u = m * (x >> 16)
    s = t + ((u & 0xFFFF) << 16)
    return (u >> 16) + (s >> 32), s & MASK32


def philox(ctr, seed: int):
    """The four output words of Philox4x32-10 for counters ctr (four int64 tensors)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = seed & MASK32, KEY1
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M[0], c0)
        hi1, lo1 = _mulhilo(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W[0]) & MASK32
        k1 = (k1 + _W[1]) & MASK32
    return c0, c1, c2, c3


def uniform_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """float64 uniforms from 32-bit words: the top 24 bits over 2^24, floored at 1e-7."""
    return ((bits >> 8).to(torch.float64) / 16777216.0).clamp_min(1e-7)


def gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.to(torch.float64)))


def gaussian_noise(seed: int, rows: torch.Tensor, k: int, chain: int = 0) -> torch.Tensor:
    """[len(rows), k] float64: the Gaussian kernels' noise for global `rows` of `chain`."""
    r = rows.to(torch.int64)[:, None].expand(-1, k)
    c = torch.arange(k, device=rows.device, dtype=torch.int64)[None, :].expand_as(r)
    zero = torch.zeros_like(r)
    word = philox((r, c, zero + chain, zero + GAUSSIAN_STREAM), seed)[0]
    return gumbel_of_uniform(uniform_of_bits(word))


def linear_noise(seed: int, rows: torch.Tensor, k: int) -> torch.Tensor:
    """[len(rows), k] float64: the linear kernel's noise for global `rows`."""
    groups = -(-k // 4)
    r = rows.to(torch.int64)[:, None].expand(-1, groups)
    g = torch.arange(groups, device=rows.device, dtype=torch.int64)[None, :].expand_as(r)
    zero = torch.zeros_like(r)
    words = torch.stack(philox((r, g, zero, zero + LINEAR_STREAM), seed), dim=-1)
    return gumbel_of_uniform(uniform_of_bits(words.reshape(r.shape[0], 4 * groups)[:, :k]))


def cpu_uniforms(seed: int, shape) -> torch.Tensor:
    """The uniforms a CPU generator seeded with `seed` draws for `shape`, in
    float32 and kept inside (0, 1), as the plain versions draw their noise."""
    g = torch.Generator().manual_seed(int(seed))
    fi = torch.finfo(torch.float32)
    return torch.rand(shape, generator=g, dtype=torch.float32).clamp_(fi.tiny, 1.0 - fi.eps)
