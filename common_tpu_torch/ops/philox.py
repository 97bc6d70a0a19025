"""Philox4x32-10 in plain ops: the Python side of `csrc/philox.cuh`.

Every hand-written kernel that draws noise keys Philox4x32-10 on (seed,
0x5EED) and reads its draws from the counter words; the plain versions and
the tests repeat those draws here, word for word. Each kernel's counter
ends in its own stream word, listed below, so no two kernels' noise shares
a counter: a new kernel takes the next free word, adds its row to this
table and its helper to `philox.cuh`, and builds its plain noise on
`philox4x32_10` and `philox_key`.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# The last word of each kernel's Philox counter, with the layout it keys.
GAUSSIAN_STREAM = 0  # (row, cluster, chain, 0), first word: `philox::gumbel`, ops/gaussian_assign.py
LINEAR_STREAM = 1    # (row, k // 4, 0, 1), word k % 4: `philox::linear_words`, ops/linear_assign.py
SLICE_STREAM = 2     # (j // 4, 0, 0, 2), word j % 4: `philox::slice_words`, ops/slice_update.py
HDP_STREAM = 3       # (token, k // 4, token >> 32, 3), word k % 4: `philox::hdp_words`, ops/hdp_assign.py

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for int64 tensors of uint32 values.

    x is split into 16-bit halves so that no int64 product overflows.
    """
    t = m * (x & 0xFFFF)
    u = m * (x >> 16)
    s = t + ((u & 0xFFFF) << 16)
    return (u >> 16) + (s >> 32), s & MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 (`csrc/philox.cuh` philox4x32_10) in int64 tensor ops.

    ctr: four int64 tensors of uint32 values; key: two such tensors or ints.
    Returns the four output words.
    """
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & MASK32
        k1 = (k1 + _PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def philox_key(seed: torch.Tensor):
    """The kernels' Philox key (seed, 0x5EED), the seed as an int64 tensor
    (`csrc/philox.cuh`: `make_uint2(seed, 0x5EEDu)`)."""
    return seed.reshape(()).to(torch.int64) & MASK32, 0x5EED


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Float32 uniforms in (0, 1) from 32-bit words (`csrc/philox.cuh`
    uniform_open): the top 24 bits, floored at 1e-7."""
    return ((bits >> 8).to(torch.float32) * (1.0 / 16777216.0)).clamp_min(1e-7)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel draws from 32-bit words (`csrc/philox.cuh` gumbel_of_bits):
    -log(-log u) of `uniform_from_bits`."""
    return -torch.log(-torch.log(uniform_from_bits(bits)))
