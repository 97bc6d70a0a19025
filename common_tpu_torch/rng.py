"""Random-number handles: the PyTorch counterpart of `common_tpu/rng.py`.

The JAX package threads splittable `jax.random` keys through every kernel.
Here every sampling function takes an explicit `torch.Generator` on the
device of the tensors it draws for, and consumes it in order: no hidden
global generator is touched. The two frameworks give different numbers
from one seed, so tests compare distributions, or feed both packages the
same numpy inputs.
"""

from __future__ import annotations

import hashlib

import torch

from common_tpu_torch import validator
from common_tpu_torch.utils import profiling


class rng:
    """Seeded handle mirroring the reference's Python ``rng(seed)`` object.

    Holds one `torch.Generator` on `device`, the card unless the caller
    names another (`device="cpu"`); pass `.generator` to the samplers.
    Without a card the default raises, as `torch.Generator("cuda")` does.
    """

    __slots__ = ("generator", "seed")

    def __init__(self, seed: int = 0, device="cuda"):
        validator.validate_type(seed, int, "seed")
        self.seed = seed
        self.generator = torch.Generator(device=torch.device(device))
        self.generator.manual_seed(seed)

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def __repr__(self):
        return f"rng(seed={self.seed}, device={self.device})"


def uniform_open(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Uniform draws kept inside the open interval (0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)
    fi = torch.finfo(dtype)
    return u.clamp_(fi.tiny, 1.0 - fi.eps)


def gumbel(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in (0, 1)."""
    return -torch.log(-torch.log(uniform_open(shape, generator, dtype)))


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator, dim: int = -1) -> torch.Tensor:
    """Sample from a categorical given (possibly -inf masked) log-weights.

    Gumbel noise plus argmax, batched over every other axis; -inf logits
    are never selected. Ties go to the lowest index, as in `torch.argmax`.
    """
    g = gumbel(logits.shape, generator, logits.dtype)
    return torch.argmax(logits + g, dim=dim)


def gumbel_argmax_rows(logits: torch.Tensor, generator: torch.Generator, row0: int = 0,
                       n_total: int | None = None) -> torch.Tensor:
    """`gumbel_argmax` over the last axis of logits [n, K] that are rows
    row0 .. row0 + n - 1 of an [n_total, K] problem (n_total defaults to
    row0 + n): the noise is those rows of the [n_total, K] table a call over
    all rows draws, so a shard of rows draws what the whole call draws for
    them and leaves the generator where the whole call leaves it. At row0 = 0
    and n_total = n it is `gumbel_argmax` bit for bit. The plain version of
    the Gaussian assignment kernel draws its `row_offset` rows so; it costs
    O(n_total x K), so a sampler's data shard draws from `shard_generator`.
    """
    n, K = logits.shape
    n_total = row0 + n if n_total is None else n_total
    if row0 < 0 or row0 + n > n_total:
        raise ValueError(f"rows {row0}..{row0 + n} lie outside the {n_total} rows")
    g = gumbel((n_total, K), generator, logits.dtype)[row0:row0 + n]
    return torch.argmax(logits + g, dim=-1)


def device_seed(generator: torch.Generator, device) -> torch.Tensor:
    """A kernel launch's seed: one int32 drawn on the device from `generator`, never read by the host."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int32)


def shard_generator(generator: torch.Generator, shard: int) -> torch.Generator:
    """A new generator for shard `shard`'s own draws, derived from `generator`
    (the counterpart of JAX's `fold_in(key, shard)`).

    Its seed is a hash of `generator.get_state()` and `shard`, computed on
    the host: a card's generator keeps its seed and Philox offset there, so
    nothing is read from the device. `generator` then advances by one
    uniform draw, the same on every shard, so ranks that hold it seeded
    alike stay in step, and the next stream it derives is another. Shards
    of one state get distinct seeds, so their streams are independent.
    """
    if shard < 0:
        raise ValueError(f"shard must be >= 0, got {shard}")
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(shard).to_bytes(8, "little"), digest_size=8).digest()
    torch.rand(1, generator=generator, device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(int.from_bytes(digest, "little") >> 1)


def standard_gamma(shape_param: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gamma(shape_param, 1) draws, elementwise."""
    return torch._standard_gamma(shape_param, generator=generator)


def beta(a: torch.Tensor, b: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Beta(a, b) draws as G1 / (G1 + G2) from two Gamma draws."""
    g1 = standard_gamma(a, generator)
    g2 = standard_gamma(b, generator)
    return g1 / (g1 + g2)


def beta_open(a: torch.Tensor, b: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Beta(a, b) draws kept inside the open interval (0, 1) of their float type.

    A `beta` draw rounds to exactly 1 when b is small against a: at a = 0.5
    + n heads and b = 0.5, 2.5% of float32 draws at n = 12,500 and 20% at
    n = 10^6. log(1 - p) is then -inf, a Bernoulli score 0 * -inf = NaN,
    and an argmax takes the first NaN as its maximum, so every row would
    move into that slot. Each draw is clamped to [finfo.tiny, 1 - finfo.eps
    / 2] (in float32 the largest float below 1), so the state, a gathered
    block and a predictive draw all see p inside the support. The cost:
    log(1 - p) is capped at log(eps / 2), -16.6 in float32, where the exact
    draw lies closer to 1.
    """
    p = beta(a, b, generator)
    fi = torch.finfo(p.dtype)
    return p.clamp_(fi.tiny, 1.0 - fi.eps / 2)


def host_generator(generator: torch.Generator) -> torch.Generator:
    """A CPU generator seeded by one draw from `generator`.

    Samplers that pick rows (SMC's rejuvenation, subsample annealing) draw
    the row indices from it as Python ints: the entity ops take a row as
    an int, and a draw on the card would cost a device read a row. The
    seed is the one read (`read.rng.host_generator`).
    """
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    return torch.Generator().manual_seed(profiling.read(seed, "rng.host_generator"))
