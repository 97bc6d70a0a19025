"""The cells' inputs, made on the device from `--seed`.

A configuration's `data` names a recipe and its parameters; the recipe
draws the rows with a `torch.Generator` on the device, in a few large
calls. The same seed gives the same rows on the same device.

- `gaussian_centres`: `n_true` centres, each N(0, scale^2 I), a uniform
  label a row, the row its centre plus N(0, I) noise (the recipe of the
  reference's `bench.py` mixture tiers), float32.
- `beta_profiles`: `n_true` profiles of D Bernoulli probabilities, each
  Beta(a, b), a uniform label a row, the row's columns drawn from its
  profile (the recipe of the reference's config 2), float32 zeros and ones.
"""

from __future__ import annotations

import numpy as np
import torch


def derive(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed and tags."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0] >> 1)


def generator(device: torch.device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def gaussian_centres(g: torch.Generator, n: int, d: int, n_true: int, scale: float) -> torch.Tensor:
    dev = g.device
    centres = scale * torch.randn((n_true, d), generator=g, device=dev)
    labels = torch.randint(0, n_true, (n,), generator=g, device=dev)
    x = torch.randn((n, d), generator=g, device=dev)
    return x.add_(centres[labels])


def beta_profiles(g: torch.Generator, n: int, d: int, n_true: int, a: float, b: float) -> torch.Tensor:
    dev = g.device
    ga = torch._standard_gamma(torch.full((n_true, d), a, device=dev), generator=g)
    gb = torch._standard_gamma(torch.full((n_true, d), b, device=dev), generator=g)
    probs = ga / (ga + gb)
    labels = torch.randint(0, n_true, (n,), generator=g, device=dev)
    u = torch.rand((n, d), generator=g, device=dev)
    return (u < probs[labels]).to(torch.float32)


RECIPES = {"gaussian_centres": gaussian_centres, "beta_profiles": beta_profiles}


def rows(config: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The configuration's [n, d] rows for `seed` on `device`."""
    spec = dict(config["data"])
    recipe = RECIPES[spec.pop("recipe")]
    return recipe(generator(device, seed, 0), config["n"], config["d"], **spec)
