"""Misc numeric helpers (port of `common_tpu/utils/util.py`; rebuild of
``common:microscopes/common/util.py``)."""

from __future__ import annotations

import numpy as np
import torch


def logsumexp(a, axis=None) -> torch.Tensor:
    """log sum exp over `axis`, or over every element when axis is None."""
    a = torch.as_tensor(a)
    return torch.logsumexp(a.reshape(-1), 0) if axis is None else torch.logsumexp(a, axis)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def almost_eq(a, b, rtol=1e-5, atol=1e-6) -> bool:
    return bool(np.allclose(_host(a), _host(b), rtol=rtol, atol=atol))


def random_orthonormal_matrix(generator: torch.Generator, n: int, dtype=torch.float32) -> torch.Tensor:
    """Haar-random orthonormal matrix via QR of a Gaussian, on the generator's device."""
    g = torch.randn((n, n), generator=generator, device=generator.device, dtype=dtype)
    q, r = torch.linalg.qr(g)
    # fix signs for uniqueness / Haar correctness
    return q * torch.sign(torch.diagonal(r))[None, :]


def random_assignment_vector(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """Uniform random int32 assignment of n entities into <= k groups."""
    return torch.randint(0, k, (n,), generator=generator, device=generator.device, dtype=torch.int32)
