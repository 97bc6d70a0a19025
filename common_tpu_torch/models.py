"""User-facing model descriptors (port of `common_tpu/models.py`).

The reference's ``common:microscopes/models.py`` pairs a likelihood with
default hyperparameters and the runtime type of its data column. The port
carries the reference's zoo (``bb``, ``bbnc``, ``gp``, ``nich``, ``bnb``,
``niw(d)``, ``dd(n)``, ``dm(n)``) and ``bbv(d)``, with the JAX package's
defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from common_tpu_torch import likelihoods as _lik
from common_tpu_torch import runtime_types as rt
from common_tpu_torch import validator
from common_tpu_torch.likelihoods import base as _base


@dataclass(frozen=True)
class model_descriptor:
    """A likelihood + its default hyperparameters + its data-column schema."""

    likelihood: _base.Likelihood
    default_hyper: Dict[str, Any] = field(default_factory=dict)
    rtype: rt.runtime_type = rt.TYPE_F32

    @property
    def name(self) -> str:
        return self.likelihood.name

    def with_hyper(self, **hyper) -> "model_descriptor":
        merged = {**self.default_hyper, **hyper}
        return model_descriptor(self.likelihood, merged, self.rtype)

    def canonical_hyper(self, hyper: Dict[str, Any] | None = None,
                        dtype=torch.float32, device="cuda"):
        """Merge user hyper over defaults; tensors of `dtype` on `device`.

        `state.initialize` and `state.sample` pass the data's or the
        generator's device; called alone, the card, never the process
        default.
        """
        merged = {**self.default_hyper, **(hyper or {})}
        return self.likelihood.validate_hyper(merged, dtype=dtype, device=device)

    def __repr__(self):
        return f"<model {self.name} {self.rtype.dtype}{self.rtype.shape}>"


# --- the zoo (names and defaults as in common_tpu/models.py) ----------------

bb = model_descriptor(_lik.bb, {"alpha": 1.0, "beta": 1.0}, rt.TYPE_B)

bbnc = model_descriptor(_lik.bbnc, {"alpha": 1.0, "beta": 1.0}, rt.TYPE_B)

gp = model_descriptor(_lik.gp, {"alpha": 1.0, "inv_beta": 1.0}, rt.TYPE_I32)

nich = model_descriptor(
    _lik.nich, {"mu": 0.0, "kappa": 1.0, "sigmasq": 1.0, "nu": 1.0}, rt.TYPE_F32
)

bnb = model_descriptor(_lik.bnb, {"alpha": 1.0, "beta": 1.0, "r": 1.0}, rt.TYPE_I32)


def niw(dim: int) -> model_descriptor:
    """Normal-Inverse-Wishart over R^dim (multivariate Gaussian rows)."""
    validator.validate_positive(dim, "niw dim")
    hyper = {
        "mu0": np.zeros(dim, np.float32),
        "kappa": 1.0,
        "psi": np.eye(dim, dtype=np.float32),
        "nu": float(dim),
    }
    return model_descriptor(_lik.niw, hyper, rt.vector(rt.TYPE_F32, dim))


def bbv(d: int) -> model_descriptor:
    """d independent Beta-Bernoulli binary columns as one vector feature.

    The reference's "d scalar bb features" pattern (config-2 binary feature
    matrices): identical posterior, per-column (alpha, beta) hypers,
    scored by one product.
    """
    validator.validate_positive(d, "bbv columns")
    return model_descriptor(
        _lik.bbv,
        {"alpha": np.ones(d, np.float32), "beta": np.ones(d, np.float32)},
        rt.vector(rt.TYPE_B, d),
    )


def dd(n: int) -> model_descriptor:
    """Dirichlet-Discrete over n categories."""
    validator.validate_positive(n, "dd categories")
    return model_descriptor(_lik.dd, {"alphas": np.ones(n, np.float32)}, rt.TYPE_I32)


def dm(n: int) -> model_descriptor:
    """Dirichlet-Multinomial over n categories (rows are count vectors)."""
    validator.validate_positive(n, "dm categories")
    return model_descriptor(
        _lik.dm, {"alphas": np.ones(n, np.float32)}, rt.vector(rt.TYPE_I32, n)
    )
