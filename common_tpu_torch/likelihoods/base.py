"""Likelihood interface (port of `common_tpu/likelihoods/base.py`).

Reference analog: ``common:include/microscopes/models/base.hpp`` and the
`distributions` library's per-model ``Shared``/``Group`` structs. As in the
JAX package, a likelihood is a namespace of batched functions over suffstat
dicts whose leaves carry a leading cluster axis ``[K, ...]``:

  - ``tx(x, mask)``          one row's suffstat contribution
  - ``pred_logpdf``          posterior predictive log p(x | stats), all K
  - ``marginal_loglik``      log marginal likelihood of each cluster's data
  - ``sample_params`` /      explicit-parameter path of the blocked sampler
    ``logpdf_batch``

Conventions: ``stats`` is a dict of tensors with its own ``n`` leaf (rows
observed for this feature; masked cells do not count); ``hyper`` is a dict
of tensors; mask is 0.0/1.0. Every sampling method takes an explicit
`torch.Generator` on the device of its tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Stats = Dict[str, torch.Tensor]


def _as_tensor(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A hyper value as a tensor: floating values take `dtype`, others keep theirs."""
    t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
    return t.to(dtype) if t.is_floating_point() else t


class Likelihood:
    """Base class: a stateless namespace of batched functions, one per model."""

    name: str = "abstract"
    conjugate: bool = True
    # suffstat-dict keys that are explicit latents, not additive sums
    latent_leaves: tuple = ()

    # --- schema ---------------------------------------------------------
    def default_hyper(self) -> Dict[str, Any]:
        raise NotImplementedError

    def validate_hyper(self, hyper: Dict[str, Any], dtype=torch.float32,
                       device=None) -> Dict[str, torch.Tensor]:
        """Canonicalize a hyper dict to tensors on `device`; raise on missing keys.

        Floating values are cast to `dtype`, so the hypers (and the stats
        built from them) follow the data's precision.
        """
        ref = self.default_hyper()
        missing = set(ref) - set(hyper)
        if missing:
            raise ValueError(f"{self.name}: missing hyperparameters {sorted(missing)}")
        return {k: _as_tensor(hyper[k], dtype, device) for k in ref}

    def init_stats(self, hyper, batch_shape: Tuple[int, ...]) -> Stats:
        """Zero suffstats with leading batch shape (usually (K,))."""
        raise NotImplementedError

    # --- suffstats ------------------------------------------------------
    def tx(self, hyper, x, mask) -> Stats:
        """One row's suffstat contribution, scaled by mask (0 or 1)."""
        raise NotImplementedError

    def stats_from_assignments(self, hyper, X, mask, gid, K: int) -> Stats:
        """Per-cluster suffstats from scratch; rows with gid outside [0, K) drop."""
        raise NotImplementedError

    # --- collapsed scoring ---------------------------------------------
    def posterior_hyper(self, hyper, stats):
        """Conjugate posterior hyper given suffstats (broadcasts over batch)."""
        raise NotImplementedError

    def pred_logpdf(self, hyper, stats, x):
        """Posterior-predictive log p(x | stats); broadcasts over stats' batch."""
        raise NotImplementedError

    def predictive(self, hyper, stats):
        """The posterior predictive's factors, computed once for many rows."""
        raise NotImplementedError

    def predictive_logpdf(self, pred, X):
        """[M, *batch] predictive log density of rows X [M, ...] from `predictive`."""
        raise NotImplementedError

    def marginal_loglik(self, hyper, stats):
        """Log marginal likelihood of the data summarized in stats."""
        raise NotImplementedError

    # --- explicit-parameter path ---------------------------------------
    def sample_params(self, generator: torch.Generator, hyper, stats):
        """Draw theta ~ p(theta | stats) (posterior; prior when stats == 0)."""
        raise NotImplementedError

    def logpdf_batch(self, theta, X, mask):
        """[N, K] log-likelihood table for the blocked sampler."""
        raise NotImplementedError

    def __repr__(self):
        return f"<likelihood {self.name}>"


# ----------------------------------------------------------------------
# registry (the analog of the reference's models.py module-level zoo)
# ----------------------------------------------------------------------
_REGISTRY: Dict[str, Likelihood] = {}


def register(lik: Likelihood) -> Likelihood:
    _REGISTRY[lik.name] = lik
    return lik


def get(name: str) -> Likelihood:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown likelihood {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def names():
    return sorted(_REGISTRY)
