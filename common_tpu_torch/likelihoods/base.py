"""Likelihood interface (port of `common_tpu/likelihoods/base.py`).

Reference analog: ``common:include/microscopes/models/base.hpp`` and the
`distributions` library's per-model ``Shared``/``Group`` structs. As in the
JAX package, a likelihood is a namespace of batched functions over suffstat
dicts whose leaves carry a leading cluster axis ``[K, ...]``:

  - ``tx(x, mask)``          one row's suffstat contribution
  - ``pred_logpdf``          posterior predictive log p(x | stats), all K
  - ``marginal_loglik``      log marginal likelihood of each cluster's data
  - ``sample_params`` /      explicit-parameter path of the blocked sampler
    ``logpdf_batch``         and of posterior draws
  - stats fold               ``stats + sign * tx`` into one cluster slot: the
                             collapsed sampler's add_value / remove_value
  - expfam methods           ``nat_params``, ``log_partition``,
                             ``suffstat_pair``, ``log_h``,
                             ``stats_from_weights``: the SVI path
                             (`likelihoods/expfam.py`, `kernels/svi.py`)

Conventions: ``stats`` is a dict of tensors with its own ``n`` leaf (rows
observed for this feature; masked cells do not count); ``hyper`` is a dict
of tensors; mask is 0.0/1.0. ``tx`` broadcasts over a leading row axis, so
one function serves a single row and a segment sum. Hypers may carry batch
axes that broadcast against the stats' (a grid of G hypers as [G, 1, ...]
against [K, ...] stats). Every sampling method takes an explicit
`torch.Generator` on the device of its tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from common_tpu_torch.utils import segment

Stats = Dict[str, torch.Tensor]


def _as_tensor(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A hyper value as a tensor: floating values take `dtype`, others keep theirs."""
    t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
    return t.to(dtype) if t.is_floating_point() else t


def _slot(gid, device) -> torch.Tensor:
    """Cluster slot `gid` (an int, a 0-d tensor or an [M] tensor of slots) as
    an [M] int64 index on `device` (M = 1 for an int or a 0-d tensor).

    A device tensor stays on the device, so the index never waits for it.
    """
    if torch.is_tensor(gid):
        return gid.reshape(-1).to(torch.int64)
    return torch.full((1,), int(gid), dtype=torch.int64, device=device)


def _per_slot(v, like: torch.Tensor):
    """A number, a 0-d tensor or an [M] tensor (one value a slot) shaped to
    broadcast against `like` [M, ...]."""
    if torch.is_tensor(v) and v.dim() == 1:
        return v.reshape(-1, *(1,) * (like.dim() - 1))
    return v


def fold(stats: Stats, tx: Stats, sign) -> Stats:
    """stats <- stats + sign * tx  (generic add_value/remove_value)."""
    return {k: s + sign * tx[k] for k, s in stats.items()}


def scatter_fold_(stats: Stats, gid, tx: Stats, sign) -> Stats:
    """Add sign * tx, one row's contribution, into cluster slot `gid`, in place.

    Leaves of `stats` have a leading slot axis [K, ...]; `gid` is an int, a
    0-d tensor, or an [M] tensor of distinct slots that each take the
    contribution (a particle stack's flattened [P * K] axis, one slot a
    particle). `sign` is a number, a 0-d tensor or [M]; tx's leaves
    broadcast to [M, ...].
    """
    for k, s in stats.items():
        idx = _slot(gid, s.device)
        src = _per_slot(sign, s) * tx[k].to(s.dtype)
        s.index_add_(0, idx, src.expand(idx.numel(), *s.shape[1:]))
    return stats


def zero_slot_(stats: Stats, gid, keep) -> Stats:
    """Multiply cluster slot `gid` by `keep` (0 clears it), in place; `gid`
    as in `scatter_fold_`, `keep` a number, a 0-d tensor or one value a slot.

    Kills float drift when a cluster empties: exact-sum suffstats
    accumulate rounding error across add/remove cycles, and clearing an
    emptied slot restores the empty-group invariant stats == 0 exactly (the
    reference deletes the group object: group_manager.hpp delete_group).
    """
    for s in stats.values():
        idx = _slot(gid, s.device)
        rows = s.index_select(0, idx)
        s.index_copy_(0, idx, rows * _per_slot(keep, rows))
    return stats


def scatter_fold(stats: Stats, gid, tx: Stats, sign) -> Stats:
    """`scatter_fold_` on a copy: the caller's stats stay unchanged."""
    return scatter_fold_({k: s.clone() for k, s in stats.items()}, gid, tx, sign)


def zero_slot(stats: Stats, gid, keep) -> Stats:
    """`zero_slot_` on a copy: the caller's stats stay unchanged."""
    return zero_slot_({k: s.clone() for k, s in stats.items()}, gid, keep)


class Likelihood:
    """Base class: a stateless namespace of batched functions, one per model."""

    name: str = "abstract"
    conjugate: bool = True
    # suffstat-dict keys that are explicit latents, not additive sums
    latent_leaves: tuple = ()
    # rows are scalars, and pred_logpdf broadcasts rows [M, 1, ...] against
    # the stats' batch axes
    scalar_rows: bool = False

    # --- schema ---------------------------------------------------------
    def default_hyper(self) -> Dict[str, Any]:
        raise NotImplementedError

    def validate_hyper(self, hyper: Dict[str, Any], dtype=torch.float32,
                       device="cuda") -> Dict[str, torch.Tensor]:
        """Canonicalize a hyper dict to tensors on `device`; raise on missing keys.

        Callers pass the data's or the state's device; the default is the
        card, never the process default.

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
        """Per-cluster suffstats from scratch; rows with gid outside [0, K) drop.

        Generic path: `tx` of all rows at once, then one order-fixed segment
        sum per leaf over one sort of the rows by cluster
        (`utils.segment`: no atomics, so a seed replays on the card too).
        Latent leaves are not sums: they keep `init_stats`' values. Override
        where the per-row suffstat is large (NIW's outer products).
        """
        clusters = segment.segments(gid, K)
        txs = self.tx(hyper, X, mask)
        zeros = self.init_stats(hyper, (K,))
        return {k: z if k in self.latent_leaves else clusters.sum(txs[k].to(z.dtype))
                for k, z in zeros.items()}

    # --- collapsed scoring ---------------------------------------------
    def posterior_hyper(self, hyper, stats):
        """Conjugate posterior hyper given suffstats (broadcasts over batch)."""
        raise NotImplementedError

    def pred_logpdf(self, hyper, stats, x):
        """Posterior-predictive log p(x | stats); broadcasts over stats' batch."""
        raise NotImplementedError

    def predictive(self, hyper, stats):
        """The posterior predictive's factors, computed once for many rows.

        Generic: the (hyper, stats) pair itself, which `predictive_logpdf`
        scores through `pred_logpdf`. niw and bbv factor theirs once.
        """
        return {"hyper": hyper, "stats": stats}

    def predictive_logpdf(self, pred, X):
        """[M, *batch] predictive log density of rows X [M, ...] from `predictive`.

        Generic: one `pred_logpdf` call for all M rows where the rows are
        scalars (`scalar_rows`: X lifted to [M, 1, ...] against the stats'
        batch axes), else one call a row (dd, dm).
        """
        hyper, stats = pred["hyper"], pred["stats"]
        if self.scalar_rows:
            return self.pred_logpdf(hyper, stats, X.reshape(-1, *(1,) * stats["n"].dim()))
        return torch.stack([self.pred_logpdf(hyper, stats, x) for x in X])

    def marginal_loglik(self, hyper, stats):
        """Log marginal likelihood of the data summarized in stats."""
        raise NotImplementedError

    # --- explicit-parameter path ---------------------------------------
    def sample_params(self, generator: torch.Generator, hyper, stats):
        """Draw theta ~ p(theta | stats) (posterior; prior when stats == 0)."""
        raise NotImplementedError

    def logpdf(self, theta, x):
        """log p(x | theta); broadcasts over theta's batch axes."""
        raise NotImplementedError

    def logpdf_batch(self, theta, X, mask):
        """[N, K] log-likelihood table for the blocked sampler."""
        raise NotImplementedError

    def sample_value(self, generator: torch.Generator, theta):
        """Draw x ~ p(x | theta), one value per entry of theta's batch axes."""
        raise NotImplementedError

    def prior_logpdf(self, hyper, theta):
        """log p(theta | hyper), for the non-conjugate kernels."""
        raise NotImplementedError

    # --- conjugate exponential-family structure (the SVI path) ----------
    # Where has_expfam is True the conjugate prior is an exponential family
    # over theta, p(theta | hyper) = exp(eta . T(theta) - A(eta)) h0(theta),
    # and log p(x | theta) = t(x) . T(theta) + log h(x), t(x) aligned leaf by
    # leaf with T. E_q[T] = grad A, so everything SVI needs follows from
    # autodiff of A (`likelihoods/expfam.py`). Every method broadcasts over
    # leading batch axes: rows [N] on the data side, clusters [K] on the
    # hyper side, so that E_q[T] of all K clusters is one gradient of sum_k A.
    has_expfam: bool = False

    def nat_params(self, hyper) -> Stats:
        """Natural parameters eta of the conjugate prior, a dict of tensors."""
        raise NotImplementedError

    def log_partition(self, nat):
        """A(eta), the conjugate prior's log-normalizer; differentiable,
        one value per entry of the leading batch axes."""
        raise NotImplementedError

    def suffstat_pair(self, hyper, x, mask) -> Stats:
        """t(x) * mask, aligned leaf by leaf with `nat_params`.

        `hyper` gives shapes only (dd's category count) and the float type.
        """
        raise NotImplementedError

    def log_h(self, hyper, x, mask):
        """log base measure of the likelihood at x, times the mask."""
        raise NotImplementedError

    def stats_from_weights(self, hyper, X, mask, r) -> Stats:
        """Soft-weighted suffstats [K, ...] = sum_n r[n, k] tx(x_n): the SVI
        M-step's `stats_from_assignments`.

        Default: `tx` of all rows at once, then one product per leaf,
        r^T [K, N] @ tx [N, S]. NIW overrides it, since its per-row
        suffstat is an outer product.
        """
        txs = self.tx(hyper, X, mask)
        out = {}
        for k, t in txs.items():
            flat = t.reshape(t.shape[0], -1)
            out[k] = (r.to(flat.dtype).T @ flat).reshape(r.shape[1], *t.shape[1:])
        return out

    # --- slice sampling of the hypers ------------------------------------
    def hyper_target(self, pname: str, hyper, stats, counts, prior):
        """The `ops.slice_update.HyperTarget` of hyper `pname` [d] under
        `prior`, at column 0 (`kernels/slice_.py` `hp` updates column c on
        the card through `target.column(c)`), or None: `hp` then scores
        the hyper by `marginal_loglik` in its host loop. None here."""
        del pname, hyper, stats, counts, prior
        return None

    def refresh_latents(self, generator: torch.Generator, hyper, stats, refresh_mask):
        """Redraw any explicit latents inside `stats` where refresh_mask is set.

        The identity for conjugate models, which have no explicit latents.
        Non-conjugate models (bbnc) override it: Neal-8 aux slots and birth
        candidates need fresh prior draws before they can be scored.
        """
        del generator, hyper, refresh_mask
        return stats

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
