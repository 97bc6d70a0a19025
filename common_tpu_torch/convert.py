"""Carry a mixture state between the JAX package and the port as numpy leaves.

The leaves are a dict with the fields of `MixtureState` in both packages:

    {"assignments": [N] int32, "counts": [K] int32,
     "cluster_hp": {name: array}, "stats": ({name: array}, ...),
     "hypers": ({name: array}, ...), "lik_names": (str, ...), "fixed": bool}

A JAX state gives them with `np.asarray` on each of its arrays. Both
directions keep every array's dtype and values unchanged, so both packages
can score the same state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from common_tpu_torch.state import MixtureState


def _to_tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_from_numpy(leaves: Dict[str, Any], device="cuda") -> MixtureState:
    """The port's state from numpy leaves, with its tensors on `device` (the
    card unless the caller names another; without a card the default raises)."""
    def tensors(d):
        return {k: _to_tensor(v, device) for k, v in d.items()}

    return MixtureState(
        assignments=_to_tensor(leaves["assignments"], device),
        counts=_to_tensor(leaves["counts"], device),
        cluster_hp=tensors(leaves["cluster_hp"]),
        stats=tuple(tensors(s) for s in leaves["stats"]),
        hypers=tuple(tensors(h) for h in leaves["hypers"]),
        lik_names=tuple(leaves["lik_names"]),
        fixed=bool(leaves["fixed"]),
    )


def state_to_numpy(state: MixtureState) -> Dict[str, Any]:
    """The numpy leaves of a port state (the inverse of `state_from_numpy`)."""
    def arrays(d):
        return {k: _to_numpy(v) for k, v in d.items()}

    return {
        "assignments": _to_numpy(state.assignments),
        "counts": _to_numpy(state.counts),
        "cluster_hp": arrays(state.cluster_hp),
        "stats": tuple(arrays(s) for s in state.stats),
        "hypers": tuple(arrays(h) for h in state.hypers),
        "lik_names": tuple(state.lik_names),
        "fixed": bool(state.fixed),
    }
