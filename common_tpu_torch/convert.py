"""Carry a mixture state between the JAX package and the port as numpy leaves.

The leaves are a dict with the fields of `MixtureState` in both packages:

    {"assignments": [N] int32, "counts": [K] int32,
     "cluster_hp": {name: array}, "stats": ({name: array}, ...),
     "hypers": ({name: array}, ...), "lik_names": (str, ...), "fixed": bool}

A JAX state gives them with `np.asarray` on each of its arrays. Both
directions keep every array's dtype and values unchanged, so both packages
can score the same state. A variational posterior (`kernels.svi.SVIPosterior`)
is carried the same way, with the fields of `SVIPosterior`:

    {"stick_a": [K-1], "stick_b": [K-1], "dir_conc": [K],
     "vstats": ({name: array}, ...), "hypers": ({name: array}, ...),
     "cluster_hp": {name: array}, "lik_names": (str, ...), "fixed": bool}

and so are the topic states, `topic.hdp.HDPState` and `topic.svi.LDAPosterior`,

    {"z": [T] int32, "beta": [K+1], "doc_topic": [D, K], "topic_word": [K, V],
     "topic_total": [K], "hypers": {"alpha": (), "gamma": (), "eta": ()}}
    {"lam": [K, V], "alpha": [K], "eta": ()}

and the IRM state, `relational.IRMState` (one entry a domain or a relation):

    {"assignments": ([N_d] int32, ...), "counts": ([K_d] int32, ...),
     "cluster_hps": ({"alpha": ()}, ...), "suffstats": ({name: [K_a, K_b, ...]}, ...),
     "hypers": ({name: array}, ...), "lik_names": (str, ...),
     "rel_domains": ((int, ...), ...)}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from common_tpu_torch.kernels.svi import SVIPosterior
from common_tpu_torch.relational.state import IRMState
from common_tpu_torch.state import MixtureState
from common_tpu_torch.topic.hdp import HDPState
from common_tpu_torch.topic.svi import LDAPosterior


def _to_tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tensors(v, device):
    """Numpy leaves (nested dicts and tuples) as tensors on `device`; names
    and flags (str, bool) stay as they are."""
    if isinstance(v, dict):
        return {k: _tensors(x, device) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_tensors(x, device) for x in v)
    return v if isinstance(v, (str, bool)) else _to_tensor(v, device)


def _arrays(v):
    """The inverse of `_tensors`: tensors as numpy arrays."""
    if isinstance(v, dict):
        return {k: _arrays(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_arrays(x) for x in v)
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def _from_numpy(cls, leaves: Dict[str, Any], device):
    fields = {f.name: _tensors(leaves[f.name], device) for f in dataclasses.fields(cls)}
    if "fixed" in fields:
        fields["fixed"] = bool(leaves["fixed"])
    if "rel_domains" in fields:
        fields["rel_domains"] = tuple(tuple(int(d) for d in doms) for doms in leaves["rel_domains"])
    return cls(**fields)


def _to_numpy(obj) -> Dict[str, Any]:
    return {f.name: _arrays(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def state_from_numpy(leaves: Dict[str, Any], device="cuda") -> MixtureState:
    """The port's state from numpy leaves, with its tensors on `device` (the
    card unless the caller names another; without a card the default raises)."""
    return _from_numpy(MixtureState, leaves, device)


def state_to_numpy(state: MixtureState) -> Dict[str, Any]:
    """The numpy leaves of a port state (the inverse of `state_from_numpy`)."""
    return _to_numpy(state)


def svi_from_numpy(leaves: Dict[str, Any], device="cuda") -> SVIPosterior:
    """The port's variational posterior from numpy leaves, on `device`."""
    return _from_numpy(SVIPosterior, leaves, device)


def svi_to_numpy(post: SVIPosterior) -> Dict[str, Any]:
    """The numpy leaves of a port posterior (the inverse of `svi_from_numpy`)."""
    return _to_numpy(post)


def hdp_from_numpy(leaves: Dict[str, Any], device="cuda") -> HDPState:
    """The port's HDP state from numpy leaves, on `device`."""
    return _from_numpy(HDPState, leaves, device)


def hdp_to_numpy(state: HDPState) -> Dict[str, Any]:
    """The numpy leaves of a port HDP state (the inverse of `hdp_from_numpy`)."""
    return _to_numpy(state)


def lda_from_numpy(leaves: Dict[str, Any], device="cuda") -> LDAPosterior:
    """The port's variational LDA posterior from numpy leaves, on `device`."""
    return _from_numpy(LDAPosterior, leaves, device)


def lda_to_numpy(post: LDAPosterior) -> Dict[str, Any]:
    """The numpy leaves of a port LDA posterior (the inverse of `lda_from_numpy`)."""
    return _to_numpy(post)


def irm_from_numpy(leaves: Dict[str, Any], device="cuda") -> IRMState:
    """The port's IRM state from numpy leaves, on `device`."""
    return _from_numpy(IRMState, leaves, device)


def irm_to_numpy(state: IRMState) -> Dict[str, Any]:
    """The numpy leaves of a port IRM state (the inverse of `irm_from_numpy`)."""
    return _to_numpy(state)
