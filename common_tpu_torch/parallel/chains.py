"""Chain-stacked states (port of `common_tpu/parallel/chains.py`).

The JAX package makes chains a `vmap` axis of the state pytree. Here a
chain-stacked `MixtureState` carries a leading axis C on every tensor
(assignments [C, N], counts [C, K], every stats and hyper leaf [C, ...]);
its `lik_names` and `fixed` are shared by all chains.

  stack_states([s1, s2, ...])  -> chain-stacked state (leading axis C)
  unstack_state(stacked, i)    -> chain i as an unstacked state
  vmap_sweep(sweep_fn)         -> (stacked, data, generator) -> stacked

Initialize each chain on its own (`state.initialize`), then stack.
"""

from __future__ import annotations

import dataclasses

import torch

from common_tpu_torch.state import MixtureState

_TENSOR_FIELDS = ("assignments", "counts", "cluster_hp", "stats", "hypers")


def _map(fn, parts):
    """fn over the tensors of one field of several states: a tensor, a dict or a tuple of dicts."""
    first = parts[0]
    if torch.is_tensor(first):
        return fn(parts)
    if isinstance(first, dict):
        return {k: fn([p[k] for p in parts]) for k in first}
    return tuple(_map(fn, [p[f] for p in parts]) for f in range(len(first)))


def stack_states(states) -> MixtureState:
    """List of identically shaped states -> one chain-stacked state."""
    if not states:
        raise ValueError("stack_states needs at least one state")
    first = states[0]
    for s in states[1:]:
        if s.lik_names != first.lik_names or s.fixed != first.fixed:
            raise ValueError("stack_states needs states of one model (lik_names, fixed)")
    fields = {f: _map(torch.stack, [getattr(s, f) for s in states]) for f in _TENSOR_FIELDS}
    return dataclasses.replace(first, **fields)


def unstack_state(stacked: MixtureState, i: int) -> MixtureState:
    """Chain i of a chain-stacked state."""
    fields = {f: _map(lambda ts: ts[0][i], [getattr(stacked, f)]) for f in _TENSOR_FIELDS}
    return dataclasses.replace(stacked, **fields)


def vmap_sweep(sweep_fn):
    """Lift sweep(state, data, generator) over a leading chain axis.

    The data is shared; the chains are swept in turn, each consuming the
    one generator in order.
    """
    def swept(stacked: MixtureState, data, generator):
        n_chains = stacked.counts.shape[0]
        return stack_states([
            sweep_fn(unstack_state(stacked, c), data, generator) for c in range(n_chains)
        ])

    return swept
