"""Chain-stacked states (port of `common_tpu/parallel/chains.py`).

The JAX package makes chains a `vmap` axis of the state pytree. Here a
chain-stacked state carries a leading axis C on every tensor leaf of the
state dataclass, nested in tuples and dicts as they come (a `MixtureState`'s
assignments [C, N] and stats leaves [C, K, ...]; an `HDPState`'s z [C, T];
an `IRMState`'s per-domain assignments [C, N_d] and per-relation suffstats
[C, K_a, K_b, ...]). Every other value (`lik_names`, `fixed`,
`rel_domains`) is static: equal in every chain, and shared.

  stack_states([s1, s2, ...])  -> chain-stacked state (leading axis C)
  unstack_state(stacked, i)    -> chain i as an unstacked state
  vmap_sweep(sweep_fn)         -> (stacked, data, generator) -> stacked

Initialize each chain on its own, then stack.
"""

from __future__ import annotations

import dataclasses

import torch


def _stack(parts, path: str):
    """torch.stack over the tensor leaves of several values of one shape;
    any other leaf must be equal in all of them, and is kept."""
    first = parts[0]
    if torch.is_tensor(first):
        return torch.stack(parts)
    if isinstance(first, dict):
        if any(p.keys() != first.keys() for p in parts):
            raise ValueError(f"stack_states needs states of one model ({path} keys differ)")
        return {k: _stack([p[k] for p in parts], f"{path}.{k}") for k in first}
    if isinstance(first, (tuple, list)):
        if any(len(p) != len(first) for p in parts):
            raise ValueError(f"stack_states needs states of one model ({path} lengths differ)")
        return type(first)(_stack([p[i] for p in parts], f"{path}.{i}") for i in range(len(first)))
    if any(p != first for p in parts):
        raise ValueError(f"stack_states needs states of one model ({path} differs)")
    return first


def _map(fn, v):
    if torch.is_tensor(v):
        return fn(v)
    if isinstance(v, dict):
        return {k: _map(fn, x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_map(fn, x) for x in v)
    return v


def map_tensors(fn, state):
    """The state with fn applied to every tensor leaf; static values kept."""
    return dataclasses.replace(state, **{
        f.name: _map(fn, getattr(state, f.name)) for f in dataclasses.fields(state)})


def stack_states(states):
    """List of identically shaped states of one type -> one chain-stacked state."""
    if not states:
        raise ValueError("stack_states needs at least one state")
    first = states[0]
    if any(type(s) is not type(first) for s in states):
        raise ValueError("stack_states needs states of one model (types differ)")
    return dataclasses.replace(first, **{
        f.name: _stack([getattr(s, f.name) for s in states], f.name) for f in dataclasses.fields(first)})


def unstack_state(stacked, i: int):
    """Chain i of a chain-stacked state."""
    return map_tensors(lambda t: t[i], stacked)


def vmap_sweep(sweep_fn):
    """Lift sweep(state, data, generator) over a leading chain axis.

    The data is shared; the chains are swept in turn, each consuming the
    one generator in order.
    """
    def swept(stacked, data, generator):
        leaves = []
        _map(leaves.append, [getattr(stacked, f.name) for f in dataclasses.fields(stacked)])
        n_chains = leaves[0].shape[0]
        return stack_states([
            sweep_fn(unstack_state(stacked, c), data, generator) for c in range(n_chains)
        ])

    return swept
