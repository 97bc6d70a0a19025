"""Inference runner (port of `common_tpu/runner.py`, mixture family).

Reference analog: the `runner` layer of the reference ecosystem
(`kernels:microscopes/kernels/runner.py`): takes a model definition, a
dataview, an initialized latent state and a *kernel config* -- an ordered
list like ``[('assign_blocked_fused', {})]`` -- and applies each kernel once
per iteration. A mix such as
``[('assign_blocked_fused', {}), ('slice_hp', {'specs': ..., 'cluster': ...})]``
sweeps the rows, then slice-samples the hyperparameters.

The JAX package runs the loop as one `lax.scan`; here it is a Python loop.
The per-sweep traces (joint score, active-cluster count, counts and,
optionally, assignments) stay on the device until the end of `run`, so the
loop itself never waits on the device between sweeps (the slice sampler
does, inside `slice_hp`: see `kernels/slice_.py`).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch import validator
from common_tpu_torch.kernels import blocked, slice_
from common_tpu_torch.state import MixtureState


# kernel name -> fn(state, data, generator, **kw) -> state
KERNELS: Dict[str, Callable] = {
    "assign_blocked": blocked.sweep,
    "assign_blocked_fused": blocked.sweep_fused,
    "slice_hp": slice_.hp,  # kw: specs, cluster
}


def normalize_config(kernel_config: Sequence) -> Tuple[Tuple[str, dict], ...]:
    """Accept ['assign_blocked'] or [('assign_blocked', {...})] mixes."""
    out: List[Tuple[str, dict]] = []
    for entry in kernel_config:
        if isinstance(entry, str):
            name, kw = entry, {}
        else:
            name, kw = entry
        validator.validate_one_of(name, KERNELS, "kernel name")
        out.append((name, dict(kw)))
    return tuple(out)


def make_step(kernel_config: Sequence, data) -> Callable:
    """Compose a kernel config into one `step(state, generator) -> state`."""
    config = normalize_config(kernel_config)

    def step(state, generator):
        for name, kw in config:
            state = KERNELS[name](state, data, generator, **kw)
        return state

    return step


def _trace(state: MixtureState, collect_assignments: bool) -> Dict[str, torch.Tensor]:
    out = {
        "score": state_mod.score_joint(state),
        "k_active": (state.counts > 0).sum(),
        "counts": state.counts,
    }
    if collect_assignments:
        out["assignments"] = state.assignments
    return out


def _run_loop(state, generator, step, niters: int, collect_assignments: bool):
    traces = []
    for _ in range(niters):
        state = step(state, generator)
        traces.append(_trace(state, collect_assignments))
    stacked = {k: torch.stack([t[k] for t in traces]) for k in traces[0]}
    return state, stacked


class runner:
    """Reference-parity runner: r = runner(defn, data, state, config);
    r.run(generator, niters). Traces (assignments, joint score, active
    cluster count) are collected per sweep and exposed as host arrays.
    """

    def __init__(self, defn, data, state, kernel_config):
        if not isinstance(state, MixtureState):
            raise TypeError(f"no runner family for state type {type(state).__name__}")
        self._defn = defn
        self._data = data
        self._state = state
        self._config = normalize_config(kernel_config)
        self._step = make_step(self._config, data)
        self._assign_width = int(state.assignments.shape[0])
        self._assignment_trace = []
        self._score_trace = []
        self._k_active_trace = []

    def run(self, generator: torch.Generator, niters: int = 1, collect: bool = True):
        validator.validate_positive(niters, "niters")
        self._state, trace = _run_loop(
            self._state, generator, self._step, int(niters), collect
        )
        if collect:
            self._assignment_trace.append(trace["assignments"].cpu().numpy())
            self._score_trace.append(trace["score"].cpu().numpy())
            self._k_active_trace.append(trace["k_active"].cpu().numpy())
        self._warn_if_saturated()
        return self._state

    def _warn_if_saturated(self):
        if bool(state_mod.is_saturated(self._state)):
            warnings.warn(
                "all cluster slots are occupied: the sampler can no longer "
                "open new groups and the truncation may bias the posterior. "
                "Rebuild the state with a larger k_max.",
                RuntimeWarning,
                stacklevel=3,
            )

    def get_latent(self):
        return self._state

    @property
    def assignment_trace(self):
        return (
            np.concatenate(self._assignment_trace)
            if self._assignment_trace
            else np.zeros((0, self._assign_width), np.int32)
        )

    @property
    def score_trace(self):
        return np.concatenate(self._score_trace) if self._score_trace else np.zeros((0,))

    @property
    def k_active_trace(self):
        return (
            np.concatenate(self._k_active_trace)
            if self._k_active_trace
            else np.zeros((0,), np.int64)
        )


def run_chain(state, data, generator, niters, kernel_config, collect_assignments=True):
    """Functional one-shot: returns (final_state, trace dict of [T, ...] tensors)."""
    validator.validate_positive(niters, "niters")
    step = make_step(kernel_config, data)
    return _run_loop(state, generator, step, int(niters), collect_assignments)
