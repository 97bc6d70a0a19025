"""Subsample annealing: collapsed Gibbs on a growing data subset (port of
`common_tpu/kernels/annealing.py`).

After "Scaling Nonparametric Bayesian Inference via Subsample-Annealing"
(arXiv 1402.5473): start the chain on a small prefix of the data and
anneal toward the full posterior by alternately adding unseen rows (seated
by their collapsed predictive scores) and resampling already-active rows.
Early steps mix on a small n, where collapsed Gibbs is cheap; by the end
the chain is exact collapsed Gibbs on the full data.

Each step runs exactly ``add_per_step + resample_per_step`` rows through
the row step of kernels/gibbs.py (a row with assignment -1 makes its
remove a no-op, so adding and resampling share one code path). Rows are
visited through a fixed random permutation so the active set is always a
prefix; resample targets are uniform over the active prefix.

The visit schedule is drawn on the host (`rng.host_generator`): the entity
ops take a row as a Python int. Each step's upper bound depends only on
the initial active count, so the run reads the device twice, both before
the first step: the host generator's seed and the initial assignment.
"""

from __future__ import annotations

import numpy as np
import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch import validator
from common_tpu_torch.kernels.gibbs import _float_dtype, _row_sweep_step
from common_tpu_torch.rng import gumbel, host_generator
from common_tpu_torch.state import MixtureState


def empty_state(defn, data, generator: torch.Generator, cluster_hp=None, feature_hps=None,
                fixed: bool = False) -> MixtureState:
    """A state with every row unassigned (the annealing start point)."""
    return state_mod.initialize(
        defn, data, generator, cluster_hp=cluster_hp, feature_hps=feature_hps,
        assignment=-np.ones(defn.n, np.int32), fixed=fixed,
    )


def linear_schedule(n: int, n_init: int = 0, add_per_step: int = 8,
                    resample_per_step: int = 8):
    """(n_steps, add, resample) covering all n rows with a linear ramp.

    Returns at least 1 step so a fully-assigned initial state (n_init >= n)
    degrades to one random-scan resample block instead of an invalid
    n_steps == 0 config.
    """
    remaining = max(n - n_init, 0)
    n_steps = max(-(-remaining // add_per_step), 1)
    return n_steps, add_per_step, resample_per_step


def run(
    state: MixtureState,
    data,
    generator: torch.Generator,
    n_steps: int,
    add_per_step: int = 8,
    resample_per_step: int = 8,
    m: int = 1,
) -> MixtureState:
    """Anneal from the current active prefix to the full dataset.

    state: rows assigned (>= 0) count as already active; typically from
      `empty_state` (n_init = 0) or an `initialize` over a prefix.
    n_steps * add_per_step must be >= the number of unassigned rows; once
      the prefix is exhausted, leftover add slots become uniform resamples
      over the active set.
    m: Neal-8 auxiliary slots for non-conjugate features.
    """
    validator.validate_positive(n_steps, "n_steps")
    validator.validate_positive(add_per_step, "add_per_step")
    validator.validate_nonnegative(resample_per_step, "resample_per_step")
    n = state.n
    host = host_generator(generator)

    # Fixed visit order with active rows first, so the active set is always a
    # prefix of `perm`; the stable sort keeps the permutation's order among
    # the unassigned rows.
    perm = torch.randperm(n, generator=host)
    active0 = state.assignments.cpu()[perm] >= 0
    perm = perm[torch.sort((~active0).to(torch.int8), stable=True).indices].tolist()
    n_active = int(active0.sum())

    st = state_mod.working_copy(state)
    block = add_per_step + resample_per_step
    for _ in range(n_steps):
        n_next = min(n_active + add_per_step, n)
        spill = torch.randint(0, n_next, (add_per_step,), generator=host).tolist()
        add_idx = [n_active + j if n_active + j < n else spill[j] for j in range(add_per_step)]
        ridx = torch.randint(0, n_next, (resample_per_step,), generator=host).tolist()
        noise = gumbel((block, st.k_max), generator, _float_dtype(st))
        for i, pos in enumerate(add_idx + ridx):
            _row_sweep_step(data, m, generator, st, perm[pos], noise[i])
        n_active = n_next
    return st
