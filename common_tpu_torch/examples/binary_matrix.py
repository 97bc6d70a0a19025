"""Clustering an [n, d] binary feature matrix (BASELINE config 2), by
blocked Gibbs with slice-sampled hypers (port of examples/binary_matrix.py).

The vector Beta-Bernoulli likelihood `bbv(d)` packs d scalar bb features
(per-column (alpha, beta) hypers) so the [N, K] score table is one
product; the hypers are slice-sampled coordinate by coordinate each sweep.

Run: python -m common_tpu_torch.examples.binary_matrix [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from common_tpu_torch import models, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked, slice_


def main(device="cuda", init_seed: int = 0, sweep_seed: int = 1) -> dict:
    """Runs the example; the generator seeds default to the JAX example's keys
    (`scripts/binary_matrix_seeds.py` runs others)."""
    init_gen, gen = rng(init_seed, device).generator, rng(sweep_seed, device).generator
    r = np.random.default_rng(0)
    n, d = 2000, 24
    probs = np.where(r.uniform(size=(4, d)) < 0.5, 0.1, 0.9)
    zt = r.integers(0, 4, n)
    X = (r.uniform(size=(n, d)) < probs[zt]).astype(np.float32)

    defn = st.model_definition(n, [models.bbv(d)], k_max=16)
    data = ((torch.from_numpy(X).to(device), torch.ones(n, device=device)),)
    s = st.initialize(defn, data, init_gen, cluster_hp={"alpha": 1.0})

    # with the uncollapsed blocked sweep, keep the slice bounds moderate
    # (>= 0.5): hyper draws fitted to mixed early-sweep stats otherwise make
    # empty-slot prior draws extreme and the sampler cannot seed clusters
    specs = {0: {
        "alpha": {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)},
        "beta": {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)},
    }}
    cluster = {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (1e-3, 1e3)}

    for _ in range(50):
        s = blocked.sweep(s, data, gen)
        s = slice_.hp(s, data, gen, specs, cluster=cluster)

    z = s.assignments.cpu().numpy()
    agree = float(((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).mean())
    clusters = int((s.counts > 0).sum())
    alpha = float(s.cluster_hp["alpha"])
    print(f"clusters found: {clusters} (truth: 4)")
    print(f"co-assignment agreement: {agree:.3f}")
    print(f"CRP alpha after slice:   {alpha:.2f}")
    return {"clusters": clusters, "agreement": agree, "alpha": alpha}


if __name__ == "__main__":
    from common_tpu_torch.examples._cli import parse

    main(**parse(__doc__))
