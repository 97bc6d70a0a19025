"""Block-SMC: posterior and marginal likelihood of a DPMM in one pass
(port of examples/smc_evidence.py).

Config-5 shape (BASELINE.md): rows absorbed in blocks of B with particle
weights tracking the model evidence, O(N / B) device steps.

Run: python -m common_tpu_torch.examples.smc_evidence [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from common_tpu_torch import models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked, smc


def main(device="cuda") -> dict:
    part_gen, run_gen, post_gen, gibbs_init_gen, gibbs_gen = (
        rng(seed, device).generator for seed in (0, 1, 2, 9, 20))
    # synthetic 3-cluster Gaussian data
    r = np.random.default_rng(0)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    zt = r.integers(0, 3, 5000)
    X = (centers[zt] + r.normal(scale=0.6, size=(5000, 2))).astype(np.float32)

    defn = st.model_definition(5000, [models.niw(2)], k_max=16)
    data = ((torch.from_numpy(X).to(device), torch.ones(5000, device=device)),)

    # 64 particles, blocks of 512 rows -> 10 device steps
    parts = smc.init_particles(defn, data, part_gen, 64, cluster_hp={"alpha": 1.0})
    res = smc.run_blocked(parts, data, run_gen, block=512)
    logz, n_resamples = float(res.logz), int(res.n_resamples)
    print(f"log evidence estimate: {logz:.1f}")
    print(f"resampling events:     {n_resamples}")

    # sanity: log Z >= log p(z, data) for ANY z (the Gibbs joint-score bound)
    s_g = st.initialize(defn, data, gibbs_init_gen, cluster_hp={"alpha": 1.0})
    for _ in range(30):
        s_g = blocked.sweep(s_g, data, gibbs_gen)
    bound = float(st.score_joint(s_g))
    print(f"gibbs joint lower bound: {bound:.1f}  [{'OK' if logz >= bound else 'VIOLATED'}]")

    # one posterior partition sample ~ final particle weights
    s = smc.posterior_sample(post_gen, res)
    z = s.assignments.cpu().numpy()
    agree = float(((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).mean())
    clusters = int((s.counts > 0).sum())
    print(f"co-assignment agreement with truth: {agree:.3f}")
    print(f"clusters found: {clusters}")
    return {"logz": logz, "n_resamples": n_resamples, "bound": bound, "agreement": agree,
            "clusters": clusters}


# several cards: shard the particle axis over a mesh (collective resampling),
# one process a card (torchrun), P divisible by the ranks:
#   mesh = smc.make_particle_mesh("nccl")
#   parts, sdata = smc.shard_particles(mesh, parts, data)
#   res = smc.run_blocked_sharded(mesh, parts, sdata, run_gen, block=512)

if __name__ == "__main__":
    from common_tpu_torch.examples._cli import parse

    main(**parse(__doc__))
