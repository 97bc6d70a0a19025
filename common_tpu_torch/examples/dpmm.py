"""Dirichlet-process mixture on synthetic 2-D Gaussians (BASELINE config 1),
by exact collapsed Gibbs with a grid move on the CRP concentration (port
of examples/dpmm.py).

Run: python -m common_tpu_torch.examples.dpmm [--device cpu] [--jsonl PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from common_tpu_torch import models, query, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.runner import runner


def main(device="cuda", jsonl_path=None) -> dict:
    """Runs the example; jsonl_path, if given, receives one JSON line per sweep."""
    init_gen, run_gen, pp_gen = (rng(seed, device).generator for seed in (42, 1, 2))
    r = np.random.default_rng(0)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    z_true = r.integers(0, 3, 600)
    X = (centers[z_true] + r.normal(scale=0.6, size=(600, 2))).astype(np.float32)

    defn = st.model_definition(600, [models.niw(2)], k_max=32)
    data = ((torch.from_numpy(X).to(device), torch.ones(600, device=device)),)
    s = st.initialize(defn, data, init_gen, cluster_hp={"alpha": 1.0})

    run = runner(defn, data, s, [
        ("assign", {}),                                # exact collapsed Gibbs
        ("grid_cluster_hp", {"prior": sf.log_exponential(1.0),
                             "grid": np.geomspace(0.1, 10, 30)}),
    ], jsonl_path=jsonl_path)
    out = run.run(run_gen, 60)

    co = query.zmatrix(run.assignment_trace[-20:]) > 0.5
    agree = float((co == (z_true[:, None] == z_true[None, :])).mean())
    k_active = int((out.counts > 0).sum())
    alpha = float(out.cluster_hp["alpha"])
    print(f"k_active = {k_active}  alpha = {alpha:.2f}  co-assignment agreement = {agree:.3f}")

    # posterior-predictive draws from the fitted model
    pp, _ = st.sample_post_pred(out, pp_gen, size=5)
    rows = pp[0][0].cpu().numpy()
    print("posterior-predictive rows:\n", rows.round(2))
    return {"k_active": k_active, "alpha": alpha, "agreement": agree, "post_pred": rows}


if __name__ == "__main__":
    from common_tpu_torch.examples._cli import parse

    main(**parse(__doc__, jsonl=True))
