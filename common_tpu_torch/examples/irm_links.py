"""IRM link prediction: impute held-out cells of a block-structured graph
(port of examples/irm_links.py).

Run: python -m common_tpu_torch.examples.irm_links [--device cpu]
"""

from __future__ import annotations

import numpy as np

from common_tpu_torch import models, rng
from common_tpu_torch import relational as irm
from common_tpu_torch.data import sparse_ndarray_dataview
from common_tpu_torch.runner import runner


def main(device="cuda") -> dict:
    init_gen, run_gen = rng(0, device).generator, rng(1, device).generator
    n = 30
    r = np.random.default_rng(3)
    z_true = np.repeat(np.arange(3), n // 3)
    probs = np.where(z_true[:, None] == z_true[None, :], 0.9, 0.1)
    rel = (r.random((n, n)) < probs).astype(np.float32)
    missing = r.random((n, n)) < 0.15          # held out for prediction

    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=8)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, missing_mask=missing, device=device)])
    s = irm.initialize(defn, views, init_gen, cluster_hps=[{"alpha": 1.0}])

    out = runner(defn, views, s, [("assign", {}), ("ew_domain_alpha", {})]).run(run_gen, 25)

    held = np.argwhere(missing)
    p = irm.predict_missing(out, 0, held, (0.0, 1.0)).cpu().numpy()
    acc = float(((p[:, 1] > 0.5) == (probs[held[:, 0], held[:, 1]] > 0.5)).mean())
    domains = int(out.ngroups(0))
    print(f"domains found = {domains}  held-out link accuracy = {acc:.3f}  ({len(held)} cells)")
    return {"domains": domains, "accuracy": acc, "cells": len(held)}


if __name__ == "__main__":
    from common_tpu_torch.examples._cli import parse

    main(**parse(__doc__))
