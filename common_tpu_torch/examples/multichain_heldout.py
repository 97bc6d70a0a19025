"""Multi-chain inference with convergence diagnostics and held-out scoring
(port of examples/multichain_heldout.py).

C independent blocked-Gibbs chains of a DPMM-NIW on one device, swept
together by `blocked.sweep_chains`; split-R-hat of the per-sweep held-out
predictive traces, the score ESS of each chain, and each chain's mean
posterior-predictive log-likelihood of held-out rows (`state.heldout_logp`,
the BASELINE quality metric).

Run: python -m common_tpu_torch.examples.multichain_heldout [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from common_tpu_torch import models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked
from common_tpu_torch.parallel import stack_states, unstack_state
from common_tpu_torch.utils import diagnostics


def main(device="cuda") -> dict:
    init_gen, gen = rng(0, device).generator, rng(1, device).generator
    C, n, n_held, d = 4, 4000, 500, 2
    r = np.random.default_rng(0)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    zt = r.integers(0, 3, n + n_held)
    X = torch.from_numpy((centers[zt] + r.normal(scale=0.6, size=(n + n_held, d))).astype(np.float32))
    x_fit, x_held = X[:n].to(device), X[n:].to(device)

    defn = st.model_definition(n, [models.niw(d)], k_max=16)
    data = ((x_fit, torch.ones(n, device=device)),)
    held = ((x_held, torch.ones(n_held, device=device)),)

    # C chains stacked on the leading axis
    states = stack_states([st.initialize(defn, data, init_gen, cluster_hp={"alpha": 1.0})
                           for _ in range(C)])
    scores, lps = [], []
    for _ in range(80):
        states = blocked.sweep_chains(states, data, gen)
        chains = [unstack_state(states, c) for c in range(C)]
        # the per-sweep held-out predictive per chain: the convergence summary
        # users care about (joint-score traces are sensitive to transient tiny
        # clusters and over-disperse R-hat)
        scores.append(torch.stack([st.score_joint(s) for s in chains]))
        lps.append(torch.stack([st.heldout_logp(s, held).mean() for s in chains]))
    scores = torch.stack(scores)[20:].double().cpu().numpy()   # [sweeps - 20, C]
    lp_trace = torch.stack(lps)[20:].double().cpu().numpy()

    rhat = float(diagnostics.split_rhat(lp_trace.T))
    print(f"split-R-hat of the held-out predictive traces: {rhat:.4f}")
    k_active, ess, heldout = [], [], []
    for c in range(C):
        ess.append(min(float(diagnostics.ess(scores[:, c] - scores[:, c].mean())), len(scores)))
        k_active.append(int((states.counts[c] > 0).sum()))
        heldout.append(float(lp_trace[-1, c]))
        print(f"chain {c}: K_active={k_active[c]}  score-ESS={ess[c]:.0f}"
              f"  held-out logp/row={heldout[c]:.3f}")
    return {"rhat": rhat, "k_active": k_active, "ess": ess, "heldout": heldout}


if __name__ == "__main__":
    from common_tpu_torch.examples._cli import parse

    main(**parse(__doc__))
