"""Topic modelling two ways: HDP-LDA by blocked Gibbs with concentration
moves, and online variational LDA (port of examples/lda_topics.py).

Run: python -m common_tpu_torch.examples.lda_topics [--device cpu]
"""

from __future__ import annotations

import numpy as np

from common_tpu_torch import rng, topic
from common_tpu_torch.data import variadic_dataview
from common_tpu_torch.runner import runner


def main(device="cuda") -> dict:
    init_gen, run_gen, svi_init_gen, svi_gen = (rng(seed, device).generator for seed in (0, 1, 2, 3))
    r = np.random.default_rng(1)
    V, KB = 30, 3
    rows = [r.choice(np.arange((d % KB) * 10, (d % KB + 1) * 10), size=30) for d in range(200)]
    view = variadic_dataview(rows, device=device)
    data = topic.token_data(view)

    # HDP-LDA: blocked Gibbs + concentration resampling via the runner
    state = topic.initialize(view, 10, V, init_gen, eta=0.1)
    ppl0 = float(topic.perplexity(state, data))
    run = runner(None, data, state, [("assign_blocked", {}), ("concentrations", {})])
    out = run.run(run_gen, 50)
    ppl1 = float(topic.perplexity(out, data))
    topics, alpha = int(out.active_topics()), float(out.hypers["alpha"])
    print(f"HDP Gibbs:  perplexity {ppl0:.1f} -> {ppl1:.1f}  topics = {topics}  alpha = {alpha:.2f}")

    # online variational LDA (SVI) on the same corpus
    counts = topic.svi.doc_term_matrix(view, V)
    post = topic.svi.init(8, V, svi_init_gen, alpha=0.5, eta=0.1)
    p0 = float(topic.svi.perplexity(post, counts))
    post = topic.svi.fit_svi(post, counts, svi_gen, n_iters=200, batch_size=32)
    p1 = float(topic.svi.perplexity(post, counts))
    print(f"LDA SVI:    perplexity {p0:.1f} -> {p1:.1f}")
    return {"hdp_perplexity": (ppl0, ppl1), "topics": topics, "alpha": alpha, "svi_perplexity": (p0, p1)}


if __name__ == "__main__":
    from common_tpu_torch.examples._cli import parse

    main(**parse(__doc__))
