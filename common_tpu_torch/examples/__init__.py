"""The JAX package's six `examples/*.py`, ported: one module each.

Each runs its example's recipe (the same numpy data and seed, sizes,
K_max, iteration counts and printed lines) on the card by default, or on
the device named by `main(device=...)` / `--device`:

    python -m common_tpu_torch.examples.dpmm [--device cpu] [--jsonl PATH]
    python -m common_tpu_torch.examples.binary_matrix
    python -m common_tpu_torch.examples.multichain_heldout
    python -m common_tpu_torch.examples.smc_evidence
    python -m common_tpu_torch.examples.lda_topics
    python -m common_tpu_torch.examples.irm_links

Without a card the default raises, as `rng.rng` does. Each `main` returns
the numbers it prints, as a dict.
"""
