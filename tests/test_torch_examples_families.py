"""The port's versions of examples/smc_evidence.py, lda_topics.py and
irm_links.py (`common_tpu_torch/examples/`), run on the CPU at the JAX
examples' own recipes.

Each asserts what its JAX example shows, with the bar in its docstring. The
JAX examples printed, on the CPU: smc_evidence log Z -14680.1 at or above
its Gibbs bound -14742.9, 17 resamples, agreement 1.000, 3 clusters;
lda_topics HDP perplexity 29.9 -> 9.9, SVI 69.4 -> 14.7; irm_links 3
domains, link accuracy 1.000 of 147 cells. They default to the card
and raise without one.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from common_tpu_torch.examples import irm_links, lda_topics, smc_evidence

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("example", [smc_evidence, lda_topics, irm_links])
def test_the_default_device_is_the_card(example):
    """With no card the default device raises, as `rng.rng` does; nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError):
        example.main()


def test_smc_evidence_bounds_and_recovers():
    """5000 rows, 64 particles, blocks of 512: log Z finite and at or above
    the joint score of its own 30-sweep Gibbs chain (any z's joint bounds
    log Z), co-assignment agreement of one posterior sample at least 0.95
    (the JAX example: 1.000)."""
    res = smc_evidence.main("cpu")
    assert np.isfinite(res["logz"]) and res["logz"] >= res["bound"], res
    assert res["agreement"] >= 0.95, res
    assert res["n_resamples"] >= 0 and res["clusters"] >= 3, res


def test_lda_topics_perplexities_fall():
    """200 docs of 3 vocabulary blocks: the HDP runner's 50 sweeps and SVI's
    200 steps each bring perplexity below half its start (the JAX example:
    29.9 -> 9.9 and 69.4 -> 14.7)."""
    res = lda_topics.main("cpu")
    for start, end in (res["hdp_perplexity"], res["svi_perplexity"]):
        assert np.isfinite(end) and end < 0.5 * start, res
    assert res["topics"] >= 3 and res["alpha"] > 0, res


def test_irm_links_predicts_the_held_out_links():
    """A 30 x 30 self-relation in 3 planted blocks with 15% of cells held
    out, 25 collapsed sweeps with the Escobar-West alpha move: held-out link
    accuracy at least 0.95 (the bar of chip_smoke.py's phase 11 (b); the
    JAX example: 1.000 of 147 cells). Run as a user does, through
    `python -m ... --device cpu`."""
    out = subprocess.run([sys.executable, "-m", "common_tpu_torch.examples.irm_links", "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    acc = float(line.split("held-out link accuracy = ")[1].split()[0])
    assert acc >= 0.95 and "(147 cells)" in line, line
    assert irm_links.main("cpu")["accuracy"] == acc
