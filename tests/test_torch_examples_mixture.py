"""The port's versions of examples/dpmm.py, binary_matrix.py and
multichain_heldout.py (`common_tpu_torch/examples/`), run on the CPU at the
JAX examples' own recipes.

Each asserts what its JAX example shows, with the bar in its docstring. The
JAX examples printed, on the CPU: dpmm k_active 3, agreement 1.000;
binary_matrix 8 clusters (truth 4), agreement 0.980; multichain_heldout
split-R-hat 1.33, held-out -2.914 to -2.918 logp/row. They default
to the card and raise without one.
"""

import json

import numpy as np
import pytest
import torch

from common_tpu_torch.examples import binary_matrix, dpmm, multichain_heldout

torch.set_num_threads(2)


@pytest.mark.parametrize("example", [dpmm, binary_matrix, multichain_heldout])
def test_the_default_device_is_the_card(example):
    """With no card the default device raises, as `rng.rng` does; nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError):
        example.main()


def test_dpmm_recovers_the_three_clusters(tmp_path, monkeypatch):
    """600 rows of 3 planted 2-D Gaussians, 60 collapsed sweeps with the
    grid move on alpha: co-assignment agreement over the last 20 sweeps at
    least 0.95 (the JAX example: 1.000), 3 to 5 active clusters (JAX: 3),
    one JSON line a sweep in the given path and nothing written in the
    working directory, 5 finite posterior-predictive rows."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "out" / "sweeps.jsonl"
    path.parent.mkdir()
    res = dpmm.main("cpu", jsonl_path=str(path))
    assert res["agreement"] >= 0.95, res
    assert 3 <= res["k_active"] <= 5, res
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 60 and all(np.isfinite(x["score_joint"]) for x in lines)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert res["post_pred"].shape == (5, 2) and np.isfinite(res["post_pred"]).all()


def test_binary_matrix_recovers_the_planted_profiles():
    """2000 x 24 binary rows of 4 planted profiles, 50 blocked sweeps each
    with the slice moves on the bbv hypers and alpha: co-assignment
    agreement at least 0.95 (the JAX example: 0.980, with 8 clusters found,
    so the cluster count is no bar)."""
    res = binary_matrix.main("cpu")
    assert res["agreement"] >= 0.95, res
    assert res["clusters"] >= 1 and res["alpha"] > 0


def test_multichain_heldout_scores_every_chain():
    """4 chains of 4000 rows, 80 `sweep_chains` sweeps: each chain's
    held-out logp/row within 0.05 of -2.915 (the JAX example: -2.914 to
    -2.918), split-R-hat finite (the JAX example read 1.33, so no R-hat bar
    below 1.1), the score ESS positive."""
    res = multichain_heldout.main("cpu")
    assert all(abs(v + 2.915) <= 0.05 for v in res["heldout"]), res
    assert np.isfinite(res["rhat"]), res
    assert all(e > 0 for e in res["ess"]) and all(k >= 3 for k in res["k_active"]), res
