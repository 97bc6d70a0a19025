"""The linear assignment kernel's Gumbel noise in plain ops.

`csrc/linear_assign.cu` takes four Gumbel numbers from each Philox4x32-10
call (`philox::linear_words`): counter (row, g, 0, 1), word j for cluster
4g + j. `ops/linear_assign.py:linear_philox_gumbel` is that noise in int64
tensor ops, and the card checks hold the kernel draw for draw against it
(`tests/test_torch_cuda.py`, `chip_smoke.py`). Here it is held against a
Philox4x32-10 written with Python integers, to its layout, to its
independence of the tiling and of K, to a stream apart from the Gaussian
kernels', and to the standard Gumbel law.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats as sps

from common_tpu_torch.ops import gaussian_assign as ga
from common_tpu_torch.ops import linear_assign as la
from common_tpu_torch.ops import philox

MASK = 0xFFFFFFFF
SEED = 5


def _philox(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11) on Python integers."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & MASK, p1 & MASK, ((p0 >> 32) ^ c3 ^ k1) & MASK, p0 & MASK
        k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
    return c0, c1, c2, c3


def _gumbel(bits):
    """-log(-log u) in float32, u from the top 24 bits floored at 1e-7."""
    u = max(np.float32(bits >> 8) * np.float32(1.0 / 16777216.0), np.float32(1e-7))
    return float(-np.log(-np.log(np.float32(u))))


def _seed(value=SEED):
    return torch.tensor([value], dtype=torch.int32)


def test_the_python_reference_is_philox():
    assert _philox((0, 0, 0, 0), (0, 0)) == (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)


@pytest.mark.parametrize("k", [4, 33, 70])
def test_word_j_of_the_call_for_row_and_group_is_cluster_4g_plus_j(k):
    """Every draw of the table against the Python-integer Philox with
    counter (row, g, 0, 1): K = 33 and 70 end on a group cut short."""
    rows = [0, 1, 7, 12345, 2**31 - 1]
    table = la.linear_philox_gumbel(_seed(), torch.tensor(rows), k)
    assert table.shape == (len(rows), k) and table.dtype == torch.float32
    want = np.empty((len(rows), k))
    for i, row in enumerate(rows):
        for g in range(-(-k // 4)):
            words = _philox((row, g, 0, 1), (SEED, 0x5EED))
            for j in range(min(4, k - 4 * g)):
                want[i, 4 * g + j] = _gumbel(words[j])
    np.testing.assert_allclose(table.numpy(), want, rtol=1e-6, atol=1e-6)


def test_the_noise_does_not_depend_on_the_tiling_or_on_k():
    """A slice of rows draws what the full table holds for them, and a
    smaller K the first columns of a larger one."""
    full = la.linear_philox_gumbel(_seed(), torch.arange(4000), 70)
    part = la.linear_philox_gumbel(_seed(), torch.arange(1000, 1100), 70)
    assert torch.equal(part, full[1000:1100])
    assert torch.equal(la.linear_philox_gumbel(_seed(), torch.arange(4000), 33), full[:, :33])
    assert not torch.equal(full, la.linear_philox_gumbel(_seed(SEED + 1), torch.arange(4000), 70))
    scores = la.linear_philox_scores(torch.zeros(100, 3), torch.zeros(70, 3), torch.zeros(70), _seed(), row0=1000)
    assert torch.equal(scores, part)


def test_the_stream_differs_from_the_gaussian_kernels():
    """Counter word 3 is 1 here and 0 for the Gaussian kernels: at the same
    (row, k) the draws differ and are uncorrelated."""
    rows = torch.arange(4000)
    lin = la.linear_philox_gumbel(_seed(), rows, 8)
    gau = ga.philox_gumbel(_seed(), rows, 8)
    assert (lin != gau).double().mean().item() > 0.999
    assert abs(np.corrcoef(lin.flatten().numpy(), gau.flatten().numpy())[0, 1]) < 0.03


@pytest.mark.parametrize("word", [0, 1, 2, 3, None])
def test_the_draws_are_standard_gumbel(word):
    """4 x 4000 draws, each word alone and all four together, pass a
    Kolmogorov-Smirnov test against the standard Gumbel; the four words of
    a call are uncorrelated; every draw is finite below -log(-log(1 - 2^-24))."""
    draws = la.linear_philox_gumbel(_seed(), torch.arange(4000), 4).numpy().astype(np.float64)
    sample = draws.flatten() if word is None else draws[:, word]
    assert sps.kstest(sample, "gumbel_r").pvalue > 0.01
    assert np.isfinite(draws).all() and draws.max() < 16.7
    corr = np.corrcoef(draws.T)
    assert np.abs(corr - np.eye(4)).max() < 0.05


def test_noise_work_counts_the_clusters_within_reach():
    """The first panel's top is cluster 1; cluster 3 lies 19 nats below it
    (within reach, in the same group), clusters 2 and 5 20 and 30 below. The
    second panel (clusters 32-39) has its own top, 33, with 38 in reach in
    another group: 3 calls and 4 draws a row. Equal scores need them all."""
    K = 40
    base = torch.full((K,), -100.0)
    base[1], base[3], base[2], base[5] = 0.0, -19.0, -20.0, -30.0
    base[33], base[38] = 5.0, 4.0
    X, W = torch.zeros(2, 1), torch.zeros(K, 1)
    assert la.noise_work(X, W, base) == {"calls": 3.0, "draws": 4.0, "single": 0.0}
    assert la.noise_work(X, W, torch.zeros(K)) == {"calls": 10.0, "draws": 40.0, "single": 0.0}
    alone = torch.full((K,), -100.0)
    alone[1], alone[33] = 0.0, 0.0
    assert la.noise_work(X, W, alone) == {"calls": 2.0, "draws": 2.0, "single": 1.0}


def test_reach_covers_the_spread_of_a_draw():
    """The kernel draws no noise for a cluster more than REACH below its
    panel's top score: that is exact only while REACH exceeds the spread of
    a draw (u from 1e-7 to 1 - 2^-24, the extremes of the bits), and the
    kernel's constant in csrc/philox.cuh is the same number."""
    lo, hi = philox.gumbel_from_bits(torch.tensor([0, MASK], dtype=torch.int64)).tolist()
    assert (lo, hi) == (_gumbel(0), _gumbel(MASK))
    assert la.REACH > hi - lo + 0.05
    csrc = Path(la.__file__).resolve().parent.parent / "csrc"
    reach = re.findall(r"constexpr float kReach = ([0-9.]+)f;", (csrc / "philox.cuh").read_text())
    assert [float(r) for r in reach] == [la.REACH]
    assert "philox::kReach" in (csrc / "linear_assign.cu").read_text()


@pytest.mark.parametrize("bad", ["x_rank", "w_width", "base_length", "no_clusters", "seed_size",
                                 "w_device"])
def test_the_wrapper_refuses_bad_inputs(bad):
    """Each shape or device fault is named before anything runs."""
    X, W, base, seed = torch.zeros(6, 3), torch.zeros(4, 3), torch.zeros(4), _seed()
    if bad == "x_rank":
        X = torch.zeros(6)
    elif bad == "w_width":
        W = torch.zeros(4, 2)
    elif bad == "base_length":
        base = torch.zeros(5)
    elif bad == "no_clusters":
        W, base = torch.zeros(0, 3), torch.zeros(0)
    elif bad == "seed_size":
        seed = torch.zeros(2, dtype=torch.int32)
    else:
        W = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError):
        la.fused_linear_assign(X, W, base, seed)
    assert la.fused_linear_assign(torch.zeros(6, 3), torch.zeros(4, 3), torch.zeros(4), _seed()).shape == (6,)
