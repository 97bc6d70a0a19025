"""The port's blocked IRM sweep (`relational/kernels.py`) and its runner route
against the benchmark's float64 reference (`benchmark/reference/irm.py`), on
seeded small relations on the CPU.

The reference is written from Kemp et al. (2006) and Beta-Bernoulli
conjugacy and shares no code with the port. On 48 x 40 Beta-Bernoulli
relations with K_max 6 and a few cells missing:

- the counts and the (n, heads) suffstats equal the reference's recount
  exactly (bb's stats hold integers, exact in float32);
- `_domain_loglik_table` over chunks of 50 cells equals the float64 table
  to atol 2e-4: each entry sums at most 48 float32 terms of magnitude at
  most 16.6 (log(1 - p) is floored at log(eps / 2)), each rounded by about
  6e-8 relative, and the chunk sums add in float32: 48 x 16.6 x 1.2e-7 is
  about 1e-4;
- `score_joint` within 2e-6 relative of the float64 score (float32 lgamma
  of arguments up to about 2,000 carries about 6e-8 relative of a term ten
  times the score);
- theta's draw fits its Beta parameters (`beta_fit_t` below 5 over 200
  draws) and with bb's alpha doubled does not;
- each domain's blocked draw of z follows the reference's conditional
  softmax(log w + table) (two entities jointly, the exact-enumeration
  oracle `testutil.assert_discrete_dist_approx`, KL < 0.05);
- one runner step of `[assign_blocked]` equals `kernels.sweep` on the same
  generator bit for bit.

Last, the reference's own statistics read N(0, 1) (or U(0, 1)) for exact
draws.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.reference import irm as ref
from benchmark.reference.hdp import DirichletFit
from benchmark.reference.precision import REFERENCE
from common_tpu import testutil
from common_tpu_torch import models, rng
from common_tpu_torch import relational as irm
from common_tpu_torch.data import sparse_ndarray_dataview
from common_tpu_torch.relational import kernels
from common_tpu_torch.runner import runner

torch.set_num_threads(2)

N0, N1, K = 48, 40, 6


def _gen(seed):
    return rng(seed, "cpu").generator


def _relation(seed):
    """(x [N0, N1] float32, observed [N0, N1] bool): 3 x 2 planted blocks, 2 % of the cells missing."""
    r = np.random.default_rng(seed)
    eta = np.array([[0.8, 0.1], [0.2, 0.7], [0.5, 0.05]])
    x = (r.random((N0, N1)) < eta[np.arange(N0) % 3][:, np.arange(N1) % 2]).astype(np.float32)
    missing = r.random((N0, N1)) < 0.02
    return torch.from_numpy(x), torch.from_numpy(~missing), missing


def _state(seed, sweeps=2, start=None):
    """(x, observed, views, state) a few blocked sweeps from a seeded start."""
    x, observed, missing = _relation(seed)
    views = irm.as_views([sparse_ndarray_dataview(dense=x.numpy(), missing_mask=missing, device="cpu")])
    defn = irm.model_definition([N0, N1], [((0, 1), models.bb)], k_max=K)
    s = irm.initialize(defn, views, _gen(seed + 1), cluster_hps=[{"alpha": 1.2}, {"alpha": 0.7}],
                       domain_assignments=start)
    g = _gen(seed + 2)
    for _ in range(sweeps):
        s = kernels.sweep(s, views, g)
    return x, observed, views, s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_and_suffstats_equal_the_references(seed):
    x, observed, views, s = _state(seed)
    n, h = ref.block_counts(s.assignments[0], s.assignments[1], x, observed, K, K)
    assert torch.equal(s.suffstats[0]["n"].to(torch.int64), n)
    assert torch.equal(s.suffstats[0]["heads"].to(torch.int64), h)
    assert int(n.sum()) == int(observed.sum())  # a missing cell in no block
    for z, c in zip(s.assignments, s.counts):
        assert torch.equal(c.to(torch.int64), ref.assignment_counts(z, K))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_blocked_table_over_chunks_is_the_float64_references(seed, monkeypatch):
    """Chunks of 50 cells (TABLE_ELEMS / K), so each table sums 39 chunks."""
    x, observed, views, s = _state(seed)
    monkeypatch.setattr(kernels, "TABLE_ELEMS", 50 * K)
    thetas = kernels._sample_block_params(s, _gen(seed + 3))
    for d, z_other in ((0, s.assignments[1]), (1, s.assignments[0])):
        got = kernels._domain_loglik_table(s, irm.as_views(views), thetas, d)
        want = ref.table(z_other, x, observed, thetas[0]["p"], d, REFERENCE)
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got.to(torch.float64), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_joint_is_the_float64_references(seed):
    x, observed, _, s = _state(seed)
    want = ref.score_joint(s.assignments[0], s.assignments[1], x, observed, K, K, 1.0, 1.0, (1.2, 0.7), REFERENCE)
    got = float(irm.score_joint(s))
    assert abs(got - want) <= 2e-6 * abs(want), (got, want)


def test_the_theta_draw_fits_its_beta_parameters():
    """200 draws of `_sample_block_params` from one state against Beta(1 + h,
    1 + n - h) of the reference's recount; a draw with bb's alpha doubled
    reads far off."""
    x, observed, _, s = _state(4)
    n, h = ref.block_counts(s.assignments[0], s.assignments[1], x, observed, K, K)
    A, B = ref.theta_params(n, h, 1.0, 1.0)
    g = _gen(5)
    draws = torch.stack([kernels._sample_block_params(s, g)[0]["p"] for _ in range(200)])
    doubled = dataclasses.replace(s, hypers=({**s.hypers[0], "alpha": 2.0 * s.hypers[0]["alpha"]},))
    wrong = torch.stack([kernels._sample_block_params(doubled, g)[0]["p"] for _ in range(200)])
    expand = (200, K, K)
    assert ref.beta_fit_t(draws, A.expand(expand), B.expand(expand)) < 5
    assert ref.beta_fit_t(wrong, A.expand(expand), B.expand(expand)) > 10


@pytest.mark.parametrize("domain", [0, 1])
def test_the_blocked_draw_follows_the_references_conditional(domain, monkeypatch):
    """Given one theta near 1/2 (so the conditionals spread over the slots)
    and fixed stick weights, two entities' z over many `_sweep_domain` calls
    follow softmax(log w + the float64 table) jointly (K^2 outcomes)."""
    x, observed, views, s = _state(6, sweeps=1)
    views = irm.as_views(views)
    g = torch.Generator().manual_seed(7)
    theta = ({"p": (0.5 + 0.04 * torch.randn((K, K), generator=g)).to(torch.float32)},)
    logw = torch.log_softmax(torch.randn(K, generator=g), -1).to(torch.float32)
    monkeypatch.setattr(kernels, "stick_break_log_weights", lambda generator, counts, alpha: logw)
    z_other = s.assignments[1 - domain]
    logits = logw.to(torch.float64)[None, :] + ref.table(z_other, x, observed, theta[0]["p"], domain, REFERENCE)
    probs = torch.softmax(logits, -1).numpy()
    picks = (3, 17)
    exact = {(a, b): float(probs[picks[0], a] * probs[picks[1], b]) for a in range(K) for b in range(K)}
    calls = []

    def sample_fn(n):
        calls.append(n)
        gen = _gen(100 + len(calls))
        out = []
        for _ in range(n):
            z = kernels._sweep_domain(s, views, theta, domain, gen)
            out.append(tuple(int(z[e]) for e in picks))
        return out

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.05)


def test_a_runner_step_of_assign_blocked_equals_the_sweep():
    x, observed, views, s0 = _state(8, sweeps=0)
    run = runner(None, views, s0, [("assign_blocked", {})])
    run.run(_gen(9), 3)
    g, s = _gen(9), s0
    for _ in range(3):
        s = kernels.sweep(s, views, g)
    got = run.get_latent()
    for f in ("assignments", "counts"):
        for a, b in zip(getattr(got, f), getattr(s, f)):
            assert torch.equal(a, b), f
    for k in s.suffstats[0]:
        assert torch.equal(got.suffstats[0][k], s.suffstats[0][k]), k
    assert np.array_equal(run.assignment_trace[-1], torch.cat(s.assignments).numpy())
    assert float(run.score_trace[-1]) == float(irm.score_joint(s))


# ---------------------------------------------------------------------------
# the reference's statistics
# ---------------------------------------------------------------------------
def test_the_beta_fit_reads_n01_for_exact_draws():
    """300 exact draws of 400 Beta entries, from nearly empty blocks to blocks
    of 10^5 cells: the shift statistic and the signed two-group fit each have
    mean within 0.2 of 0 and sd within 0.8-1.25 (sampling error at 300 draws
    about 0.06 and 0.04)."""
    g = torch.Generator().manual_seed(1)
    n = torch.cat([torch.randint(0, 4, (200,), generator=g), torch.randint(10, 100_000, (200,), generator=g)])
    h = (n.double() * torch.rand(400, generator=g, dtype=torch.float64)).floor()
    A, B = ref.theta_params(n, h, 1.0, 1.0)
    shift, fits = [], []
    for _ in range(300):
        x = ref.beta_draw(A, B, g, REFERENCE)
        shift.append(ref.beta_shift_z(x, A, B))
        fit = DirichletFit()
        fit.add(torch.stack([x, 1.0 - x], -1), torch.stack([A, B], -1), torch.ones((400, 2), dtype=torch.bool), 2)
        fits.append((fit.q - fit.mean) / math.sqrt(fit.var))
    for ts in (torch.tensor(shift), torch.tensor(fits)):
        assert abs(float(ts.mean())) < 0.2 and 0.8 < float(ts.std()) < 1.25, (ts.mean(), ts.std())


def test_the_assignment_fit_reads_uniform_for_exact_draws():
    """Exact categorical draws from logits as the cell's are once clusters form
    (most rows certain to hundreds of nats, some split between two slots):
    the transform's u over 200 x 2,000 draws has mean 1/2 and variance 1/12
    to 1 %, the standardised sum of u - 1/2 a replicate reads N(0, 1) (mean
    within 0.2 of 0, sd within 0.8-1.25), and the smallest 1 - u a replicate,
    as a probability, reads U(0, 1) (mean within 0.07 of 1/2)."""
    g = torch.Generator().manual_seed(2)
    N, Kc = 2000, 8
    logits = -200.0 - 100.0 * torch.rand((N, Kc), generator=g, dtype=torch.float64)
    logits[:, 0] = 0.0
    split = torch.rand(N, generator=g) < 0.2
    logits[split, 1] = -3.0 * torch.rand(int(split.sum()), generator=g, dtype=torch.float64)
    q = torch.softmax(logits, -1)
    us, sums, p_min = [], [], []
    for _ in range(200):
        z = torch.multinomial(q, 1, generator=g)[:, 0]
        u, rest = ref.pit(logits, z, g)
        assert torch.allclose(u + rest, torch.ones_like(u), atol=1e-12)
        us.append(u)
        sums.append(float((u - 0.5).sum()) / math.sqrt(N / 12.0))
        p_min.append(float(-torch.expm1(N * torch.log1p(-rest.min()))))
        assert ref.assign_fit_t(logits, z, g) < 6
    u = torch.cat(us)
    assert abs(float(u.mean()) - 0.5) < 0.005 and abs(float(u.var()) * 12.0 - 1.0) < 0.01
    sums = torch.tensor(sums)
    assert abs(float(sums.mean())) < 0.2 and 0.8 < float(sums.std()) < 1.25, (sums.mean(), sums.std())
    assert abs(float(np.mean(p_min)) - 0.5) < 0.07
    bad = z.clone()
    bad[5] = 4  # a slot at least 200 nats below the row's best
    assert ref.assign_fit_t(logits, bad, g) > 10
    assert ref.assign_fit_t(logits, torch.full((N,), Kc), g) == math.inf
