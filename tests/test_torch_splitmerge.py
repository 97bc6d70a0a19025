"""The port's split-merge (`common_tpu_torch/kernels/splitmerge.py`) against
the JAX package.

Samplers, as tests/test_splitmerge.py holds the JAX kernel: pure
split-merge is ergodic on partitions, so its equilibrium must match the
exact posterior (computed by the JAX package) with no help from
single-site sweeps; a mixed assign + split-merge chain too; KL(exact ||
sampled) < 0.02 by `assert_discrete_dist_approx`. Structural invariants
at 400 rows.

Deterministic pieces, float64 on both sides on one state carried across
by `convert` (an niw and a nich feature, a masked cell): the two-component
stats, the launch table, `_ml_sum`, `_slot_ml`, and a split's and a
merge's d_ml + d_eppf and proposal log-density for a given proposal,
rtol = atol = 1e-6 (the JAX nich takes its rows in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammaln

from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu.kernels import splitmerge as jsm
from common_tpu_torch import convert, models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked, splitmerge
from common_tpu_torch.runner import KERNELS, run_chain

from test_gibbs_exact import exact_partition_posterior

torch.set_num_threads(2)

# float64 on both sides, but the JAX nich takes its rows in float32
# (common_tpu/likelihoods/nich.py:59-64), so scores agree to 1e-6
TOL = dict(rtol=1e-6, atol=1e-6)


def _check(exact, defn, data, chp, config, nsweeps=3000):
    cache = {}

    def sample_fn(n):
        if n not in cache:
            s = st.initialize(defn, data, rng(100 + len(cache), "cpu").generator, cluster_hp=chp)
            _, trace = run_chain(s, data, rng(len(cache), "cpu").generator, n + 100, config)
            cache[n] = [testutil.permutation_canonical(a) for a in trace["assignments"][100:].numpy()]
        return cache[n]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=nsweeps, ntries=3, kl_tol=0.02)


def test_pure_splitmerge_bb_matches_enumeration():
    x = np.random.default_rng(0).integers(0, 2, size=4)
    chp = {"alpha": 1.2}
    exact = exact_partition_posterior(jst.model_definition(4, [jmodels.bb], k_max=5),
                                      ((jnp.asarray(x), jnp.ones(4)),), chp)
    defn = st.model_definition(4, [models.bb], k_max=5)
    _check(exact, defn, ((torch.from_numpy(x), torch.ones(4)),), chp,
           [("split_merge", {"n_moves": 2, "t_scans": 2})])


def test_mixed_assign_splitmerge_niw_matches_enumeration():
    x = np.random.default_rng(0).normal(size=(4, 2)).astype(np.float32)
    chp = {"alpha": 0.8}
    exact = exact_partition_posterior(jst.model_definition(4, [jmodels.niw(2)], k_max=5),
                                      ((jnp.asarray(x), jnp.ones(4)),), chp)
    defn = st.model_definition(4, [models.niw(2)], k_max=5)
    _check(exact, defn, ((torch.from_numpy(x), torch.ones(4)),), chp,
           [("assign", {}), ("split_merge", {"n_moves": 1, "t_scans": 2})])


def test_splitmerge_invariants_medium():
    """Counts equal a bincount of z, stats a restat of it (rtol 1e-3, atol
    1e-2, as in JAX), empty slots hold exact zeros, and the chain moves."""
    n, d, K = 400, 3, 8
    r = np.random.default_rng(0)
    centers = r.normal(scale=4.0, size=(3, d))
    x = (centers[r.integers(0, 3, size=n)] + r.normal(size=(n, d))).astype(np.float32)
    defn = st.model_definition(n, [models.niw(d)], k_max=K)
    data = ((torch.from_numpy(x), torch.ones(n)),)
    s = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0})
    g = rng(1, "cpu").generator
    k_actives = []
    for _ in range(30):
        s = splitmerge.move(s, data, g, t_scans=2)
        k_actives.append(int((s.counts > 0).sum()))
    counts = s.counts.numpy()
    np.testing.assert_array_equal(counts, np.bincount(s.assignments.numpy(), minlength=K))
    plain = blocked.restat(s, data, s.assignments)
    for leaf in ("n", "sum_x", "sum_xxT"):
        np.testing.assert_allclose(s.stats[0][leaf].numpy(), plain.stats[0][leaf].numpy(), rtol=1e-3, atol=1e-2)
        assert (s.stats[0][leaf].numpy()[counts == 0] == 0.0).all()
    assert len(set(k_actives)) > 1, k_actives


def test_splitmerge_rejects_fixed_and_nonconjugate():
    data = ((torch.zeros(6), torch.ones(6)),)
    s = st.initialize(st.model_definition(6, [models.bb], k_max=3), data, rng(0, "cpu").generator,
                      cluster_hp={"alphas": np.full(3, 1.0, np.float32)}, fixed=True)
    with pytest.raises(ValueError, match="non-fixed"):
        splitmerge.move(s, data, rng(1, "cpu").generator)
    s2 = st.initialize(st.model_definition(6, [models.bbnc], k_max=4), data, rng(0, "cpu").generator,
                       cluster_hp={"alpha": 1.0})
    with pytest.raises(ValueError, match="conjugate"):
        splitmerge.move(s2, data, rng(1, "cpu").generator)
    assert "split_merge" in KERNELS


@pytest.mark.parametrize("start, kind", [([0] * 6, "split"), (list(range(6)), "merge")])
def test_move_counts_its_proposals_by_kind(start, kind, monkeypatch):
    """`move.proposed` counts each proposal's kind from its anchors' clusters:
    with every row in one slot each proposal is a split, with each row in
    its own slot a merge (at K = 8 the state keeps room to split)."""
    monkeypatch.setattr(splitmerge.move, "proposed", {"split": 0, "merge": 0})
    data = ((torch.tensor([0, 1, 1, 0, 1, 0]), torch.ones(6)),)
    s = st.initialize(st.model_definition(6, [models.bb], k_max=8), data, rng(0, "cpu").generator,
                      cluster_hp={"alpha": 1e-6}, assignment=np.array(start, np.int32))
    splitmerge.moves(s, data, rng(1, "cpu").generator, n_moves=1)
    splitmerge.move(s, data, rng(2, "cpu").generator)
    assert splitmerge.move.proposed == {"split": 0, "merge": 0, kind: 2}


# ---------------------------------------------------------------------------
# deterministic pieces, float64 against JAX
# ---------------------------------------------------------------------------
N, K = 16, 6
NIW_HYPER = {"mu0": np.array([0.3, -0.2]), "kappa": np.float64(0.8),
             "psi": np.array([[1.5, 0.2], [0.2, 0.9]]), "nu": np.float64(3.5)}
NICH_HYPER = {"mu": np.float64(0.1), "kappa": np.float64(1.3), "sigmasq": np.float64(0.7),
              "nu": np.float64(2.5)}


def _f64_problem(seed=0):
    """An niw + nich state in float64 on both sides: slots 0-3 hold rows, 4-5
    are empty, row 7's nich cell is masked."""
    r = np.random.default_rng(seed)
    X = r.normal(scale=2.0, size=(N, 2))
    y = r.normal(size=N)
    mask = np.ones(N)
    mask[7] = 0.0
    z = r.integers(0, 4, N).astype(np.int32)
    z[:4] = [0, 1, 2, 3]
    with jax.enable_x64(True):
        jdata = ((jnp.asarray(X), jnp.ones(N)), (jnp.asarray(y), jnp.asarray(mask)))
        js = jst.initialize(jst.model_definition(N, [jmodels.niw(2), jmodels.nich], k_max=K), jdata,
                            jax.random.key(0), cluster_hp={"alpha": np.float64(1.3)},
                            feature_hps=[NIW_HYPER, NICH_HYPER], assignment=jnp.asarray(z))
        leaves = {"assignments": np.asarray(js.assignments), "counts": np.asarray(js.counts),
                  "cluster_hp": {k: np.asarray(v) for k, v in js.cluster_hp.items()},
                  "stats": tuple({k: np.asarray(v) for k, v in f.items()} for f in js.stats),
                  "hypers": tuple({k: np.asarray(v) for k, v in h.items()} for h in js.hypers),
                  "lik_names": tuple(js.lik_names), "fixed": False}
    data = ((torch.from_numpy(X), torch.ones(N, dtype=torch.float64)),
            (torch.from_numpy(y), torch.from_numpy(mask)))
    return js, jdata, convert.state_from_numpy(leaves, device="cpu"), data, z


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_launch_table_and_marginal_sums_match_jax():
    js, jdata, s, data, z = _f64_problem()
    member = (z == 1) | (z == 3)
    lab = np.random.default_rng(1).integers(0, 2, N).astype(np.int32)
    stats2, counts2 = splitmerge._member_stats(s, data, torch.from_numpy(member), torch.from_numpy(lab))
    lp = splitmerge._launch_table(s, data, stats2, counts2)
    with jax.enable_x64(True):
        @jax.jit
        def pieces(member, lab):
            jstats2, jcounts2 = jsm._member_stats(js, jdata, member, lab)
            return (jstats2, jcounts2, jsm._launch_table(js, jdata, jstats2, jcounts2),
                    jsm._ml_sum(js, jstats2), [jsm._slot_ml(js, k) for k in range(K)])

        jstats2, jcounts2, jlp, jml, jslot = pieces(jnp.asarray(member), jnp.asarray(lab))
        jslot = [float(v) for v in jslot]
    _close(counts2, jcounts2)
    for f in range(2):
        for k, v in jstats2[f].items():
            _close(stats2[f][k], v)
    assert lp.shape == (N, 2)
    _close(lp, jlp)
    _close(splitmerge._ml_sum(s, stats2), jml)
    _close([float(splitmerge._slot_ml(s, k)) for k in range(K)], jslot)
    _close(splitmerge._slot_ml(s, [1, 3]), jslot[1] + jslot[3])


def _jax_terms(js, jdata, ci, cj, member, lab, free, prop, z, a, b):
    """The JAX move's log-acceptance terms for a given proposal, in one
    compiled call: (log q, its sum over the free rows, d_ml, d_eppf)."""

    @jax.jit
    def terms(member, lab, free, prop, z):
        jst2, jc2 = jsm._member_stats(js, jdata, member, lab)
        jlogq = jax.nn.log_softmax(jsm._launch_table(js, jdata, jst2, jc2), axis=-1)
        alpha = js.cluster_hp["alpha"]
        labels = prop if ci == cj else (z == cj).astype(jnp.int32)
        jq = jnp.sum(jnp.where(free, jnp.take_along_axis(jlogq, labels[:, None], axis=-1)[:, 0], 0.0))
        if ci == cj:
            jst2p, _ = jsm._member_stats(js, jdata, member, prop)
            d_ml = jsm._ml_sum(js, jst2p) - jsm._slot_ml(js, ci)
            d_eppf = jnp.log(alpha) + gammaln(a) + gammaln(b) - gammaln(a + b)
        else:
            ml = 0.0
            for lik, h, sf in zip(js.likelihoods(), js.hypers, js.stats):
                ml = ml + lik.marginal_loglik(h, {k: v[ci] + v[cj] for k, v in sf.items()})
            d_ml = ml - jsm._slot_ml(js, ci) - jsm._slot_ml(js, cj)
            d_eppf = gammaln(a + b) - gammaln(a) - gammaln(b) - jnp.log(alpha)
        return jlogq, jq, d_ml, d_eppf

    return terms(member, lab, free, prop, z)


def test_split_and_merge_terms_match_jax():
    """For a given proposal: the split's d_ml, d_eppf and log q_forward (the
    JAX split branch, common_tpu/kernels/splitmerge.py:168-183) and the
    merge's d_ml, d_eppf and log q_reverse (:203-226)."""
    js, jdata, s, data, z = _f64_problem(2)
    r = np.random.default_rng(3)
    i, j = 0, 4
    for ci, cj in ((int(z[i]), int(z[i])), (0, 2)):
        member = (z == ci) | (z == cj)
        free = member.copy()
        free[[i, j]] = False
        lab = np.where(free, r.integers(0, 2, N), 1).astype(np.int32)
        lab[i] = 0
        prop = np.where(free, r.integers(0, 2, N), lab).astype(np.int32)
        tm, tf = torch.from_numpy(member), torch.from_numpy(free)
        stats2, counts2 = splitmerge._member_stats(s, data, tm, torch.from_numpy(lab))
        logq = torch.log_softmax(splitmerge._launch_table(s, data, stats2, counts2), -1)
        a, b = float((member & (prop == 0)).sum()), float((member & (prop == 1)).sum())
        if ci != cj:
            a, b = float(js.counts[ci]), float(js.counts[cj])
        with jax.enable_x64(True):
            jlogq, jq, jd_ml, jd_eppf = _jax_terms(js, jdata, ci, cj, jnp.asarray(member), jnp.asarray(lab),
                                                   jnp.asarray(free), jnp.asarray(prop), jnp.asarray(z), a, b)
        _close(logq, jlogq)
        if ci == cj:
            d_ml, d_eppf, q, _, cnt_a, cnt_b = splitmerge._split_terms(
                s, data, tm, tf, torch.from_numpy(prop), logq, ci)
            assert (float(cnt_a), float(cnt_b)) == (a, b)
        else:
            d_ml, d_eppf, q, _ = splitmerge._merge_terms(s, torch.from_numpy(z), tf, logq, ci, cj)
        _close(d_ml, jd_ml)
        _close(d_eppf, jd_eppf)
        _close(q, jq)
        _close(d_ml + d_eppf, jd_ml + jd_eppf)
