"""The port's infinite relational model (`relational/`, `data/sparse.py`)
and its runner family against the JAX package.

Deterministic pieces get the same numpy inputs on both sides: the sparse
dataview must agree exactly; the suffstat block tensors, the scores
(`score_assignment`, `score_likelihood`, `score_joint`) and link prediction
(`pred_logpdf`, `predict_missing`) to rtol 1e-6 in float64
(`jax.enable_x64`) on one set of assignments, for bb, gp and nich relations
in each of a bipartite relation, a self-relation and a three-axis relation;
the blocked sweep's [N_d, K_d] table to the same on one theta carried
across as numpy (also on a ragged relation whose chunks of cells end inside
an entity's cells, and the suffstats rebuilt in chunks of 4 cells); the collapsed step's [K_d] conditional to the JAX
package's `score_joint` over the candidate assignments, at atol 1e-4 in
log space. The JAX package computes some pieces in float32 even under x64
(each likelihood's tx and logpdf cast cell values to it, and the CRP EPPF
is scored in it), so the port's float64 meets it at float32's rounding:
about 1e-5 on these scores of a few hundred nats.

The samplers cannot match the JAX package draw for draw (Philox and
threefry), so they are held to the oracles of tests/test_irm.py: the
collapsed and blocked sweeps on a 4-entity self-relation and the collapsed
sweep on a 3 x 3 bipartite relation against the exact posterior from the
JAX package's `score_joint` (KL < 0.05 at 3000 samples), Escobar-West
against quadrature; and the collapsed and blocked samplers agree on the
planted 72 x 72 relation of tests/test_cross_sampler_families.py.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln as sgammaln
from scipy.special import logsumexp as sp_logsumexp

from common_tpu import models as jmodels
from common_tpu import relational as jirm
from common_tpu import testutil
from common_tpu.data.sparse import sparse_ndarray_dataview as j_sparse
from common_tpu_torch import convert, models, rng
from common_tpu_torch import relational as irm
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch.data import sparse_ndarray_dataview
from common_tpu_torch.parallel.chains import map_tensors, stack_states
from common_tpu_torch.relational import kernels
from common_tpu_torch.runner import IRM_FAMILY, IRM_KERNELS, runner

torch.set_num_threads(2)

F64 = dict(rtol=1e-6, atol=0)


def _gen(seed):
    return rng(seed, "cpu").generator


# ---------------------------------------------------------------------------
# the sparse dataview
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad_to", [None, 40])
def test_sparse_dataview_matches_jax(pad_to):
    """Exactly equal, dtypes included (the JAX side under x64, which keeps float64 values)."""
    with jax.enable_x64(True):
        _check_sparse_dataview(pad_to)


def _check_sparse_dataview(pad_to):
    r = np.random.default_rng(0)
    dense = r.normal(size=(5, 6))
    missing = r.random((5, 6)) < 0.3
    for kw in (dict(dense=dense, missing_mask=missing), dict(dense=np.ma.masked_array(dense, missing)),
               dict(dense=dense)):
        j = j_sparse(pad_to=pad_to, **kw)
        t = sparse_ndarray_dataview(pad_to=pad_to, device="cpu", **kw)
        for name in ("indices", "values", "mask"):
            want, got = np.asarray(getattr(j, name)), getattr(t, name).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert (t.ndim, t.nobserved(), len(t), t.shape) == (j.ndim, j.nobserved(), len(j), j.shape)
        jd, td = j.todense(), t.todense()
        np.testing.assert_array_equal(td.mask, jd.mask)
        np.testing.assert_array_equal(td.filled(0), jd.filled(0))
    # COO triples of a three-axis relation
    idx = np.array([[0, 1, 2], [3, 0, 1], [1, 1, 1]])
    vals = np.array([1, 0, 1], np.int32)
    j = j_sparse(indices=idx, values=vals, shape=(4, 2, 3), pad_to=pad_to)
    t = sparse_ndarray_dataview(indices=idx, values=vals, shape=(4, 2, 3), pad_to=pad_to, device="cpu")
    for name in ("indices", "values", "mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.values.dtype == torch.int32 and t.todense().count() == 3


def test_sparse_dataview_errors():
    with pytest.raises(ValueError, match="pad_to"):
        sparse_ndarray_dataview(dense=np.ones((3, 3)), pad_to=4, device="cpu")
    with pytest.raises(ValueError, match="inconsistent"):
        sparse_ndarray_dataview(indices=np.zeros((3, 2)), values=np.ones(2), shape=(2, 2), device="cpu")
    for missing in ("indices", "values", "shape"):
        kw = dict(indices=np.zeros((2, 2)), values=np.ones(2), shape=(2, 2))
        kw[missing] = None
        with pytest.raises(ValueError, match=missing):
            sparse_ndarray_dataview(device="cpu", **kw)


# ---------------------------------------------------------------------------
# deterministic functions in float64: bb, gp and nich on every topology
# ---------------------------------------------------------------------------
SIZES = (5, 4, 3)
TOPOLOGIES = ((0, 1), (0, 0), (0, 1, 2))  # bipartite, self-relation, three-axis
K_MAXES = (4, 3, 3)
HYPERS = {"bb": {"alpha": 0.7, "beta": 1.3}, "gp": {"alpha": 2.0, "inv_beta": 0.5},
          "nich": {"mu": 0.3, "kappa": 0.8, "sigmasq": 1.5, "nu": 2.5}}
# each case puts every likelihood on a different topology; the three cover all nine pairs
CASES = {"bb-gp-nich": ("bb", "gp", "nich"), "gp-nich-bb": ("gp", "nich", "bb"),
         "nich-bb-gp": ("nich", "bb", "gp")}


def _values(name, shape, r):
    """Cell values that float32 holds exactly (the JAX package's tx casts to
    it), nich's in quarters, so both packages sum the same numbers."""
    if name == "bb":
        return (r.random(shape) < 0.4).astype(np.float64)
    if name == "gp":
        return r.poisson(2.0, shape).astype(np.float64)
    return np.round(4 * r.normal(0.5, 1.3, shape)) / 4


def _problem(case, seed=0):
    """(names, dense relations with missing masks, assignments) of one case."""
    r = np.random.default_rng(seed)
    names = CASES[case]
    rels = []
    for name, doms in zip(names, TOPOLOGIES):
        shape = tuple(SIZES[d] for d in doms)
        rels.append((_values(name, shape, r), r.random(shape) < 0.25))
    z = [r.integers(0, k, size=n).astype(np.int32) for n, k in zip(SIZES, K_MAXES)]
    z[0][:2] = K_MAXES[0] - 1  # a cluster past an empty one
    return names, rels, z


def _jax_state(names, rels, z, alphas=(1.3, 0.6, 2.0)):
    jdefn = jirm.model_definition(SIZES, [(d, getattr(jmodels, n)) for n, d in zip(names, TOPOLOGIES)],
                                  k_max=list(K_MAXES))
    jviews = [j_sparse(dense=v, missing_mask=m) for v, m in rels]
    js = jirm.initialize(jdefn, jviews, jax.random.key(0), cluster_hps=[{"alpha": a} for a in alphas],
                         relation_hps=[HYPERS[n] for n in names], domain_assignments=z)
    return jviews, js


def _port_state(names, rels, z, alphas=(1.3, 0.6, 2.0)):
    defn = irm.model_definition(SIZES, [(d, getattr(models, n)) for n, d in zip(names, TOPOLOGIES)],
                                k_max=list(K_MAXES))
    views = [sparse_ndarray_dataview(dense=v, missing_mask=m, device="cpu") for v, m in rels]
    s = irm.initialize(defn, views, _gen(0), cluster_hps=[{"alpha": a} for a in alphas],
                       relation_hps=[HYPERS[n] for n in names], domain_assignments=z)
    return views, s


def _query(rels, r, m=7):
    """m query cells of each relation, with their shapes' index ranges."""
    return [np.stack([r.integers(0, n, m) for n in v.shape], -1) for v, _ in rels]


def _jleaves(js):
    """A JAX IRMState's leaves for `convert.irm_from_numpy`, floats as float64."""
    def arr(v):
        a = np.asarray(v)
        return a.astype(np.float64) if a.dtype.kind == "f" else a

    leaves = {f: tuple({k: arr(v) for k, v in d.items()} if isinstance(d, dict) else arr(d)
                       for d in getattr(js, f))
              for f in ("assignments", "counts", "cluster_hps", "suffstats", "hypers")}
    return {**leaves, "lik_names": js.lik_names, "rel_domains": js.rel_domains}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_scores_and_prediction_match_jax_in_float64(case):
    """The port's suffstats against the JAX package's (rtol 1e-6: its tx casts
    cell values to float32); then, on the JAX state carried across in
    float64, every score and prediction at rtol 1e-6."""
    names, rels, z = _problem(case)
    r = np.random.default_rng(1)
    queries = _query(rels, r)
    cands = {"bb": (0.0, 1.0), "gp": (0.0, 1.0, 3.0), "nich": (-1.0, 0.2, 2.5)}
    with jax.enable_x64(True):
        _, js = _jax_state(names, rels, z)
        leaves = _jleaves(js)
        js = jirm.IRMState(**leaves)  # the same leaves, floats in float64
        want = {"assignment": float(jirm.score_assignment(js)), "joint": float(jirm.score_joint(js)),
                "likelihood": [float(jirm.score_likelihood(js, rid)) for rid in range(3)]}
        want_pred = [np.asarray(jirm.pred_logpdf(js, rid, q, np.full(len(q), cands[n][1])))
                     for rid, (n, q) in enumerate(zip(names, queries))]
        want_miss = [np.asarray(jirm.predict_missing(js, rid, q, cands[n]))
                     for rid, (n, q) in enumerate(zip(names, queries))]
    _, own = _port_state(names, rels, z)
    assert all(a.dtype == torch.int32 for a in own.assignments + own.counts)
    assert own.rel_domains == TOPOLOGIES and own.lik_names == names
    for got, exp in zip(own.suffstats, leaves["suffstats"]):
        assert got.keys() == exp.keys()
        for k in exp:
            assert got[k].dtype == torch.float64 and got[k].shape == exp[k].shape
            np.testing.assert_allclose(got[k].numpy(), exp[k], rtol=1e-6, atol=1e-6, err_msg=k)
    s = convert.irm_from_numpy(leaves, device="cpu")
    np.testing.assert_allclose(float(irm.score_assignment(s)), want["assignment"], **F64)
    np.testing.assert_allclose(float(irm.score_joint(s)), want["joint"], **F64)
    for rid in range(3):
        np.testing.assert_allclose(float(irm.score_likelihood(s, rid)), want["likelihood"][rid], **F64)
        q = queries[rid]
        got = irm.pred_logpdf(s, rid, q, np.full(len(q), cands[names[rid]][1]))
        np.testing.assert_allclose(got.numpy(), want_pred[rid], **F64)
        miss = irm.predict_missing(s, rid, q, cands[names[rid]])
        np.testing.assert_allclose(miss.numpy(), want_miss[rid], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(miss.sum(-1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_in_chunks_of_cells_match_jax(case, monkeypatch):
    """The suffstat rebuild over chunks of 4 cells (the chunk sums added in
    order) against the JAX package's at rtol 1e-6 in float64; bb's exactly."""
    names, rels, z = _problem(case, seed=7)
    with jax.enable_x64(True):
        want = _jleaves(_jax_state(names, rels, z)[1])["suffstats"]
    monkeypatch.setattr(irm.state, "STATS_CELLS", 4)
    _, own = _port_state(names, rels, z)
    for name, got, exp in zip(names, own.suffstats, want):
        for k in exp:
            if name == "bb":
                np.testing.assert_array_equal(got[k].numpy(), exp[k], err_msg=k)
            np.testing.assert_allclose(got[k].numpy(), exp[k], rtol=1e-6, atol=1e-6, err_msg=k)


def _allowed(counts_minus):
    """Candidate slots of the collapsed step: every active slot, and the first empty one."""
    active = counts_minus > 0
    out = list(np.nonzero(active)[0])
    if (~active).any():
        out.append(int(np.argmax(~active)))
    return sorted(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_collapsed_conditional_matches_jax_score_joint(case):
    """The [K_d] conditional of one entity step == softmax over the candidate
    assignments of the JAX package's score_joint, for entities of every domain."""
    names, rels, z = _problem(case, seed=2)
    views, s = _port_state(names, rels, z)
    views = irm.as_views(views)
    for d, e in ((0, 0), (0, 3), (1, 2), (2, 1)):
        work = map_tensors(lambda t: t.unsqueeze(0), kernels._working_copy(s))  # a stack of one chain
        preps = kernels._prepare(work, views, d, kernels._tx_payload(work))
        logp, _ = kernels._remove_and_score(work, preps, d, e)
        logp = logp[0].numpy()
        cm = np.bincount(np.delete(z[d], e), minlength=K_MAXES[d])
        allowed = _allowed(cm)
        assert np.isneginf(np.delete(logp, allowed)).all()
        scores = []
        with jax.enable_x64(True):
            for g in allowed:
                zz = [a.copy() for a in z]
                zz[d][e] = g
                scores.append(float(jirm.score_joint(_jax_state(names, rels, zz)[1])))
        want = np.array(scores) - sp_logsumexp(scores)
        got = logp[allowed] - sp_logsumexp(logp[allowed])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=f"domain {d} entity {e}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_domain_loglik_table_matches_jax_on_one_theta(case, monkeypatch):
    names, rels, z = _problem(case, seed=3)
    r = np.random.default_rng(4)
    thetas = []
    for n, doms in zip(names, TOPOLOGIES):
        shape = tuple(K_MAXES[d] for d in doms)
        if n == "bb":
            thetas.append({"p": r.uniform(0.05, 0.95, shape)})
        elif n == "gp":
            thetas.append({"lam": r.uniform(0.3, 4.0, shape)})
        else:
            thetas.append({"mu": r.normal(size=shape), "var": r.uniform(0.3, 2.0, shape)})
    with jax.enable_x64(True):
        jviews, js = _jax_state(names, rels, z)
        jth = tuple({k: jnp.asarray(v) for k, v in t.items()} for t in thetas)
        want = [np.asarray(jirm.kernels._domain_loglik_table(js, jirm.as_views(jviews), jth, d))
                for d in range(3)]
    views, s = _port_state(names, rels, z)
    tth = tuple({k: torch.from_numpy(v) for k, v in t.items()} for t in thetas)
    monkeypatch.setattr(kernels, "TABLE_ELEMS", 10)  # several chunks of cells
    for d in range(3):
        got = kernels._domain_loglik_table(s, irm.as_views(views), tth, d)
        assert got.shape == (SIZES[d], K_MAXES[d])
        np.testing.assert_allclose(got.numpy(), want[d], **F64)


def _theta(name, shape, r):
    if name == "bb":
        return {"p": r.uniform(0.05, 0.95, shape)}
    if name == "gp":
        return {"lam": r.uniform(0.3, 4.0, shape)}
    return {"mu": r.normal(size=shape), "var": r.uniform(0.3, 2.0, shape)}


@pytest.mark.parametrize("name,table_elems", [("gp", 8), ("nich", 20), ("bb", 1 << 25)])
def test_ragged_domain_loglik_table_matches_jax(name, table_elems, monkeypatch):
    """A ragged sparse relation (7 x 9, 40% of cells missing, row 2 and
    column 5 with none observed): each domain's table against the JAX
    package's at rtol 1e-6 in float64, with chunks of 2 cells, of 5 and of
    all cells, so chunk edges fall inside entities' cells; the empty
    entities' rows are exactly 0."""
    r = np.random.default_rng(6)
    rel = _values(name, (7, 9), r)
    missing = r.random((7, 9)) < 0.4
    missing[2, :] = True
    missing[:, 5] = True
    z = [r.integers(0, 4, 7).astype(np.int32), r.integers(0, 4, 9).astype(np.int32)]
    theta = _theta(name, (4, 4), r)
    with jax.enable_x64(True):
        jdefn = jirm.model_definition([7, 9], [((0, 1), getattr(jmodels, name))], k_max=4)
        jviews = [j_sparse(dense=rel, missing_mask=missing)]
        js = jirm.initialize(jdefn, jviews, jax.random.key(0), cluster_hps=[{"alpha": 1.0}] * 2,
                             relation_hps=[HYPERS[name]], domain_assignments=z)
        jth = ({k: jnp.asarray(v) for k, v in theta.items()},)
        want = [np.asarray(jirm.kernels._domain_loglik_table(js, jirm.as_views(jviews), jth, d)) for d in range(2)]
    defn = irm.model_definition([7, 9], [((0, 1), getattr(models, name))], k_max=4)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, missing_mask=missing, device="cpu")])
    s = irm.initialize(defn, views, _gen(0), cluster_hps=[{"alpha": 1.0}] * 2,
                       relation_hps=[HYPERS[name]], domain_assignments=z)
    monkeypatch.setattr(kernels, "TABLE_ELEMS", table_elems)
    tth = ({k: torch.from_numpy(v) for k, v in theta.items()},)
    for d, empty in ((0, 2), (1, 5)):
        got = kernels._domain_loglik_table(s, views, tth, d)
        np.testing.assert_allclose(got.numpy(), want[d], **F64)
        assert torch.equal(got[empty], torch.zeros(4, dtype=got.dtype))


# ---------------------------------------------------------------------------
# samplers against the enumeration oracles of tests/test_irm.py
# ---------------------------------------------------------------------------
def _self_problem(n=4, seed=0, k_max=5):
    r = np.random.default_rng(seed)
    rel = (r.random((n, n)) < 0.5).astype(np.float32)
    return rel, k_max


def _exact(rel, doms, sizes, k_max, alpha):
    """The exact posterior over (partition, ...) from the JAX package's score_joint."""
    defn = jirm.model_definition(sizes, [(doms, jmodels.bb)], k_max=k_max)
    views = [j_sparse(dense=rel)]
    combos, scores = [], []
    for parts in itertools.product(*(list(testutil.permutation_iter(n)) for n in sizes)):
        s = jirm.initialize(defn, views, jax.random.key(0), cluster_hps=[{"alpha": alpha}] * len(sizes),
                            domain_assignments=[np.asarray(p, np.int32) for p in parts])
        combos.append(parts if len(sizes) > 1 else parts[0])
        scores.append(float(jirm.score_joint(s)))
    return dict(zip(combos, np.exp(np.array(scores) - sp_logsumexp(scores))))


def _chain(rel, doms, sizes, k_max, alpha, step, n, seed, burnin=100, n_chains=1):
    """n canonical samples from n_chains chains (a chain stack when more than
    one), each past its burn-in."""
    defn = irm.model_definition(sizes, [(doms, models.bb)], k_max=k_max)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    g = _gen(seed)
    chains = [irm.initialize(defn, views, g, cluster_hps=[{"alpha": alpha}] * len(sizes))
              for _ in range(n_chains)]
    s = chains[0] if n_chains == 1 else stack_states(chains)
    out = []
    for i in range(-(-n // n_chains) + burnin):
        s = step(s, views, g)
        if i >= burnin:
            zs = [a.numpy().reshape(n_chains, -1) for a in s.assignments]
            for c in range(n_chains):
                canon = tuple(testutil.permutation_canonical(z[c]) for z in zs)
                out.append(canon if len(sizes) > 1 else canon[0])
    return out[:n]


@pytest.mark.parametrize("kernel", ["collapsed", "blocked"])
def test_self_relation_matches_enumeration(kernel):
    """The collapsed sweep runs 30 chains as one stack; the blocked sweep one chain."""
    rel, k_max = _self_problem()
    alpha = 1.2
    exact = _exact(rel, (0, 0), (4,), k_max, alpha)
    if kernel == "collapsed":
        step, kw = (lambda s, v, g: kernels.assign(s, v, g, domain=0)), dict(n_chains=30, burnin=30)
    else:
        step, kw = kernels.sweep, {}
    cache = {}

    def sample_fn(n):
        if n not in cache:
            cache[n] = _chain(rel, (0, 0), (4,), k_max, alpha, step, n, seed=len(cache), **kw)
        return cache[n]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.05)


def test_bipartite_matches_enumeration():
    """2-domain relation: the joint posterior over (partition, partition),
    30 collapsed chains as one stack."""
    r = np.random.default_rng(1)
    rel = (r.random((3, 3)) < 0.5).astype(np.float32)
    exact = _exact(rel, (0, 1), (3, 3), 4, 1.0)
    cache = {}

    def sample_fn(n):
        if n not in cache:
            cache[n] = _chain(rel, (0, 1), (3, 3), 4, 1.0, kernels.assign_all, n, seed=len(cache) + 7,
                              burnin=30, n_chains=30)
        return cache[n]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.05)


def test_collapsed_stack_equals_its_chains_in_turn():
    """A chain stack's collapsed sweep moves every chain by the same step as
    a chain alone: with one chain, the stack and the state agree draw for draw."""
    rel, k_max = _self_problem(n=6, seed=4)
    defn = irm.model_definition([6, 6], [((0, 0), models.bb), ((0, 1), models.gp)], k_max=k_max)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu"),
                          sparse_ndarray_dataview(dense=3 * rel, device="cpu")])
    s = irm.initialize(defn, views, _gen(0))
    one = kernels.assign_all(s, views, _gen(1))
    stacked = kernels.assign_all(stack_states([s]), views, _gen(1))
    for a, b in zip(one.assignments + one.counts, stacked.assignments + stacked.counts):
        assert torch.equal(a, b[0])
    for r in range(2):
        for k in one.suffstats[r]:
            assert torch.equal(one.suffstats[r][k], stacked.suffstats[r][k][0])


def test_blocked_bipartite_sweep_reassigns_in_parallel():
    """A domain free of self-relations takes the parallel table path: its new
    assignment is the Gumbel argmax of the table (the sequential path is not
    taken), and the counts and stats are rebuilt from it."""
    r = np.random.default_rng(5)
    rel = (r.random((6, 5)) < 0.5).astype(np.float32)
    defn = irm.model_definition([6, 5], [((0, 1), models.bb)], k_max=4)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    s = irm.initialize(defn, views, _gen(0))
    assert not kernels._self_relational(s, 0) and not kernels._self_relational(s, 1)
    out = kernels.sweep(s, views, _gen(1))
    back = kernels.restat(out, views)
    for d in range(2):
        assert torch.equal(out.counts[d], back.counts[d]) and int(out.counts[d].sum()) == (6, 5)[d]
    assert torch.equal(out.suffstats[0]["heads"], back.suffstats[0]["heads"])
    assert views[0].entity_cells == {}  # no per-entity index: no sequential step ran


# ---------------------------------------------------------------------------
# invariants, missing cells, hyper kernels
# ---------------------------------------------------------------------------
def test_counts_and_stats_invariants():
    rel, _ = _self_problem(n=6, seed=2)
    defn = irm.model_definition([6], [((0, 0), models.bb)], k_max=4)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    s0 = irm.initialize(defn, views, _gen(0), cluster_hps=[{"alpha": 1.0}])
    s, g = s0, _gen(1)
    for _ in range(5):
        s = kernels.assign(s, views, g, domain=0)
    assert int(s.counts[0].sum()) == 6
    assert float(s.suffstats[0]["n"].sum()) == 36.0  # all 36 observed cells, none lost
    assert np.isfinite(float(irm.score_joint(s)))
    rebuilt = kernels.restat(s, views)
    assert torch.equal(rebuilt.counts[0], s.counts[0])
    for k in s.suffstats[0]:
        assert torch.equal(rebuilt.suffstats[0][k], s.suffstats[0][k])
    # the caller's state is unchanged; the index was built once and is reused
    assert torch.equal(s0.assignments[0], irm.initialize(defn, views, _gen(0)).assignments[0])
    assert len(views[0].entity_cells) == 1


def test_entity_cells_lists_a_diagonal_cell_once():
    idx = np.array([[0, 0], [0, 1], [1, 0], [2, 2], [1, 2]])
    view = irm.as_views([sparse_ndarray_dataview(indices=idx, values=np.ones(5), shape=(3, 3),
                                                 pad_to=7, device="cpu")])[0]
    ptr, cells, occ, kept = kernels.entity_cells(view, (0, 0), 0, 3)
    assert ptr == [0, 3, 6, 8]
    lists = [sorted(cells[ptr[e]:ptr[e + 1]].tolist()) for e in range(3)]
    assert lists == [[0, 1, 2], [1, 2, 4], [3, 4]]  # padding cells left out
    assert kept == ((0, False), (1, False))
    assert occ[cells.tolist().index(0)].tolist() == [True, True]


def test_missing_cells_excluded():
    n = 5
    r = np.random.default_rng(3)
    rel = (r.random((n, n)) < 0.5).astype(np.float32)
    missing = r.random((n, n)) < 0.3
    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=4)
    view = sparse_ndarray_dataview(dense=rel, missing_mask=missing, device="cpu")
    s = irm.initialize(defn, [view], _gen(0), cluster_hps=[{"alpha": 1.0}])
    expected = float((~missing).sum())
    assert float(s.suffstats[0]["n"].sum()) == expected
    s = kernels.assign(s, [view], _gen(1))
    assert float(s.suffstats[0]["n"].sum()) == expected
    s = kernels.sweep(s, [view], _gen(2))
    assert float(s.suffstats[0]["n"].sum()) == expected


def _fixed_partition_state(n=30, kplus=6):
    assignment = np.repeat(np.arange(kplus), n // kplus)
    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=8)
    r = np.random.default_rng(0)
    views = [sparse_ndarray_dataview(dense=(r.random((n, n)) < 0.5).astype(np.float32), device="cpu")]
    return irm.initialize(defn, views, _gen(0), cluster_hps=[{"alpha": 1.0}],
                          domain_assignments=[assignment.astype(np.int32)])


def test_domain_alpha_ew_matches_quadrature():
    """Stationary distribution of the per-domain Escobar-West kernel == quadrature."""
    n, kplus, a, b = 30, 6, 1.5, 0.5
    s, g = _fixed_partition_state(n, kplus), _gen(1)
    alphas = []
    for _ in range(6000):
        s = kernels.domain_alpha_escobar_west(s, g, a, b)
        alphas.append(s.cluster_hps[0]["alpha"])
    alphas = torch.stack(alphas).numpy()[1000:]
    grid = np.linspace(1e-3, 40, 40001)
    logp = (a - 1) * np.log(grid) - b * grid + kplus * np.log(grid) + sgammaln(grid) - sgammaln(grid + n)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean_true = float((grid * w).sum())
    var_true = float(((grid - mean_true) ** 2 * w).sum())
    assert abs(alphas.mean() - mean_true) < 0.2 * np.sqrt(var_true), (alphas.mean(), mean_true)
    assert abs(alphas.var() / var_true - 1.0) < 0.35, (alphas.var(), var_true)


def test_domain_alpha_grid_concentrates():
    s = _fixed_partition_state()
    grid = np.geomspace(0.05, 40, 60).astype(np.float32)
    g = _gen(2)
    draws = [float(kernels.domain_alpha_grid(s, sf.log_exponential(0.5), grid, g).cluster_hps[0]["alpha"])
             for _ in range(200)]
    assert all(d in grid for d in draws)
    assert 0.5 < np.mean(draws) < 8.0  # the quadrature mean of the EW test is about 2.4


# ---------------------------------------------------------------------------
# the runner, link prediction, the two samplers at a planted scale
# ---------------------------------------------------------------------------
def test_irm_runner_integration(tmp_path):
    """runner() drives an IRMState through the JAX kernel names, with the
    family's traces (assignments and counts of all domains concatenated)."""
    n = 24
    r = np.random.default_rng(7)
    zr = np.repeat(np.arange(2), n // 2)
    probs = np.where(zr[:, None] == zr[None, :], 0.85, 0.1)
    rel = (r.random((n, n)) < probs).astype(np.float32)
    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=6)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    s = irm.initialize(defn, views, _gen(0), cluster_hps=[{"alpha": 1.0}])
    assert sorted(IRM_KERNELS) == ["assign", "assign_blocked", "ew_domain_alpha", "grid_domain_alpha"]
    path = str(tmp_path / "irm.jsonl")
    run = runner(defn, views, s, [("assign", {}), ("ew_domain_alpha", {"a": 1.0, "b": 1.0})],
                 jsonl_path=path)
    out = run.run(_gen(1), 30)
    assert np.isfinite(run.score_trace).all() and run.assignment_trace.shape == (30, n)
    z = out.assignments[0].numpy()
    same, truth = z[:, None] == z[None, :], zr[:, None] == zr[None, :]
    assert (same == truth).mean() > 0.9
    assert float(out.cluster_hps[0]["alpha"]) > 0
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    assert [x["score_joint"] for x in lines] == run.score_trace.astype(np.float64).tolist()
    assert lines[-1]["k_active"] == int((out.counts[0] > 0).sum())
    # a bipartite state: [assign (one domain), assign_blocked, grid_domain_alpha]
    defn2 = irm.model_definition([n, n], [((0, 1), models.bb)], k_max=[5, 6])
    s2 = irm.initialize(defn2, views, _gen(3))
    config = [("assign", {"domain": 1}), ("assign_blocked", {}),
              ("grid_domain_alpha", {"prior": sf.log_exponential(1.0), "grid": np.geomspace(0.1, 10, 20)})]
    run2 = runner(defn2, views, s2, config)
    out2 = run2.run(_gen(4), 3)
    assert run2.assignment_trace.shape == (3, 2 * n) and run2.k_active_trace.shape == (3,)
    assert IRM_FAMILY["counts"](out2).shape == (11,)
    assert not bool(IRM_FAMILY["is_saturated"](out2))
    with pytest.raises(ValueError, match="kernel name"):
        runner(defn2, views, s2, [("assign_blocked_fused", {})])


def test_link_prediction_recovers_block_structure():
    """Held-out cells of a 2-block relation predicted after collapsed sweeps."""
    n = 20
    r = np.random.default_rng(11)
    zr = np.repeat(np.arange(2), n // 2)
    probs = np.where(zr[:, None] == zr[None, :], 0.9, 0.1)
    rel = (r.random((n, n)) < probs).astype(np.float32)
    missing = r.random((n, n)) < 0.15
    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=6)
    view = sparse_ndarray_dataview(dense=rel, missing_mask=missing, device="cpu")
    s, g = irm.initialize(defn, [view], _gen(0), cluster_hps=[{"alpha": 1.0}]), _gen(1)
    for _ in range(15):
        s = kernels.assign(s, [view], g)
    held = np.argwhere(missing)
    p = irm.predict_missing(s, 0, held, (0.0, 1.0)).numpy()
    acc = ((p[:, 1] > 0.5) == (probs[held[:, 0], held[:, 1]] > 0.5)).mean()
    assert acc > 0.85, acc


def _mean_coassign(zs):
    zs = np.asarray(zs)
    return np.mean([z[:, None] == z[None, :] for z in zs], axis=0)


def test_irm_collapsed_blocked_agree():
    """Collapsed and blocked IRM on the planted 3-block 72 x 72 relation of
    tests/test_cross_sampler_families.py: co-assignment frequencies agree."""
    r = np.random.default_rng(0)
    n = 72
    zt = np.repeat(np.arange(3), n // 3)
    p = np.where(zt[:, None] == zt[None, :], 0.75, 0.25)
    rel = (r.random((n, n)) < p).astype(np.float32)
    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=8)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])

    def trace(step, seed, burn, keep):
        g = _gen(seed + 1)
        s = irm.initialize(defn, views, _gen(seed), cluster_hps=[{"alpha": 1.0}])
        out = []
        for i in range(burn + keep):
            s = step(s, views, g)
            if i >= burn:
                out.append(s.assignments[0].numpy())
        return out

    # collapsed Gibbs moves one entity at a time: from some CRP starts (all in
    # one cluster, or two planted blocks merged) it keeps the merge for hundreds
    # of sweeps, as in the JAX package; this start recovers, as the JAX test's does
    co_c = _mean_coassign(trace(kernels.assign, 1, 30, 80))
    co_b = _mean_coassign(trace(kernels.sweep, 2, 100, 300))
    d = np.abs(co_c - co_b).mean()
    assert d < 0.06, d
    truth = zt[:, None] == zt[None, :]
    for co in (co_c, co_b):
        assert ((co > 0.5) == truth).mean() > 0.9


def test_irm_state_crosses_with_convert():
    names, rels, z = _problem("bb-gp-nich")
    _, js = _jax_state(names, rels, z)
    leaves = {f: (tuple({k: np.asarray(v) for k, v in d.items()} for d in getattr(js, f))
                  if f in ("cluster_hps", "suffstats", "hypers")
                  else tuple(np.asarray(a) for a in getattr(js, f)))
              for f in ("assignments", "counts", "cluster_hps", "suffstats", "hypers")}
    leaves.update(lik_names=js.lik_names, rel_domains=js.rel_domains)
    s = convert.irm_from_numpy(leaves, device="cpu")
    assert s.rel_domains == TOPOLOGIES and s.counts[0].dtype == torch.int32
    np.testing.assert_allclose(float(irm.score_joint(s)), float(jirm.score_joint(js)), rtol=1e-5)
    back = convert.irm_to_numpy(s)
    for d in range(3):
        np.testing.assert_array_equal(back["assignments"][d], leaves["assignments"][d])
    assert back["rel_domains"] == TOPOLOGIES
