"""The port's checkpoints, runner trace, queries, dataview and state
carry-across, against the JAX package.

A state goes between the packages as numpy leaves (`convert`) or as a
checkpoint blob; both packages then score it. Tolerances are stated at
each assert.
"""

import dataclasses
import json
from io import BytesIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import io as jio
from common_tpu import models as jmodels
from common_tpu import query as jquery
from common_tpu import state as jst
from common_tpu.data import numpy_dataview as j_dataview
from common_tpu.runner import runner as jrunner
from common_tpu_torch import convert, io, models, query, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.data import numpy_dataview
from common_tpu_torch.parallel import stack_states
from common_tpu_torch.runner import run_chain, runner

torch.set_num_threads(2)


def _jleaves(s):
    arrays = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {"assignments": np.asarray(s.assignments), "counts": np.asarray(s.counts),
            "cluster_hp": arrays(s.cluster_hp), "stats": tuple(arrays(f) for f in s.stats),
            "hypers": tuple(arrays(h) for h in s.hypers), "lik_names": tuple(s.lik_names),
            "fixed": bool(s.fixed)}


def _assert_leaves_equal(a, b):
    """Two numpy-leaf dicts (convert's layout) hold equal arrays of equal dtypes."""
    assert a["lik_names"] == b["lik_names"] and a["fixed"] == b["fixed"]
    pairs = [(a["assignments"], b["assignments"]), (a["counts"], b["counts"])]
    pairs += [(a["cluster_hp"][k], v) for k, v in b["cluster_hp"].items()]
    for part in ("stats", "hypers"):
        for x, y in zip(a[part], b[part]):
            assert x.keys() == y.keys()
            pairs += [(x[k], v) for k, v in y.items()]
    for x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _problem(n=12, seed=0):
    """tests/test_io_diagnostics.py's niw + bb problem, for the port."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 2)).astype(np.float32)
    b = r.integers(0, 2, size=n)
    defn = st.model_definition(n, [models.niw(2), models.bb], k_max=6)
    data = ((torch.from_numpy(X), torch.ones(n)), (torch.from_numpy(b), torch.ones(n)))
    return defn, data, (X, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_with_generator(tmp_path):
    defn, data, _ = _problem()
    s = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.3})
    g = rng(7, "cpu").generator
    torch.rand(5, generator=g)  # a generator part way along its stream
    path = str(tmp_path / "ckpt.npz")
    io.save(path, s, extra={"gen": g, "iter": 42})
    s2, extra = io.load(path, device="cpu")
    _assert_leaves_equal(convert.state_to_numpy(s2), convert.state_to_numpy(s))
    assert int(extra["iter"]) == 42
    assert isinstance(extra["gen"], torch.Generator)
    assert torch.equal(torch.rand(9, generator=extra["gen"]), torch.rand(9, generator=g))
    stacked = stack_states([s, st.initialize(defn, data, rng(1, "cpu").generator)])
    back, _ = io.deserialize(io.serialize(stacked), device="cpu")
    _assert_leaves_equal(convert.state_to_numpy(back), convert.state_to_numpy(stacked))
    with pytest.raises(TypeError, match="MixtureState"):
        io.serialize({"not": "a state"})


def test_resume_is_bit_exact():
    """Six sweeps == three, checkpoint with the generator, three more
    (tests/test_io_diagnostics.py:44 for the port): the assignments, the
    stats and the score trace are equal, bit for bit."""
    defn, data, _ = _problem(seed=1)
    s0 = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0})
    config = [("assign", {}), ("grid_cluster_hp", {"prior": sf.log_exponential(1.0),
                                                   "grid": np.geomspace(0.1, 10, 9)})]
    g = rng(9, "cpu").generator
    straight, trace = run_chain(s0, data, g, 6, config)

    g = rng(9, "cpu").generator
    half, t1 = run_chain(s0, data, g, 3, config)
    restored, extra = io.deserialize(io.serialize(half, extra={"gen": g, "iter": 3}), device="cpu")
    resumed, t2 = run_chain(restored, data, extra["gen"], 6 - int(extra["iter"]), config)

    assert torch.equal(straight.assignments, resumed.assignments)
    assert torch.equal(straight.cluster_hp["alpha"], resumed.cluster_hp["alpha"])
    for a, b in zip(straight.stats, resumed.stats):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(trace["score"], torch.cat([t1["score"], t2["score"]]))
    assert torch.equal(trace["assignments"], torch.cat([t1["assignments"], t2["assignments"]]))


def test_a_jax_blob_loads_and_scores_the_same_in_float64():
    """A MixtureState written by `common_tpu.io.checkpoint.serialize` (float64
    leaves) loads in the port. The likelihood score agrees to 1e-9; the joint
    score to rtol 1e-6, since the JAX package's EPPF is float32."""
    r = np.random.default_rng(2)
    n = 20
    X, y = r.normal(size=(n, 2)), r.normal(size=n)
    with jax.enable_x64(True):
        jdata = ((jnp.asarray(X), jnp.ones(n)), (jnp.asarray(y), jnp.ones(n)))
        js = jst.initialize(jst.model_definition(n, [jmodels.niw(2), jmodels.nich], k_max=7), jdata,
                            jax.random.key(0), cluster_hp={"alpha": np.float64(0.9)},
                            feature_hps=[{"mu0": np.zeros(2), "kappa": np.float64(0.5),
                                          "psi": np.eye(2), "nu": np.float64(3.0)},
                                         {"mu": np.float64(0.0), "kappa": np.float64(1.0),
                                          "sigmasq": np.float64(1.0), "nu": np.float64(2.0)}],
                            assignment=jnp.asarray(r.integers(0, 5, n), jnp.int32))
        blob = jio.serialize(js, extra={"iter": jnp.asarray(11)})
        want_lik = float(jst.score_likelihood(js))
        want_joint = float(jst.score_joint(js))
    s, extra = io.deserialize(blob, device="cpu")
    _assert_leaves_equal(convert.state_to_numpy(s), _jleaves(js))
    assert s.stats[0]["sum_xxT"].dtype == torch.float64 and int(extra["iter"]) == 11
    np.testing.assert_allclose(float(st.score_likelihood(s)), want_lik, rtol=1e-9)
    np.testing.assert_allclose(float(st.score_joint(s)), want_joint, rtol=1e-6)
    # and a port blob loads in the JAX package (float64 leaves need x64 there)
    with jax.enable_x64(True):
        back, _ = jio.deserialize(io.serialize(s))
        _assert_leaves_equal(_jleaves(back), convert.state_to_numpy(s))


def test_a_prng_key_leaf_is_refused():
    jdefn = jst.model_definition(6, [jmodels.bb], k_max=3)
    js = jst.initialize(jdefn, ((jnp.asarray([0, 1, 1, 0, 1, 1]), jnp.ones(6)),), jax.random.key(0))
    blob = jio.serialize(js, extra={"key": jax.random.key(3)})
    with pytest.raises(ValueError, match="PRNG key"):
        io.deserialize(blob, device="cpu")
    s, extra = io.deserialize(jio.serialize(js), device="cpu")  # without the key it loads
    assert extra == {} and s.lik_names == ("bb",)


# ---------------------------------------------------------------------------
# runner JSONL trace
# ---------------------------------------------------------------------------
def test_jsonl_lines_match_the_jax_runner(tmp_path):
    defn, data, (X, b) = _problem(seed=3)
    config = [("assign", {}), ("ew_cluster_hp", {})]
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    path = tmp_path / "port.jsonl"
    run = runner(defn, data, s, config, jsonl_path=str(path))
    run.run(rng(1, "cpu").generator, 3)
    run.run(rng(2, "cpu").generator, 2)
    jpath = tmp_path / "jax.jsonl"
    jdefn = jst.model_definition(12, [jmodels.niw(2), jmodels.bb], k_max=6)
    jdata = ((jnp.asarray(X), jnp.ones(12)), (jnp.asarray(b), jnp.ones(12)))
    jrun = jrunner(jdefn, jdata, jst.initialize(jdefn, jdata, jax.random.key(0)), config,
                   jsonl_path=str(jpath))
    jrun.run(jax.random.key(1), 3)
    jrun.run(jax.random.key(2), 2)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    jlines = [json.loads(x) for x in jpath.read_text().splitlines()]
    assert len(lines) == len(jlines) == 5
    for got, want in zip(lines, jlines):
        assert list(got) == list(want)
        assert {k: type(v) for k, v in got.items() if v is not None} == \
            {k: type(v) for k, v in want.items() if v is not None}
    assert [x["sweep"] for x in lines] == list(range(5))
    assert [x["ess"] is None for x in lines] == [x["ess"] is None for x in jlines] == \
        [True, True, True, True, False]
    np.testing.assert_array_equal([x["score_joint"] for x in lines], run.score_trace.astype(np.float64))
    for x, c in zip(lines, run.k_active_trace):
        assert x["k_active"] == c and sum(x["occupancy"]) == 12
        assert x["occupancy"] == sorted(x["occupancy"], reverse=True)


# ---------------------------------------------------------------------------
# queries, dataview
# ---------------------------------------------------------------------------
def test_queries_match_jax():
    r = np.random.default_rng(4)
    samples = r.integers(0, 4, size=(7, 30)).astype(np.int32)
    samples[2, 5] = -1
    z = query.zmatrix(samples)
    zj = jquery.zmatrix(samples)
    # exact counts of 0/1 over 7 samples on both sides; XLA's division by 7
    # may round the last bit otherwise: rtol 1e-6
    np.testing.assert_allclose(z, zj, rtol=1e-6)
    np.testing.assert_array_equal(query.zmatrix(torch.from_numpy(samples)), z)
    order = query.zmatrix_heuristic_block_ordering(z)
    np.testing.assert_array_equal(order, jquery.zmatrix_heuristic_block_ordering(z))
    np.testing.assert_array_equal(query.zmatrix_reorder(z, order), jquery.zmatrix_reorder(z, order))
    for a, b in zip(query.groups(samples[2]), jquery.groups(samples[2])):
        np.testing.assert_array_equal(a, b)
    assert len(query.groups(torch.from_numpy(samples[2]))) == len(jquery.groups(samples[2]))
    scores = r.normal(scale=30.0, size=50)
    np.testing.assert_allclose(query.posterior_predictive_logp(scores),
                               jquery.posterior_predictive_logp(scores), rtol=1e-12)
    with pytest.raises(ValueError, match=r"\[S, N\]"):
        query.zmatrix(samples[0])


def test_numpy_dataview_matches_jax_columns():
    r = np.random.default_rng(5)
    n = 9
    rec = np.zeros(n, dtype=[("b", np.bool_), ("x", np.float32), ("v", np.float32, (2,))])
    rec["b"] = r.random(n) < 0.5
    rec["x"] = r.normal(size=n)
    rec["v"] = r.normal(size=(n, 2))
    masked = np.ma.masked_array(rec, mask=np.zeros(n, dtype=[("b", bool), ("x", bool), ("v", bool, (2,))]))
    masked.mask["x"][3] = True
    masked.mask["v"][6, 1] = True  # one missing element masks the whole vector cell
    jdefn = jst.model_definition(n, [jmodels.bb, jmodels.nich, jmodels.niw(2)], k_max=4)
    defn = st.model_definition(n, [models.bb, models.nich, models.niw(2)], k_max=4)
    for arr, dj, dt in ((rec, None, None), (masked, jdefn, defn), ([rec["x"], rec["v"]], None, None),
                        (rec["v"], None, None)):
        view, jview = numpy_dataview(arr, dt, device="cpu"), j_dataview(arr, dj)
        assert len(view) == len(jview) == view.size() == n
        assert len(view.columns) == len(jview.columns)
        for (v, m), (jv, jm) in zip(view.view(), jview.columns):
            assert m.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        for a, b in zip(view.toarray(), jview.toarray()):
            np.testing.assert_array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b))
    with pytest.raises(ValueError, match="row count"):
        numpy_dataview([np.zeros(3), np.zeros(4)], device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        numpy_dataview(3.0, device="cpu")
    with pytest.raises(ValueError, match="data columns"):
        numpy_dataview([rec["x"]], defn, device="cpu")


# ---------------------------------------------------------------------------
# state carry-across, every likelihood
# ---------------------------------------------------------------------------
def _zoo_columns(n, r):
    return [
        (models.bb, jmodels.bb, r.integers(0, 2, n)),
        (models.bbnc, jmodels.bbnc, r.integers(0, 2, n)),
        (models.gp, jmodels.gp, r.poisson(2.0, n).astype(np.int32)),
        (models.nich, jmodels.nich, r.normal(size=n).astype(np.float32)),
        (models.bnb, jmodels.bnb, r.integers(0, 5, n).astype(np.int32)),
        (models.dd(3), jmodels.dd(3), r.integers(0, 3, n).astype(np.int32)),
        (models.dm(3), jmodels.dm(3), r.multinomial(4, [0.2, 0.3, 0.5], n).astype(np.float32)),
        (models.niw(2), jmodels.niw(2), r.normal(size=(n, 2)).astype(np.float32)),
        (models.bbv(3), jmodels.bbv(3), (r.random((n, 3)) < 0.4).astype(np.float32)),
    ]


def test_convert_carries_every_likelihood_both_ways():
    """A JAX state over the whole zoo, bbnc's latent p included, comes to the
    port and back with every leaf equal; both score it alike (float32,
    rtol 1e-5), and the port's own initialize builds the same stats."""
    r = np.random.default_rng(6)
    n = 25
    cols = _zoo_columns(n, r)
    z = r.integers(0, 4, n).astype(np.int32)
    jdefn = jst.model_definition(n, [j for _, j, _ in cols], k_max=6)
    jdata = tuple((jnp.asarray(x), jnp.ones(n)) for _, _, x in cols)
    js = jst.initialize(jdefn, jdata, jax.random.key(0), assignment=jnp.asarray(z))
    p = np.asarray(js.stats[1]["p"]).copy()
    p[:4] = [0.2, 0.7, 0.4, 0.9]
    js = dataclasses.replace(js, stats=(js.stats[0], {**js.stats[1], "p": jnp.asarray(p)}, *js.stats[2:]))
    leaves = _jleaves(js)
    s = convert.state_from_numpy(leaves, device="cpu")
    _assert_leaves_equal(convert.state_to_numpy(s), leaves)
    np.testing.assert_allclose(float(st.score_joint(s)), float(jst.score_joint(js)), rtol=1e-5)
    defn = st.model_definition(n, [t for t, _, _ in cols], k_max=6)
    data = tuple((torch.from_numpy(x), torch.ones(n)) for _, _, x in cols)
    own = st.initialize(defn, data, rng(0, "cpu").generator, assignment=z)
    for f, (a, b) in enumerate(zip(own.stats, s.stats)):
        for k in b:
            if k != "p":
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=f"{f} {k}")


def test_sample_and_sample_post_pred_cover_the_zoo():
    r = np.random.default_rng(7)
    cols = _zoo_columns(10, r)
    defn = st.model_definition(40, [t for t, _, _ in cols], k_max=8)
    data, z = st.sample(defn, rng(0, "cpu").generator, cluster_hp={"alpha": 2.0})
    assert z.shape == (40,) and int(z.max()) < 8
    for (v, m), (_, _, x) in zip(data, cols):
        assert v.shape == (40, *x.shape[1:]) and m.shape == (40,)
        assert bool(torch.isfinite(v.to(torch.float64)).all())
    s = st.initialize(defn, data, rng(1, "cpu").generator, assignment=z)
    assert np.isfinite(float(st.score_joint(s)))
    pp, zp = st.sample_post_pred(s, rng(2, "cpu").generator, size=6)
    assert zp.shape == (6,)
    for (v, _), (vd, _) in zip(pp, data):
        assert v.shape == (6, *vd.shape[1:]) and v.dtype == vd.dtype


def test_repad_matches_jax():
    r = np.random.default_rng(8)
    n = 10
    x = r.normal(size=(n, 2)).astype(np.float32)
    z = r.integers(0, 3, n).astype(np.int32)
    jdefn = jst.model_definition(n, [jmodels.niw(2)], k_max=4)
    js = jst.initialize(jdefn, ((jnp.asarray(x), jnp.ones(n)),), jax.random.key(0), assignment=jnp.asarray(z))
    s = convert.state_from_numpy(_jleaves(js), device="cpu")
    _assert_leaves_equal(convert.state_to_numpy(st.repad(s, 9)), _jleaves(jst.repad(js, 9)))
    assert st.repad(s, 4) is s
    with pytest.raises(ValueError, match="new_k_max"):
        st.repad(s, 2)


# ---------------------------------------------------------------------------
# the topic states and the variational posterior: blobs cross both ways
# ---------------------------------------------------------------------------
def _np_tree(v):
    """A JAX state's field as convert's numpy layout (dicts, tuples, arrays)."""
    if isinstance(v, dict):
        return {k: _np_tree(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_np_tree(x) for x in v)
    return v if isinstance(v, (str, bool)) else np.asarray(v)


def _assert_tree_equal(a, b, path="state"):
    """Equal structure, and every array equal in dtype, shape and value."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}.{i}")
    elif isinstance(b, (str, bool)):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _jax_topic_states():
    """One state of each type the port gained a checkpoint for, made by the JAX package."""
    from common_tpu.data.variadic import variadic_dataview as j_variadic
    from common_tpu import topic as jtopic
    from common_tpu.kernels import svi as jsvi

    r = np.random.default_rng(9)
    rows = [r.integers(0, 7, size=int(n)) for n in r.integers(1, 6, size=5)]
    jview = j_variadic(rows, pad_to=30)
    hdp_state = jtopic.initialize(jview, 4, 7, jax.random.key(1), alpha=0.9)
    lda_post, _ = jtopic.svi.fit_cavi(jtopic.svi.init(3, 7, jax.random.key(2)),
                                      jtopic.svi.doc_term_matrix(jview, 7, 5), n_iters=2)
    n = 10
    jdata = ((jnp.asarray(r.normal(size=(n, 2)), jnp.float32), jnp.ones(n)),
             (jnp.asarray(r.integers(0, 2, n)), jnp.ones(n)))
    svi_post = jsvi.init(jst.model_definition(n, [jmodels.niw(2), jmodels.bb], k_max=5), jdata,
                         jax.random.key(3), cluster_hp={"alpha": 1.2})
    from common_tpu import relational as jirm
    from common_tpu.data.sparse import sparse_ndarray_dataview as j_sparse

    jviews = [j_sparse(dense=(r.random((4, 5)) < 0.5).astype(np.float32)),
              j_sparse(dense=r.poisson(2.0, (4, 4)).astype(np.int32), missing_mask=r.random((4, 4)) < 0.3)]
    irm_state = jirm.initialize(jirm.model_definition([4, 5], [((0, 1), jmodels.bb), ((0, 0), jmodels.gp)],
                                                      k_max=[3, 2]),
                                jviews, jax.random.key(4), cluster_hps=[{"alpha": 0.8}, {"alpha": 1.5}])
    return {"HDPState": (hdp_state, convert.hdp_to_numpy), "LDAPosterior": (lda_post, convert.lda_to_numpy),
            "SVIPosterior": (svi_post, convert.svi_to_numpy), "IRMState": (irm_state, convert.irm_to_numpy)}


@pytest.mark.parametrize("tname", ["HDPState", "LDAPosterior", "SVIPosterior", "IRMState"])
def test_topic_and_svi_blobs_cross_both_ways(tname):
    """A blob written by `common_tpu.io.serialize` loads in the port with every
    leaf equal (dtype and value); the port's blob loads in the JAX package
    the same way; and a port round trip keeps the generator in `extra`."""
    jstate, to_numpy = _jax_topic_states()[tname]
    want = {f.name: _np_tree(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    state, extra = io.deserialize(jio.serialize(jstate, extra={"iter": jnp.asarray(5)}), device="cpu")
    assert type(state).__name__ == tname and int(extra["iter"]) == 5
    _assert_tree_equal(to_numpy(state), want)
    back, _ = jio.deserialize(io.serialize(state))
    assert type(back).__name__ == tname
    _assert_tree_equal({f.name: _np_tree(getattr(back, f.name)) for f in dataclasses.fields(back)}, want)
    g = rng(4, "cpu").generator
    again, extra = io.deserialize(io.serialize(state, extra={"gen": g}), device="cpu")
    _assert_tree_equal(to_numpy(again), want)
    assert torch.equal(torch.rand(3, generator=extra["gen"]), torch.rand(3, generator=g))


def test_an_irm_state_is_still_refused():
    """A blob that names IRMState but holds a mixture state's fields is
    refused, by its type name, before any field is rebuilt."""
    js = jst.initialize(jst.model_definition(6, [jmodels.bb], k_max=3),
                        ((jnp.asarray([0, 1, 1, 0, 1, 1]), jnp.ones(6)),), jax.random.key(0))
    with np.load(BytesIO(jio.serialize(js))) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["__meta__"].tobytes()).decode())
    arrays["__meta__"] = np.frombuffer(json.dumps({**meta, "type": "IRMState"}).encode(), dtype=np.uint8)
    out = BytesIO()
    np.savez(out, **arrays)
    with pytest.raises(ValueError, match="checkpoint state type"):
        io.deserialize(out.getvalue(), device="cpu")


def test_collapsed_hdp_resume_is_bit_exact():
    """Four [assign, concentrations] iterations of the collapsed HDP sampler
    == two, a checkpoint with the generator, two more: z, the counts, beta,
    the hypers and the score trace equal bit for bit."""
    from common_tpu_torch import topic
    from common_tpu_torch.data import variadic_dataview

    r = np.random.default_rng(10)
    rows = [r.integers(0, 8, size=int(n)) for n in r.integers(3, 9, size=6)]
    data = topic.token_data(variadic_dataview(rows, pad_to=50, device="cpu"))
    s0 = topic.initialize(data, 5, 8, rng(0, "cpu").generator, n_docs=6)
    config = [("assign", {}), ("concentrations", {})]
    straight, trace = run_chain(s0, data, rng(3, "cpu").generator, 4, config)
    g = rng(3, "cpu").generator
    half, t1 = run_chain(s0, data, g, 2, config)
    restored, extra = io.deserialize(io.serialize(half, extra={"gen": g}), device="cpu")
    resumed, t2 = run_chain(restored, data, extra["gen"], 2, config)
    _assert_tree_equal(convert.hdp_to_numpy(resumed), convert.hdp_to_numpy(straight))
    for k in ("score", "assignments", "counts"):
        assert torch.equal(trace[k], torch.cat([t1[k], t2[k]])), k
    assert not torch.equal(straight.z, s0.z)


def test_collapsed_irm_resume_is_bit_exact():
    """Four [assign, ew_domain_alpha] iterations of the collapsed IRM sampler
    == two, a checkpoint with the generator, two more: the assignments,
    counts, suffstats, alphas and the score trace equal bit for bit."""
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview

    r = np.random.default_rng(12)
    z = np.arange(9) % 2
    rel = (r.random((9, 9)) < np.where(z[:, None] == z[None, :], 0.9, 0.1)).astype(np.float32)
    defn = irm.model_definition([9, 9], [((0, 0), models.bb), ((0, 1), models.bb)], k_max=4)
    views = [sparse_ndarray_dataview(dense=rel, missing_mask=r.random((9, 9)) < 0.2, device="cpu"),
             sparse_ndarray_dataview(dense=rel.T, device="cpu")]
    s0 = irm.initialize(defn, views, rng(0, "cpu").generator)
    config = [("assign", {}), ("ew_domain_alpha", {})]
    straight, trace = run_chain(s0, views, rng(3, "cpu").generator, 4, config)
    g = rng(3, "cpu").generator
    half, t1 = run_chain(s0, views, g, 2, config)
    restored, extra = io.deserialize(io.serialize(half, extra={"gen": g}), device="cpu")
    assert restored.rel_domains == ((0, 0), (0, 1)) and restored.lik_names == ("bb", "bb")
    resumed, t2 = run_chain(restored, views, extra["gen"], 2, config)
    _assert_tree_equal(convert.irm_to_numpy(resumed), convert.irm_to_numpy(straight))
    for k in ("score", "assignments", "counts"):
        assert torch.equal(trace[k], torch.cat([t1[k], t2[k]])), k
    assert not torch.equal(trace["assignments"][0], trace["assignments"][-1])  # the chain moved
