"""The port's HDP-LDA (`topic/hdp.py`), variadic dataview and runner family
against the JAX package.

Deterministic pieces get the same numpy inputs on both sides: the
dataview, `token_data`, `densify_corpus`, `dense_token_data` and
`_counts` must agree exactly; `score_joint` and `perplexity`, on one state
carried across as numpy leaves (`convert.hdp_from_numpy`), to rtol 1e-9 in
float64 (`jax.enable_x64`).

The samplers cannot match the JAX package draw for draw (Philox and
threefry), so they are held to the oracles of tests/test_hdp.py: the
collapsed, blocked (flat, chunked) and dense sweeps against brute-force
enumeration of z with beta fixed (the exact distribution from the JAX
package's `score_joint`, KL < 0.05), CRT against the Stirling pmf, the
concentration move against quadrature, the theta draw by a KS test of its
Beta marginals. A chain of the port's runner and one of the JAX runner's
on the example corpus agree in their seed means within 3 combined
standard errors. The last section covers `utils/util` and
`utils/profiling` on the CPU.
"""

import dataclasses
import itertools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps
from scipy.special import gammaln as sgammaln
from scipy.special import logsumexp as sp_logsumexp

from common_tpu import runner as jrunner
from common_tpu import testutil
from common_tpu import topic as jtopic
from common_tpu.data.variadic import variadic_dataview as j_variadic
from common_tpu.utils import util as jutil
from common_tpu_torch import convert, rng, topic
from common_tpu_torch.data import variadic_dataview
from common_tpu_torch.runner import HDP_KERNELS, _hdp_default_kw, runner
from common_tpu_torch.topic import hdp
from common_tpu_torch.utils import profiling, util

torch.set_num_threads(2)

F64 = dict(rtol=1e-9, atol=0)


def _gen(seed):
    return rng(seed, "cpu").generator


def _jleaves(js):
    return {"z": np.asarray(js.z), "beta": np.asarray(js.beta), "doc_topic": np.asarray(js.doc_topic),
            "topic_word": np.asarray(js.topic_word), "topic_total": np.asarray(js.topic_total),
            "hypers": {k: np.asarray(v) for k, v in js.hypers.items()}}


def _ragged(seed, n_docs=7, V=11):
    r = np.random.default_rng(seed)
    return [r.integers(0, V, size=int(n)) for n in r.integers(1, 9, size=n_docs)], V


# ---------------------------------------------------------------------------
# deterministic pieces, exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad_to", [None, 64])
def test_variadic_dataview_and_token_data_match_jax(pad_to):
    rows, _ = _ragged(0)
    view, jview = variadic_dataview(rows, pad_to=pad_to, device="cpu"), j_variadic(rows, pad_to=pad_to)
    assert len(view) == view.size() == jview.size() == len(rows)
    for name in ("tokens", "row_ptr", "token_mask", "doc_ids"):
        np.testing.assert_array_equal(getattr(view, name).numpy(), np.asarray(getattr(jview, name)), err_msg=name)
    assert [view.rowsize(i) for i in range(len(rows))] == [jview.rowsize(i) for i in range(len(rows))]
    for a, b, r in zip(view.toarray(), jview.toarray(), rows):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)
    data, jdata = topic.token_data(view), jtopic.token_data(jview)
    assert data.words.dtype == data.doc_ids.dtype == torch.int64 and data.mask.dtype == torch.float32
    for got, want in zip(data, jdata):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="pad_to"):
        variadic_dataview(rows, pad_to=3, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        variadic_dataview([], device="cpu")


def test_counts_match_jax_exactly():
    rows, V = _ragged(1)
    view, jview = variadic_dataview(rows, pad_to=48, device="cpu"), j_variadic(rows, pad_to=48)
    data, jdata = topic.token_data(view), jtopic.token_data(jview)
    K, D = 5, len(rows)
    z = np.random.default_rng(2).integers(0, K, size=48).astype(np.int32)
    got = hdp._counts(torch.from_numpy(z), data, D, K, V)
    want = jtopic.hdp._counts(jnp.asarray(z), jdata, D, K, V)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_densify_and_dense_token_data_match_jax():
    rows = [np.array([3, 1, 4]), np.array([1, 5]), np.array([9, 2, 6, 5])]
    view, jview = variadic_dataview(rows, device="cpu"), j_variadic(rows)
    for max_len in (None, 3):
        (w, m), (jw, jm) = topic.densify_corpus(view, max_len), jtopic.densify_corpus(jview, max_len)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        for got, want in zip(topic.dense_token_data(w, m), jtopic.dense_token_data(jw, jm)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert topic.densify_corpus(view, 3)[0].shape == (3, 3) and float(m.sum()) == 8
    # a padded view densifies to the same corpus (its padding slots are dropped)
    w_pad, m_pad = topic.densify_corpus(variadic_dataview(rows, pad_to=20, device="cpu"))
    np.testing.assert_array_equal(w_pad.numpy(), topic.densify_corpus(view)[0].numpy())
    np.testing.assert_array_equal(m_pad.numpy(), topic.densify_corpus(view)[1].numpy())
    # the bridge: a dense sweep over the densified corpus counts its 9 tokens
    w, m = topic.densify_corpus(view)
    s = topic.initialize(topic.dense_token_data(w, m), 2, 10, _gen(0), n_docs=3)
    s2 = topic.blocked_sweep_dense(s, w, m, _gen(1))
    assert float(s2.topic_total.sum()) == 9 and float(s2.doc_topic.sum()) == 9


def _f64_state(seed, n_docs=6, V=9, K=4):
    """A JAX HDPState in float64 over a ragged corpus (x64 must be on)."""
    r = np.random.default_rng(seed)
    rows = [r.integers(0, V, size=int(n)) for n in r.integers(2, 8, size=n_docs)]
    jview = j_variadic(rows, pad_to=sum(len(x) for x in rows) + 3)
    jdata = jtopic.token_data(jview)
    z = r.integers(0, K, size=jdata.words.shape[0]).astype(np.int32)
    dk, kw, kt = (np.asarray(a, np.float64) for a in jtopic.hdp._counts(jnp.asarray(z), jdata, n_docs, K, V))
    beta = r.dirichlet(np.ones(K + 1))
    js = jtopic.HDPState(z=jnp.asarray(z), beta=jnp.asarray(beta), doc_topic=jnp.asarray(dk),
                         topic_word=jnp.asarray(kw), topic_total=jnp.asarray(kt),
                         hypers={"alpha": jnp.asarray(0.7), "gamma": jnp.asarray(1.3), "eta": jnp.asarray(0.2)})
    return rows, jview, js


def test_score_joint_and_perplexity_match_jax_in_float64():
    with jax.enable_x64(True):
        rows, jview, js = _f64_state(3)
        jdata = jtopic.token_data(jview)
        jdata = jtopic.TokenData(jdata.words, jdata.doc_ids, jdata.mask.astype(jnp.float64))
        want_score, want_ppl = float(jtopic.score_joint(js)), float(jtopic.perplexity(js, jdata))
        leaves = _jleaves(js)
    s = convert.hdp_from_numpy(leaves, device="cpu")
    assert s.doc_topic.dtype == torch.float64 and s.z.dtype == torch.int32
    data = topic.token_data(variadic_dataview(rows, pad_to=int(jview.tokens.shape[0]), device="cpu"))
    data = data._replace(mask=data.mask.double())
    np.testing.assert_allclose(float(topic.score_joint(s)), want_score, **F64)
    np.testing.assert_allclose(float(topic.perplexity(s, data)), want_ppl, **F64)
    back = convert.hdp_to_numpy(s)
    for k in ("z", "beta", "doc_topic", "topic_word", "topic_total"):
        assert back[k].dtype == leaves[k].dtype
        np.testing.assert_array_equal(back[k], leaves[k])
    assert s.active_topics() == int((leaves["topic_total"] > 0).sum())
    assert (s.n_topics, s.n_docs, s.vocab_size) == (4, 6, 9)


# ---------------------------------------------------------------------------
# samplers against the oracles of tests/test_hdp.py
# ---------------------------------------------------------------------------
def _state_with_z(state, data, z):
    z = torch.as_tensor(np.asarray(z), dtype=torch.int32)
    dk, kw, kt = hdp._counts(z, data, state.n_docs, state.n_topics, state.vocab_size)
    return dataclasses.replace(state, z=z, doc_topic=dk, topic_word=kw, topic_total=kt)


def _exact_z_dist(jdata, K, n_docs):
    """{z: p} over all K^6 assignments of the six tokens, beta fixed at
    (0.5, 0.3, 0.2), alpha 0.8, eta 0.5: the JAX package's enumeration."""
    js = jtopic.initialize(jdata, K, 2, jax.random.key(0), alpha=0.8, eta=0.5, n_docs=n_docs)
    js = dataclasses.replace(js, beta=jnp.asarray([0.5, 0.3, 0.2]))
    combos, scores = [], []
    for z in itertools.product(range(K), repeat=6):
        dk, kw, kt = jtopic.hdp._counts(jnp.asarray(z, jnp.int32), jdata, n_docs, K, 2)
        s = dataclasses.replace(js, z=jnp.asarray(z, jnp.int32), doc_topic=dk, topic_word=kw, topic_total=kt)
        combos.append(z)
        scores.append(float(jtopic.score_joint(s)))
    return dict(zip(combos, np.exp(np.asarray(scores) - sp_logsumexp(scores))))


SWEEPS = {
    "collapsed": lambda s, data, words, mask, g: topic.collapsed_sweep(s, data, g),
    "blocked": lambda s, data, words, mask, g: topic.blocked_sweep(s, data, g),
    "blocked_chunked": lambda s, data, words, mask, g: topic.blocked_sweep(s, data, g, chunk=4),
    "dense_chunked": lambda s, data, words, mask, g: topic.blocked_sweep_dense(s, words, mask, g, doc_chunk=1),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_z_enumeration(name):
    """tests/test_hdp.py's tiny corpus (2 docs x 3 tokens, V=2, K=2): the
    chain's stationary distribution over the six tokens' z matches
    enumeration, beta fixed. The chunked flat sweep runs 6 tokens in chunks
    of 4, the dense one a doc a chunk."""
    K, sweep = 2, SWEEPS[name]
    words = torch.tensor([[0, 0, 1], [1, 1, 0]])
    mask = torch.ones((2, 3))
    data = topic.dense_token_data(words, mask)
    exact = _exact_z_dist(jtopic.dense_token_data(jnp.asarray(words.numpy()), jnp.ones((2, 3))), K, 2)
    state = topic.initialize(data, K, 2, _gen(0), alpha=0.8, eta=0.5, n_docs=2)
    state = dataclasses.replace(state, beta=torch.tensor([0.5, 0.3, 0.2]))
    calls = []

    def sample_fn(n):
        calls.append(n)
        g = _gen(100 + len(calls))
        s = _state_with_z(state, data, torch.randint(0, K, (6,), generator=g))
        out = []
        for i in range(n + 100):
            s = sweep(s, data, words, mask, g)
            if i >= 100:
                out.append(tuple(s.z.tolist()))
        return out

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.05)


def test_crt_matches_stirling_pmf_and_edge_cases():
    """CRT(5, a): P(m) = |s(5,m)| a^m / (a)_5, over 12,000 draws; zero
    counts give no table, one customer exactly one."""
    n, a = 5, 1.3
    pmf = np.array([24.0, 50.0, 35.0, 10.0, 1.0]) * a ** np.arange(1, 6)
    pmf /= pmf.sum()
    m = topic.crt_sample(_gen(0), torch.full((12000,), n), torch.tensor(a), n).numpy()
    freq = np.bincount(m, minlength=6)[1:6] / len(m)
    assert np.abs(freq - pmf).max() < 0.01, (freq, pmf)
    m = topic.crt_sample(_gen(1), torch.tensor([0, 1, 3]), torch.tensor(2.0), 3).numpy()
    assert m[0] == 0 and m[1] == 1 and 1 <= m[2] <= 3
    assert topic.crt_sample(_gen(2), torch.tensor([4.0, 2.0]), 0.5, 4).dtype == torch.int32


def _tiny_state(K=4):
    data = topic.token_data(variadic_dataview([np.array([0, 0, 1]), np.array([1, 1, 0])], device="cpu"))
    return data, topic.initialize(data, K, 2, _gen(0), n_docs=2)


def test_sample_beta_tracks_table_mass():
    """Topics with many tables get large beta; dead topics get little."""
    data, state = _tiny_state()
    state = _state_with_z(state, data, np.zeros(6, np.int32))  # all six tokens on topic 0
    g = _gen(1)
    betas = torch.stack([topic.sample_beta(state, g).beta for _ in range(200)])
    mean_beta = betas.mean(0).numpy()
    assert mean_beta[0] > 0.5, mean_beta
    assert mean_beta[1:4].max() < 0.2, mean_beta
    assert (betas > 0).all() and torch.allclose(betas.sum(-1), torch.ones(200))


def _quadrature_moments(logp, grid):
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = float((grid * w).sum())
    return mean, float(((grid - mean) ** 2 * w).sum())


def test_concentration_resampling_matches_quadrature():
    """tests/test_hdp.py's case: every doc-topic count is 0 or 1, so the
    CRT table counts are deterministic (m_dk == doc_topic) and the alpha and
    gamma conditionals have closed forms; 8000 moves, the first 2000 dropped."""
    D, K, V = 8, 6, 5
    a, b = 1.5, 0.5
    dt = np.zeros((D, K), np.float32)
    for d in range(D):
        dt[d, [d % K, (d + 1) % K, (d + 2) % K]] = 1.0
    n_d, m_tot, kplus = 3.0, float(dt.sum()), K
    state = topic.HDPState(
        z=torch.zeros(int(m_tot), dtype=torch.int32), beta=torch.full((K + 1,), 1.0 / (K + 1)),
        doc_topic=torch.from_numpy(dt), topic_word=torch.zeros((K, V)), topic_total=torch.from_numpy(dt.sum(0)),
        hypers={"alpha": torch.tensor(1.0), "gamma": torch.tensor(1.0), "eta": torch.tensor(0.1)})
    g, draws = _gen(1), []
    for _ in range(8000):
        state = hdp._sample_concentrations(state, g, 1, a, b, a, b)
        draws.append(torch.stack([state.hypers["alpha"], state.hypers["gamma"]]))
    alphas, gammas = torch.stack(draws)[2000:].double().numpy().T
    grid = np.linspace(1e-3, 60, 60001)
    logp_a = (a - 1) * np.log(grid) - b * grid + m_tot * np.log(grid) + D * (sgammaln(grid) - sgammaln(grid + n_d))
    logp_g = (a - 1) * np.log(grid) - b * grid + kplus * np.log(grid) + sgammaln(grid) - sgammaln(grid + m_tot)
    for draws_, logp in ((alphas, logp_a), (gammas, logp_g)):
        mean, var = _quadrature_moments(logp, grid)
        assert abs(draws_.mean() - mean) < 0.25 * np.sqrt(var), (draws_.mean(), mean)
        assert abs(draws_.var() / var - 1.0) < 0.35, (draws_.var(), var)


def test_theta_draw_has_beta_marginals_and_no_nan():
    """`_draw_phi_theta`'s theta rows are Dirichlet(n_d + alpha beta): each
    coordinate a Beta(a_k, a_0 - a_k) (KS test, p > 1e-3, 4000 docs a row
    type). Concentrations of 0.05 (where a plain float32 gamma draw
    underflows to 0 about 1% of the time) pass the same test; at 1e-12, and
    for a document with no valid token, the rows still sum to 1, without
    NaN, with the tiny coordinates 0."""
    n, K, V = 4000, 3, 4
    # alpha = 1; beta_1:3 = (0.05, 1e-12, 1e-12)
    beta = torch.tensor([0.05, 1e-12, 1e-12, 1.0 - 0.05 - 2e-12])
    rows = {"moderate": [0.0, 2.0, 5.0], "small": [0.0, 0.05, 1.0], "tiny": [3.0, 0.0, 0.0], "empty": [0.0, 0.0, 0.0]}
    dt = torch.tensor([r for r in rows.values() for _ in range(n)])
    # the "small" row's coordinates 2 and 3 get conc 0.05 + 1e-12 and 1 + 1e-12
    dt[n:2 * n, 1] = 0.05 - 1e-12
    state = topic.HDPState(z=torch.zeros(1, dtype=torch.int32), beta=beta, doc_topic=dt,
                           topic_word=torch.tensor([[5.0, 0, 0, 1], [0, 0, 0, 0], [2, 2, 2, 2]]),
                           topic_total=torch.tensor([6.0, 0, 8]),
                           hypers={"alpha": torch.tensor(1.0), "gamma": torch.tensor(1.0), "eta": torch.tensor(0.1)})
    phi, theta = hdp._draw_phi_theta(state, _gen(3))
    assert torch.isfinite(theta).all() and torch.isfinite(phi).all()
    assert torch.allclose(theta.sum(-1), torch.ones(4 * n), atol=1e-6)
    assert torch.allclose(phi.sum(-1), torch.ones(K), atol=1e-6)
    conc = (dt + beta[:K][None, :]).double().numpy()
    for i, name in enumerate(("moderate", "small")):
        block, c = theta[i * n:(i + 1) * n].double().numpy(), conc[i * n]
        for k in range(K):
            # a coordinate near 1 is tested through the sum of the others (float32
            # rounds 1 - 6e-8 to 1; near 0 it resolves far finer)
            a, b = c[k], c.sum() - c[k]
            x = block[:, k] if a <= b else block.sum(1) - block[:, k]
            p = sps.kstest(x, sps.beta(a, b).cdf if a <= b else sps.beta(b, a).cdf).pvalue
            assert p > 1e-3, (name, k, c, p)
    for i in (2, 3):  # tiny and empty rows: all mass on topic 0, whose conc dwarfs the rest
        block = theta[i * n:(i + 1) * n]
        assert (block[:, 0] == 1.0).all() and (block[:, 1:] == 0.0).all(), block[:3]
    # phi: topic 1 has no counts, so its row is Dirichlet(0.1, ...): finite, on the simplex
    assert (phi >= 0).all()


def test_masked_tokens_are_inert_in_the_dense_sweep():
    """Padding tokens keep their z and are in no count table."""
    r = np.random.default_rng(3)
    words = torch.from_numpy(r.integers(0, 10, (5, 4)))
    mask = torch.from_numpy((r.uniform(size=(5, 4)) < 0.7).astype(np.float32))
    data = topic.dense_token_data(words, mask)
    s = topic.initialize(data, 3, 10, _gen(0), n_docs=5)
    s2 = topic.blocked_sweep_dense(s, words, mask, _gen(1))
    z0, z1 = s.z.view(5, 4), s2.z.view(5, 4)
    assert torch.equal(z1[mask == 0], z0[mask == 0])
    assert float(s2.doc_topic.sum()) == float(s2.topic_word.sum()) == float(mask.sum())
    for got, want in zip(hdp._counts(s2.z, data, 5, 3, 10), (s2.doc_topic, s2.topic_word, s2.topic_total)):
        assert torch.equal(got, want)
    # and the flat sweeps: masked slots of a padded view keep their z
    view = variadic_dataview([np.array([1, 2]), np.array([3])], pad_to=7, device="cpu")
    fd = topic.token_data(view)
    s = topic.initialize(view, 3, 4, _gen(2))
    for out in (topic.blocked_sweep(s, fd, _gen(3)), topic.collapsed_sweep(s, fd, _gen(4))):
        assert torch.equal(out.z[3:], s.z[3:]) and float(out.topic_total.sum()) == 3


# ---------------------------------------------------------------------------
# the runner's HDP family
# ---------------------------------------------------------------------------
def _example_corpus():
    """examples/lda_topics.py's corpus: 200 docs x 30 tokens, V = 30, 3 blocks."""
    r = np.random.default_rng(1)
    return [r.choice(np.arange((d % 3) * 10, (d % 3 + 1) * 10), size=30) for d in range(200)], 30


def test_hdp_runner_family(tmp_path):
    rows, V = _example_corpus()
    rows = rows[:20]
    rows[3] = rows[3][:12]  # a short doc: the longest is 30
    view = variadic_dataview(rows, pad_to=600, device="cpu")
    data = topic.token_data(view)
    state = topic.initialize(view, 6, V, _gen(0))
    # the JAX runner's kernels, and the port's dense route (`assign_blocked_dense`,
    # held to blocked_sweep_dense in tests/test_torch_hdp_reference.py)
    assert set(HDP_KERNELS) == set(jrunner._hdp_kernels()) | {"assign_blocked_dense"}
    jview = j_variadic(rows, pad_to=600)
    want = jrunner._family_of(jtopic.initialize(jview, 6, V, jax.random.key(0)))["default_kw"](
        jtopic.token_data(jview))
    assert want == {"max_count": 30}
    # the port's defaults add the dense route's doc length: None, this corpus is ragged
    assert _hdp_default_kw(data) == {**want, "doc_len": None}
    path = tmp_path / "sweeps.jsonl"
    run = runner(None, data, state, [("assign_blocked", {}), ("beta", {}), ("concentrations", {})],
                 jsonl_path=str(path))
    g = _gen(1)
    run.run(g, 3)
    out = run.run(g, 2)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["sweep"] for x in lines] == list(range(5))
    assert [x["ess"] is None for x in lines] == [True, True, True, True, False]
    np.testing.assert_array_equal([x["score_joint"] for x in lines], run.score_trace.astype(np.float64))
    assert all(sum(x["occupancy"]) == len(np.concatenate(rows)) for x in lines)
    assert run.assignment_trace.shape == (5, 600) and run.k_active_trace.shape == (5,)
    assert float(out.hypers["alpha"]) > 0 and float(out.hypers["gamma"]) > 0
    with pytest.raises(ValueError, match="kernel name"):
        runner(None, data, state, [("grid_feature_hp", {})])
    # saturation: every topic holds tokens and the remainder stick is spent
    full = _state_with_z(state, data, np.arange(600) % 6)
    full = dataclasses.replace(full, beta=torch.tensor([0.2, 0.2, 0.2, 0.2, 0.1, 0.0999, 1e-4]))
    with pytest.warns(RuntimeWarning, match="slots are occupied"):
        runner(None, data, full, [("assign", {})]).run(g, 1)
    # one empty topic: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        runner(None, data, _state_with_z(state, data, np.arange(600) % 5), [("beta", {})]).run(g, 1)


SEEDS, ITERS, K_EX = 8, 20, 10


def _summary(ppl, active, alpha):
    """[SEEDS, 3]: each chain's second-half means of perplexity, active topics, alpha."""
    return np.stack([np.asarray(x, np.float64)[:, ITERS // 2:].mean(1) for x in (ppl, active, alpha)], 1)


def test_runner_chains_agree_with_the_jax_runner():
    """[assign_blocked, concentrations] on the example corpus (K = 10, eta
    0.1) from one initial state made by the port: SEEDS chains of ITERS
    iterations in each package; the seed means of each chain's second-half
    perplexity, active topics and alpha agree within 3 combined standard
    errors (sqrt(se_port^2 + se_jax^2))."""
    rows, V = _example_corpus()
    view = variadic_dataview(rows, device="cpu")
    data = topic.token_data(view)
    s0 = topic.initialize(view, K_EX, V, _gen(0), eta=0.1)
    config = [("assign_blocked", {}), ("concentrations", {})]
    port = []
    for seed in range(SEEDS):
        run, g, track = runner(None, data, s0, config), _gen(100 + seed), []
        for _ in range(ITERS):
            s = run.run(g, 1, collect=False)
            track.append([float(topic.perplexity(s, data)), int(s.active_topics()), float(s.hypers["alpha"])])
        port.append(track)
    port = _summary(*np.asarray(port).transpose(2, 0, 1))

    leaves = convert.hdp_to_numpy(s0)
    js0 = jtopic.HDPState(**{k: jnp.asarray(v) for k, v in leaves.items() if k != "hypers"},
                          hypers={k: jnp.asarray(v) for k, v in leaves["hypers"].items()})
    jdata = jtopic.token_data(j_variadic(rows))
    step = jrunner.make_step(config, jdata, jrunner._family_of(js0))

    def chain(key):
        def body(s, t):
            s = step(s, jax.random.fold_in(key, t))
            return s, (jtopic.perplexity(s, jdata), s.active_topics(), s.hypers["alpha"])

        return jax.lax.scan(body, js0, jnp.arange(ITERS))[1]

    jx = _summary(*(np.asarray(t) for t in jax.jit(jax.vmap(chain))(jax.random.split(jax.random.key(7), SEEDS))))
    assert np.isfinite(port).all() and np.isfinite(jx).all()
    m_p, m_j = port.mean(0), jx.mean(0)
    se = np.sqrt(port.var(0, ddof=1) / SEEDS + jx.var(0, ddof=1) / SEEDS)
    report = {n: (round(a, 4), round(b, 4), round(c, 4)) for n, a, b, c in
              zip(("perplexity", "active", "alpha"), m_p, m_j, se)}
    assert (np.abs(m_p - m_j) <= 3 * se + 1e-9).all(), report
    # both learned the blocks: perplexity far below the initial state's
    assert m_p[0] < 0.6 * float(topic.perplexity(s0, data)), report


# ---------------------------------------------------------------------------
# utils/util and utils/profiling, on the CPU
# ---------------------------------------------------------------------------
def test_util_matches_jax():
    a = np.random.default_rng(4).normal(scale=20.0, size=(3, 5))
    np.testing.assert_allclose(float(util.logsumexp(a)), float(jutil.logsumexp(a)), rtol=1e-6)
    np.testing.assert_allclose(util.logsumexp(torch.from_numpy(a), axis=1).numpy(),
                               np.asarray(jutil.logsumexp(a, axis=1)), rtol=1e-6)
    assert util.almost_eq(torch.ones(3), np.ones(3) + 1e-7) and not util.almost_eq([1.0], [1.1])
    for n in (1, 4, 7):
        q = util.random_orthonormal_matrix(_gen(n), n, dtype=torch.float64)
        np.testing.assert_allclose((q.T @ q).numpy(), np.eye(n), atol=1e-12)
        # the sign fix: G = Q R' with R' = Q^T G upper triangular, positive diagonal
        r = q.T @ torch.randn((n, n), generator=_gen(n), dtype=torch.float64)
        assert (torch.diagonal(r) > 0).all() and torch.allclose(torch.tril(r, -1), torch.zeros(n, n, dtype=torch.float64), atol=1e-12)
    # Haar: the (0, 0) entry of a Haar 3x3 matrix has mean 0
    g = _gen(1000)
    first = torch.stack([util.random_orthonormal_matrix(g, 3)[0, 0] for _ in range(2000)])
    assert abs(float(first.mean())) < 4 * float(first.std()) / np.sqrt(2000)
    z = util.random_assignment_vector(_gen(5), 500, 4)
    assert z.dtype == torch.int32 and z.shape == (500,) and set(z.tolist()) == {0, 1, 2, 3}


def test_profiling_on_the_cpu(tmp_path):
    calls = []
    res = profiling.benchmark(lambda x: calls.append(x), 3, iters=4, warmup=2, device="cpu")
    assert calls == [3] * 6 and set(res) == {"mean_s", "min_s", "median_s", "iters_per_s"}
    assert 0 <= res["min_s"] <= res["median_s"] and res["iters_per_s"] > 0
    assert profiling.sweeps_per_second(lambda s: s, 1, iters=2, device="cpu") > 0
    assert profiling.device_memory_stats("cpu") == {}
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.recording(), profiling.span("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert any("matmul" in e.key for e in prof.key_averages())
    assert any(e.key == "matmul" for e in prof.key_averages())  # the span itself, not aten::matmul
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
