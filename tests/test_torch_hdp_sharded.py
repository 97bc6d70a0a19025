"""The port's token- and doc-sharded HDP sweeps and the mesh hyper moves
(`common_tpu_torch/topic/hdp.py`) against the one-device sweeps and the
JAX package.

Ranks are CPU processes over gloo, spawned with `torch.multiprocessing`
(`torch_dist_workers.py`, which imports no JAX), each spawn with its own
timeout. The checks of tests/test_hdp.py's sharded tests:

- at world size 1 each sharded sweep, and `sample_beta` and
  `sample_concentrations` with the mesh, equal their one-device versions
  bit for bit;
- after 30 sweeps on 2 ranks the count tables equal a recount of the
  gathered z (the port's `_counts`, and the JAX package's on the same
  numpy corpus, exactly: counts are integers in float32), the replicated
  leaves are bit-identical on both ranks, and perplexity is below 0.8 of a
  fresh start's;
- on 2 ranks each sweep's stationary distribution over the tiny corpus's
  z matches enumeration (KL < 0.05), as tests/test_torch_hdp.py holds the
  one-device sweeps;
- the mesh concentration move on 2 ranks matches quadrature with the
  one-device test's bars, its beta move the Dirichlet mean within 0.01,
  both ranks drawing the same values;
- tokens or docs that do not divide over the data ranks raise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln as sgammaln

import torch_dist_workers as W
from common_tpu import testutil
from common_tpu import topic as jtopic
from common_tpu.data.variadic import variadic_dataview as j_variadic
from common_tpu_torch import topic
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.topic import hdp

from test_torch_hdp import _exact_z_dist, _quadrature_moments

torch.set_num_threads(2)

LEAVES = ("z", "doc_topic", "topic_word", "topic_total", "beta")


def _equal_states(a, b):
    for f in LEAVES:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for k in a.hypers:
        assert torch.equal(a.hypers[k], b.hypers[k]), k


@pytest.mark.parametrize("layout", ["tokens", "dense"])
def test_world_size_one_equals_the_one_device_sweep(layout):
    """At world size 1 the all_reduce is the identity and the rank's stream
    the chain's generator: 3 sharded sweeps (chunked), each followed by the
    mesh forms of `sample_concentrations` and `sample_beta` with their
    default max_count, equal the one-device calls bit for bit."""
    corpus, state = W.hdp_layout(layout, 1)
    g_sharded, g_one = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    one = state
    with W.one_process_group() as mesh:
        if layout == "tokens":
            s, d = topic.shard_corpus(mesh, state, corpus)
            sweep = topic.make_sharded_sweep(mesh, s, d)
            step = lambda s: sweep(s, d, g_sharded, chunk=100)  # noqa: E731
            step_one = lambda s: topic.blocked_sweep(s, corpus, g_one, chunk=100)  # noqa: E731
        else:
            s, w, m = topic.shard_dense_corpus(mesh, state, *corpus)
            sweep = topic.make_sharded_sweep_dense(mesh, s, w, m)
            step = lambda s: sweep(s, w, m, g_sharded, doc_chunk=7)  # noqa: E731
            step_one = lambda s: topic.blocked_sweep_dense(s, *corpus, g_one, doc_chunk=7)  # noqa: E731
        for _ in range(3):
            s, one = step(s), step_one(one)
            _equal_states(s, one)
            s = topic.sample_concentrations(s, g_sharded, mesh=mesh)
            one = topic.sample_concentrations(one, g_one)
            s, one = topic.sample_beta(s, g_sharded, mesh=mesh), topic.sample_beta(one, g_one)
            _equal_states(s, one)
    assert torch.equal(g_sharded.get_state(), g_one.get_state())


@pytest.mark.parametrize("layout", ["tokens", "dense"])
def test_two_ranks_keep_the_counts_and_lower_perplexity(tmp_path, layout):
    """tests/test_hdp.py:190 on 2 ranks (40 docs x 24 tokens, K = 8): after
    30 sweeps and beta moves the tables equal the port's and the JAX
    package's recount of the gathered z; every replicated leaf is
    bit-identical on both ranks; the ranks' shards concatenate to the
    corpus; perplexity falls below 0.8 of a fresh start's."""
    out = str(tmp_path / layout)
    W.spawn(W.hdp_sharded_checks, 2, tmp_path, layout, out)
    res = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(2)]
    corpus, state = W.hdp_layout(layout, 2)
    rows, V = W.hdp_corpus()
    K, D = state.n_topics, len(rows)
    z = np.concatenate([r["z"] for r in res])
    replicated = ["topic_word", "topic_total", "beta", "alpha", "gamma", "gen_state"]
    if layout == "tokens":
        replicated.append("doc_topic")
        data, jdata = corpus, jtopic.token_data(j_variadic(rows, pad_to=corpus.words.shape[0]))
        for name, whole in zip(("words", "doc_ids", "mask"), jdata):
            np.testing.assert_array_equal(np.concatenate([r[name] for r in res]), np.asarray(whole))
        doc_topic = res[0]["doc_topic"]
    else:
        words, mask = corpus
        data = topic.dense_token_data(words, mask)
        jdata = jtopic.dense_token_data(jnp.asarray(words.numpy()), jnp.asarray(mask.numpy()))
        np.testing.assert_array_equal(np.concatenate([r["words"] for r in res]), words.numpy())
        np.testing.assert_array_equal(np.concatenate([r["mask"] for r in res]), mask.numpy())
        doc_topic = np.concatenate([r["doc_topic"] for r in res])
    for name in replicated:
        np.testing.assert_array_equal(res[0][name], res[1][name], err_msg=name)
    tables = (doc_topic, res[0]["topic_word"], res[0]["topic_total"])
    for got, port, jax_ in zip(tables, hdp._counts(torch.from_numpy(z), data, D, K, V),
                               jtopic.hdp._counts(jnp.asarray(z), jdata, D, K, V)):
        np.testing.assert_array_equal(got, port.numpy())
        np.testing.assert_array_equal(got, np.asarray(jax_))
    assert float(tables[2].sum()) == float(data.mask.sum())
    final = dataclasses.replace(
        state, z=torch.from_numpy(z), doc_topic=torch.from_numpy(doc_topic),
        topic_word=torch.from_numpy(tables[1]), topic_total=torch.from_numpy(tables[2]),
        beta=torch.from_numpy(res[0]["beta"]),
        hypers={**state.hypers, "alpha": torch.from_numpy(res[0]["alpha"]),
                "gamma": torch.from_numpy(res[0]["gamma"])})
    fresh = topic.initialize(data, K, V, torch.Generator().manual_seed(9), eta=0.1, n_docs=D)
    ppl, ppl0 = float(topic.perplexity(final, data)), float(topic.perplexity(fresh, data))
    assert ppl < 0.8 * ppl0, (ppl, ppl0)


@pytest.mark.parametrize("layout", ["tokens", "dense"])
def test_two_ranks_match_z_enumeration(tmp_path, layout):
    """tests/test_hdp.py:380 (tokens, the 6 tokens padded to 8, 4 a rank)
    and :500 (dense, one doc a rank) on 2 ranks: the chain's distribution
    over the six tokens' z matches enumeration with beta fixed, KL < 0.05
    at 3000 samples past 100 sweeps of burn-in."""
    _, data, _ = W.hdp_tiny(layout)
    real = data.mask.numpy() > 0
    exact = _exact_z_dist(jtopic.dense_token_data(jnp.asarray([[0, 0, 1], [1, 1, 0]]), jnp.ones((2, 3))), 2, 2)
    cache = {}

    def sample_fn(n):
        if n not in cache:
            out = str(tmp_path / f"oracle{len(cache)}")
            z0 = np.zeros(len(real), np.int32)
            z0[real] = np.random.default_rng(len(cache) + 3).integers(0, 2, real.sum())
            W.spawn(W.hdp_oracle_samples, 2, tmp_path, layout, out, z0, n + 100, 40 + len(cache))
            zs = np.concatenate([np.load(f"{out}.{rank}.npy") for rank in range(2)], axis=1)
            cache[n] = [tuple(int(v) for v in z[real]) for z in zs[100:]]
        return cache[n]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.05)


def test_mesh_hyper_moves_on_two_ranks(tmp_path):
    """`sample_concentrations` and `sample_beta` with the mesh on 2 ranks,
    4 docs each of tests/test_torch_hdp.py's quadrature state: both ranks
    draw the same alpha, gamma and beta and end with the same generator;
    alpha and gamma over 8000 moves (the first 2000 dropped) match
    quadrature with that test's bars; beta over 2000 moves has the mean of
    Dir(m_k + 1e-8, gamma) within 0.01 in every coordinate."""
    a, b = 1.5, 0.5
    out = str(tmp_path / "hyper")
    W.spawn(W.hdp_hyper_moves, 2, tmp_path, out, 8000, 2000, a, b)
    res = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(2)]
    for name in ("hypers", "betas", "gen_state"):
        np.testing.assert_array_equal(res[0][name], res[1][name], err_msg=name)
    state = W.hdp_quadrature_state()
    D, K = state.doc_topic.shape
    n_d, m_k = 3.0, state.doc_topic.sum(0).double().numpy()
    m_tot = float(m_k.sum())
    alphas, gammas = res[0]["hypers"][2000:].astype(np.float64).T
    grid = np.linspace(1e-3, 60, 60001)
    logp_a = (a - 1) * np.log(grid) - b * grid + m_tot * np.log(grid) + D * (sgammaln(grid) - sgammaln(grid + n_d))
    logp_g = (a - 1) * np.log(grid) - b * grid + K * np.log(grid) + sgammaln(grid) - sgammaln(grid + m_tot)
    for draws, logp in ((alphas, logp_a), (gammas, logp_g)):
        mean, var = _quadrature_moments(logp, grid)
        assert abs(draws.mean() - mean) < 0.25 * np.sqrt(var), (draws.mean(), mean)
        assert abs(draws.var() / var - 1.0) < 0.35, (draws.var(), var)
    gamma = float(res[0]["hypers"][-1, 1])
    conc = np.concatenate([m_k + 1e-8, [gamma]])
    np.testing.assert_allclose(res[0]["betas"].mean(0), conc / conc.sum(), atol=0.01)


def test_uneven_shards_and_mismatched_states_raise():
    """Tokens or docs that do not divide over the data ranks raise
    ValueError, as in the JAX package; so does a sweep built for a state
    whose z does not match the corpus shard."""
    fake = mesh_mod.Mesh((1, 2), 0, 1, None, torch.device("cpu"))
    _, data, state = W.hdp_tiny("tokens")
    short = topic.TokenData(*(t[:7] for t in data))
    with pytest.raises(ValueError, match="must divide"):
        topic.shard_corpus(fake, dataclasses.replace(state, z=state.z[:7]), short)
    words = torch.zeros((3, 4), dtype=torch.int64)
    s3 = topic.initialize(topic.dense_token_data(words), 2, 2, torch.Generator().manual_seed(0), n_docs=3)
    with pytest.raises(ValueError, match="must divide"):
        topic.shard_dense_corpus(fake, s3, words, torch.ones((3, 4)))
    # rank 1 of 2 keeps docs 1 and tokens 4-7, and every replicated leaf whole
    (corpus, _, dense_state) = W.hdp_tiny("dense")
    s, w, m = topic.shard_dense_corpus(fake, dense_state, *corpus)
    assert torch.equal(w, corpus[0][1:]) and torch.equal(s.z, dense_state.z[3:])
    assert torch.equal(s.doc_topic, dense_state.doc_topic[1:]) and torch.equal(s.topic_word, dense_state.topic_word)
    s, d = topic.shard_corpus(fake, state, data)
    assert torch.equal(d.words, data.words[4:]) and torch.equal(s.doc_topic, state.doc_topic)
    with W.one_process_group() as mesh:
        with pytest.raises(ValueError, match="tokens"):
            topic.make_sharded_sweep(mesh, dataclasses.replace(state, z=state.z[:5]), data)
        with pytest.raises(ValueError, match="docs"):
            topic.make_sharded_sweep_dense(mesh, s3, words[:2], torch.ones((2, 4)))
