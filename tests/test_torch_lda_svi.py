"""The port's online variational LDA (`topic/svi.py`) against the JAX package.

The fits are deterministic given the posterior, so one `LDAPosterior`, made
by the JAX package's `init` under `jax.enable_x64` and carried across as
numpy leaves (`convert.lda_from_numpy`), goes through both packages in
float64: `_dir_elog`, a `step` at a fixed rho < 1, `bound` (with and
without total_docs), `perplexity` and the bound trace of 5 `fit_cavi` steps
agree to rtol 1e-6; `doc_term_matrix` agrees exactly. The behaviour tests
of tests/test_lda_svi.py follow for the port: the bound never falls under
CAVI and the blocks are recovered, minibatch SVI improves held-out
perplexity, and the validators raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu.data.variadic import variadic_dataview as j_variadic
from common_tpu.topic import svi as jlda
from common_tpu_torch import convert, rng
from common_tpu_torch.data import variadic_dataview
from common_tpu_torch.topic import svi as lda

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=0)


def _gen(seed):
    return rng(seed, "cpu").generator


def _block_corpus(n_docs=120, doc_len=40, kb=3, v_per=8, seed=0):
    """tests/test_lda_svi.py's corpus: doc d draws from vocab block d % kb."""
    r = np.random.default_rng(seed)
    V = kb * v_per
    rows, truth = [], []
    for d in range(n_docs):
        t = d % kb
        truth.append(t)
        rows.append(r.choice(np.arange(t * v_per, (t + 1) * v_per), size=doc_len))
    return rows, np.array(truth), V


def test_doc_term_matrix_matches_jax():
    r = np.random.default_rng(1)
    rows = [r.integers(0, 9, size=int(n)) for n in r.integers(1, 7, size=6)]
    for pad_to in (None, 40):
        view, jview = variadic_dataview(rows, pad_to=pad_to, device="cpu"), j_variadic(rows, pad_to=pad_to)
        for n_docs in (None, 6, 4):
            got, want = lda.doc_term_matrix(view, 9, n_docs), np.asarray(jlda.doc_term_matrix(jview, 9, n_docs))
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    # padding slots carry doc id 6, so by default they add an empty row, as in JAX
    assert lda.doc_term_matrix(variadic_dataview(rows, pad_to=40, device="cpu"), 9).shape == (7, 9)
    counts = lda.doc_term_matrix(variadic_dataview(rows, device="cpu"), 9).numpy()
    for d, row in enumerate(rows):
        np.testing.assert_array_equal(counts[d], np.bincount(row, minlength=9))


def _jax_post_and_counts(n_docs=30, K=4):
    """A float64 JAX posterior and count block (x64 must be on)."""
    rows, _, V = _block_corpus(n_docs=n_docs, doc_len=15, seed=2)
    counts = np.asarray(jlda.doc_term_matrix(j_variadic(rows), V), np.float64)
    jpost = jlda.init(K, V, jax.random.key(0), alpha=0.5, eta=0.1)
    jpost = jlda.LDAPosterior(lam=jpost.lam.astype(jnp.float64), alpha=jpost.alpha.astype(jnp.float64),
                              eta=jpost.eta.astype(jnp.float64))
    return jpost, counts


def _leaves(jpost):
    return {"lam": np.asarray(jpost.lam), "alpha": np.asarray(jpost.alpha), "eta": np.asarray(jpost.eta)}


def test_deterministic_pieces_match_jax_in_float64():
    with jax.enable_x64(True):
        jpost, counts = _jax_post_and_counts()
        jc = jnp.asarray(counts)
        want = {
            "elog": np.asarray(jlda._dir_elog(jpost.lam)),
            "gamma": np.asarray(jlda._e_step(jlda._dir_elog(jpost.lam), jc, jpost.alpha, 25)[0]),
            "step": np.asarray(jlda.step(jpost, jc[:10], 300, 0.3, n_inner=7).lam),
            "bound": float(jlda.bound(jpost, jc)),
            "bound_scaled": float(jlda.bound(jpost, jc[:10], total_docs=300, n_inner=9)),
            "perplexity": float(jlda.perplexity(jpost, jc)),
        }
        jfit, jtrace = jlda.fit_cavi(jpost, jc, n_iters=5)
        want["cavi_lam"], want["cavi_trace"] = np.asarray(jfit.lam), np.asarray(jtrace)
        leaves = _leaves(jpost)
    post = convert.lda_from_numpy(leaves, device="cpu")
    c = torch.from_numpy(counts)
    assert post.lam.dtype == torch.float64 and (post.n_topics, post.vocab_size) == leaves["lam"].shape
    np.testing.assert_allclose(lda._dir_elog(post.lam).numpy(), want["elog"], **TOL)
    np.testing.assert_allclose(lda._e_step(lda._dir_elog(post.lam), c, post.alpha, 25)[0].numpy(),
                               want["gamma"], **TOL)
    np.testing.assert_allclose(lda.step(post, c[:10], 300, 0.3, n_inner=7).lam.numpy(), want["step"], **TOL)
    np.testing.assert_allclose(float(lda.bound(post, c)), want["bound"], **TOL)
    np.testing.assert_allclose(float(lda.bound(post, c[:10], total_docs=300, n_inner=9)),
                               want["bound_scaled"], **TOL)
    np.testing.assert_allclose(float(lda.perplexity(post, c)), want["perplexity"], **TOL)
    fit, trace = lda.fit_cavi(post, c, n_iters=5)
    assert trace.shape == (5,)
    np.testing.assert_allclose(trace.numpy(), want["cavi_trace"], **TOL)
    np.testing.assert_allclose(fit.lam.numpy(), want["cavi_lam"], **TOL)
    np.testing.assert_allclose(fit.topics().sum(-1).numpy(), np.ones(4), rtol=1e-12)
    back = convert.lda_to_numpy(post)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_cavi_bound_ascends_and_recovers_topics():
    rows, truth, V = _block_corpus()
    counts = lda.doc_term_matrix(variadic_dataview(rows, device="cpu"), V).double()
    post = lda.init(6, V, _gen(0), alpha=0.5, eta=0.1)
    post = lda.LDAPosterior(post.lam.double(), post.alpha.double(), post.eta.double())
    post, bounds = lda.fit_cavi(post, counts, n_iters=30)
    bounds = bounds.numpy()
    assert np.isfinite(bounds).all() and bounds[-1] > bounds[0]
    assert (np.diff(bounds) > -1e-5 * np.abs(bounds[:-1])).all(), bounds
    # each true vocab block is owned by some topic
    topics = post.topics().numpy()
    big = post.lam.sum(-1).numpy() > V  # topics with real mass
    blocks = topics[big].reshape(big.sum(), 3, -1).sum(axis=-1)
    assert (blocks.max(axis=1) > 0.9).all()
    # mapped doc accuracy via gamma from one E-step
    gamma, _ = lda._e_step(lda._dir_elog(post.lam), counts, post.alpha, 25)
    zhat = gamma.argmax(-1).numpy()
    mapping = {k: np.bincount(truth[zhat == k]).argmax() for k in np.unique(zhat)}
    assert np.mean([mapping[z] == t for z, t in zip(zhat, truth)]) > 0.95


def test_minibatch_svi_improves_heldout():
    rows, _, V = _block_corpus(n_docs=200, doc_len=30, seed=1)
    counts = lda.doc_term_matrix(variadic_dataview(rows, device="cpu"), V)
    train, test = counts[:160], counts[160:]
    post = lda.init(6, V, _gen(0), alpha=0.5, eta=0.1)
    ppl0 = float(lda.perplexity(post, test))
    post = lda.fit_svi(post, train, _gen(1), n_iters=200, batch_size=16)
    ppl1 = float(lda.perplexity(post, test))
    assert ppl1 < 0.6 * ppl0, (ppl0, ppl1)
    assert ppl1 < 0.7 * V, ppl1  # much better than uniform over the vocab


def test_validators_raise_as_jax_does():
    rows, _, V = _block_corpus(n_docs=8, doc_len=5)
    counts = lda.doc_term_matrix(variadic_dataview(rows, device="cpu"), V)
    jcounts = jlda.doc_term_matrix(j_variadic(rows), V)
    for k, v in ((0, 10), (3, 0)):
        with pytest.raises(ValueError):
            lda.init(k, v, _gen(0))
        with pytest.raises(ValueError):
            jlda.init(k, v, jax.random.key(0))
    post, jpost = lda.init(4, V, _gen(0)), jlda.init(4, V, jax.random.key(0))
    for kappa in (0.3, 1.0):
        with pytest.raises(ValueError, match="kappa"):
            lda.fit_svi(post, counts, _gen(1), 5, 4, kappa=kappa)
        with pytest.raises(ValueError, match="kappa"):
            jlda.fit_svi(jpost, jcounts, jax.random.key(1), 5, 4, kappa=kappa)
    # init's draw: Gamma(100, 100), mean 1 and sd 0.1
    lam = lda.init(8, 500, _gen(2)).lam
    assert abs(float(lam.mean()) - 1.0) < 0.01 and abs(float(lam.std()) - 0.1) < 0.01
