"""The port's HDP-LDA (`topic/hdp.py`) and its dense runner route against the
benchmark's float64 reference (`benchmark/reference/hdp.py`), on seeded small
corpora on the CPU.

The reference is written from Teh et al. (2006) §5.3 and shares no code with
the port. Counts must agree exactly; the joint score within 1e-6 relative
(the port scores in float32: each lgamma term carries about 6e-8 of relative
rounding, and a few hundred of them partly cancel); the dense sweep's draw
of z given phi and theta is held to the reference's conditional by the
exact-enumeration oracle (`testutil.assert_discrete_dist_approx`, KL < 0.05
over growing samples); the CRT's table counts to their exact mean and
variance (within 4.5 standard errors of the mean over 4,000 draws), and beta's
Dirichlet draw to its parameters. One runner
step of `[assign_blocked_dense, beta]` equals `blocked_sweep_dense` +
`sample_beta` on the same generator bit for bit, its host trace keeps a
byte a token and reads back as each sweep's int32 z, and `make_step` refuses
a corpus that is not doc-major and rectangular. Last, the reference's own
statistics: the grouped Dirichlet and categorical fits read N(0, 1) for
exact draws, and the Dirichlet fit's variance is the closed form's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.reference import hdp as ref
from benchmark.reference.precision import REFERENCE
from common_tpu import testutil
from common_tpu_torch import rng, topic
from common_tpu_torch.data import variadic_dataview
from common_tpu_torch.runner import HDP_FAMILY, PackedZ, _hdp_default_kw, _pack_bits, make_step, runner
from common_tpu_torch.topic import hdp

D, L, V, K = 64, 12, 40, 6


def _gen(seed):
    return rng(seed, "cpu").generator


def _corpus(seed, held=0.1):
    """(words [D, L], mask [D, L], TokenData): doc d draws from vocabulary
    block d % 4 of 10 words, a share `held` of the positions masked."""
    g = torch.Generator().manual_seed(seed)
    words = (torch.arange(D) % 4)[:, None] * (V // 4) + torch.randint(0, V // 4, (D, L), generator=g)
    mask = (torch.rand((D, L), generator=g) >= held).float()
    return words, mask, topic.dense_token_data(words, mask)


def _state(seed, sweeps=2):
    """A state a few dense sweeps from a random start, its counts the port's."""
    words, mask, data = _corpus(seed)
    g = _gen(seed + 1)
    s = topic.initialize(data, K, V, g, alpha=1.3, eta=0.2, n_docs=D)
    for _ in range(sweeps):
        s = topic.sample_beta(topic.blocked_sweep_dense(s, words, mask, g, doc_chunk=16), g, max_count=L)
    return words, mask, data, s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_equal_the_references(seed):
    words, mask, data, s = _state(seed)
    z = torch.randint(0, K, (D * L,), generator=torch.Generator().manual_seed(seed), dtype=torch.int32)
    for zz in (s.z, z):
        want = ref.counts(zz, words, mask, K, V)
        got = hdp._counts(zz, data, D, K, V)
        for g, w in zip(got, want):
            assert torch.equal(g.to(torch.int64), w)
    for g, w in zip((s.doc_topic, s.topic_word, s.topic_total), ref.counts(s.z, words, mask, K, V)):
        assert torch.equal(g.to(torch.int64), w)
    assert int(ref.counts(s.z, words, mask, K, V)[0].sum()) == int(mask.sum())  # masked tokens in no table


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_joint_is_the_float64_references(seed):
    words, mask, data, s = _state(seed)
    n_dk, n_kw, _ = ref.counts(s.z, words, mask, K, V)
    want = ref.score_joint(n_dk, n_kw, s.hypers["alpha"], s.beta, s.hypers["eta"], REFERENCE)
    got = float(topic.score_joint(s))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_dense_assignment_draws_the_references_conditional():
    """Given one phi and theta, each token's z over many `_assign_docs` calls
    follows theta_dk phi_kw / sum_j theta_dj phi_jw (two tokens of two docs
    jointly, K^2 outcomes); a masked token keeps its z."""
    words, mask, data, s = _state(5)
    mask[3, 7] = 0.0
    phi, theta = hdp._draw_phi_theta(s, _gen(9))
    picks = [(0, 2), (41, 9)]  # (doc, position)
    probs = [ref.assign_probs(theta[d][None], phi[:, words[d, i]][None])[0].numpy() for d, i in picks]
    exact = {(a, b): float(probs[0][a] * probs[1][b]) for a in range(K) for b in range(K)}
    calls = []

    def sample_fn(n):
        calls.append(n)
        g = _gen(200 + len(calls))
        out = []
        for _ in range(n):
            z, _, _ = hdp._assign_docs(s, words, mask, phi, theta, g, 16)
            zz = z.view(D, L)
            assert zz[3, 7] == s.z.view(D, L)[3, 7]
            out.append(tuple(int(zz[d, i]) for d, i in picks))
        return out

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.05)


def test_crt_counts_have_the_exact_mean_and_variance():
    """m_k = sum_d CRT(n_dk, a_k) over 4,000 draws of `crt_sample`: the sample
    mean within 4.5 of its standard errors of the exact mean, the sample
    variance within 15 % of the exact variance (its relative standard error
    at 4,000 draws is about 2.2 %)."""
    g = torch.Generator().manual_seed(3)
    n_dk = torch.randint(0, 13, (D, K), generator=g) * (torch.rand((D, K), generator=g) < 0.6)
    conc = torch.tensor([1.3, 0.4, 0.05, 2.0, 1e-12, 0.7])
    mean, var = ref.crt_moments(n_dk, conc, L)
    gen = _gen(4)
    draws = torch.stack([hdp.crt_sample(gen, n_dk, conc[None, :], L).sum(0) for _ in range(4000)]).double()
    se = (var / 4000).sqrt()
    live = var > 0
    assert ((draws.mean(0) - mean)[live].abs() <= 4.5 * se[live]).all(), (draws.mean(0), mean)
    assert torch.allclose(draws.var(0)[live], var[live], rtol=0.15), (draws.var(0), var)
    assert torch.equal(draws[:, ~live], mean[~live].expand(4000, -1))  # one table a used topic at conc 1e-12
    assert ref.crt_z(draws[0], mean, var) < 6


@pytest.mark.parametrize("doc_chunk", [None, 16])
def test_runner_dense_step_equals_the_sweep_and_beta(doc_chunk):
    words, mask, data = _corpus(7)
    s0 = topic.initialize(data, K, V, _gen(8), n_docs=D)
    run = runner(None, data, s0, [("assign_blocked_dense", {"doc_chunk": doc_chunk}), ("beta", {})])
    run.run(_gen(10), 3)
    max_count = _hdp_default_kw(data)["max_count"]
    g, s = _gen(10), s0
    for _ in range(3):
        s = hdp.sample_beta(hdp.blocked_sweep_dense(s, words, mask, g, doc_chunk=doc_chunk), g, max_count=max_count)
    got = run.get_latent()
    for f in dataclasses.fields(s):
        if f.name != "hypers":
            assert torch.equal(getattr(got, f.name), getattr(s, f.name)), f.name
    assert np.array_equal(run.assignment_trace[-1], s.z.numpy())


def test_the_runner_keeps_a_byte_a_token_of_the_hdp_trace():
    """The HDP family's host copy of z holds at most a byte a token where the
    topics fit (K <= 256): ceil(log2 K) bits, 3 here, packed in bit planes;
    it reads back as int32, each sweep's z in turn over runs of 2 and 3
    sweeps; past 256 topics it keeps int32."""
    _, _, data = _corpus(21)
    s = topic.initialize(data, K, V, _gen(22), n_docs=D)
    config = [("assign_blocked_dense", {"doc_chunk": 16}), ("beta", {})]
    step, g, zs, x = make_step(config, data, HDP_FAMILY), _gen(23), [], s
    for _ in range(5):
        x = step(x, g)
        zs.append(x.z.numpy())
    run, g = runner(None, data, s, config), _gen(23)
    run.run(g, 2)
    run.run(g, 3)
    assert [(p.data.dtype, p.data.shape, p.bits) for p in run._assignment_trace] == [
        (np.uint8, (2, D * L // 8 * 3), 3), (np.uint8, (3, D * L // 8 * 3), 3)]
    trace = run.assignment_trace
    assert trace.dtype == np.int32 and np.array_equal(trace, np.stack(zs))
    wide = topic.initialize(data, 300, V, _gen(24), n_docs=D)
    host, copied = HDP_FAMILY["host_assignments"](wide.z[None], wide, None)
    assert copied is None  # on the CPU the copy is done when it returns
    assert host.dtype == np.int32 and np.array_equal(host[0], wide.z.numpy())


@pytest.mark.parametrize("bits", range(1, 9))
def test_the_trace_packing_round_trips(bits):
    """`_pack_bits` keeps ceil(T / 8) * bits bytes a sweep of any ids below
    2^bits, T not a multiple of 8 included, and `PackedZ` reads them back."""
    g = torch.Generator().manual_seed(bits)
    for T in (1, 13, 64):
        z = torch.randint(0, 2 ** bits, (3, T), generator=g, dtype=torch.int32)
        z[0, 0] = 2 ** bits - 1
        packed = _pack_bits(z, bits)
        assert packed.dtype == torch.uint8 and packed.shape == (3, -(-T // 8) * bits)
        back = PackedZ(packed.numpy(), bits, T).unpack()
        assert back.dtype == np.int32 and np.array_equal(back, z.numpy())


def _ragged():
    rows = [np.arange(5) % V, np.arange(7) % V, np.arange(3) % V]
    return topic.token_data(variadic_dataview(rows, device="cpu"))


def test_the_dense_doc_length_is_found_once_on_the_host():
    _, _, data = _corpus(11)
    assert _hdp_default_kw(data)["doc_len"] == L
    assert _hdp_default_kw(_ragged())["doc_len"] is None


@pytest.mark.parametrize("case", ["ragged", "short", "doc_order"])
def test_the_dense_route_refuses_a_corpus_that_is_not_dense(case):
    """Refused by the static doc length before any work; the flat route takes
    the same corpus."""
    _, _, data = _corpus(11)
    if case == "ragged":
        data = _ragged()
    elif case == "short":
        data = topic.TokenData(data.words[:-1], data.doc_ids[:-1], data.mask[:-1])
    else:
        data = data._replace(doc_ids=data.doc_ids.flip(0))
    s = topic.initialize(data, K, V, _gen(12), n_docs=int(data.doc_ids.max()) + 1)
    step = make_step([("assign_blocked_dense", {})], data, HDP_FAMILY)
    with pytest.raises(ValueError, match="doc-major rectangular"):
        step(s, _gen(13))
    make_step([("assign_blocked", {}), ("beta", {})], data, HDP_FAMILY)(s, _gen(13))  # the flat route takes it


# ---------------------------------------------------------------------------
# the reference's statistics
# ---------------------------------------------------------------------------
def test_the_dirichlet_fit_variance_is_the_closed_form():
    """With two groups the fit is the standardised Beta's square, whose
    variance is 2 + the Beta's excess kurtosis."""
    for a, b in [(0.7, 3.0), (5.0, 5.0), (40.0, 0.6), (2.0, 1e4)]:
        c = a + b
        G, H = 2.0, 1.0 / a + 1.0 / b
        var = (c * c * (2.0 * (G - 1.0) + 6.0 * H) + c * (6.0 * H - 2.0 * G - 4.0 * G * G) - 6.0 * G * G) \
            / ((c + 2.0) * (c + 3.0))
        excess = 6.0 * ((a - b) ** 2 * (c + 1.0) - a * b * (c + 2.0)) / (a * b * (c + 2.0) * (c + 3.0))
        assert var == pytest.approx(2.0 + excess, rel=1e-9)


def _signed(fit):
    return (fit.q - fit.mean) / math.sqrt(fit.var)


def test_the_dirichlet_fit_reads_n01_for_exact_draws():
    """300 exact draws of 400 theta-like rows and 6 phi-like rows: the signed
    statistic's mean within 0.2 of 0 and its sd within 0.8-1.25 (sampling
    error at 300 draws about 0.06 and 0.04)."""
    g = torch.Generator().manual_seed(1)
    n = torch.randint(0, 3, (400, 8), generator=g) * torch.randint(0, 20, (400, 8), generator=g)
    beta = torch.rand(9, generator=g, dtype=torch.float64)
    cases = [(ref.theta_params(n, 1.0, beta / beta.sum()), n > 0, 8)]
    n_kw = torch.randint(0, 2, (6, 300), generator=g) * torch.randint(0, 50, (6, 300), generator=g)
    cases.append((ref.phi_params(n_kw, 0.1), n_kw > 0, 5))
    for params, occupied, chunk in cases:
        ts = []
        for _ in range(300):
            fit = ref.DirichletFit()
            fit.add(ref.dirichlet_draw(params, g, REFERENCE), params, occupied, chunk)
            ts.append(_signed(fit))
        ts = torch.tensor(ts)
        assert abs(float(ts.mean())) < 0.2 and 0.8 < float(ts.std()) < 1.25, (ts.mean(), ts.std())


def test_the_categorical_fit_reads_abs_n01_for_exact_draws():
    """200 exact draws of 5,000 tokens over 30 groups of 6 cells: the
    statistic's mean and sd near abs(N(0, 1))'s 0.80 and 0.60 (within 0.2)."""
    g = torch.Generator().manual_seed(2)
    ts = []
    for _ in range(200):
        group = torch.randint(0, 30, (5000,), generator=g)
        q = torch._standard_gamma(torch.full((5000, 6), 0.5, dtype=torch.float64), generator=g)
        q = q / q.sum(-1, keepdim=True)
        fit = ref.CategoricalFit(30, 6, "cpu")
        fit.add(group, q, torch.multinomial(q, 1, generator=g)[:, 0])
        ts.append(fit.t())
    ts = torch.tensor(ts)
    assert abs(float(ts.mean()) - 0.80) < 0.2 and abs(float(ts.std()) - 0.60) < 0.2, (ts.mean(), ts.std())


def test_the_ports_phi_and_theta_draws_fit_their_parameters():
    """The port's draws read within 5 of the reference's parameters; with eta
    doubled in the draw they do not."""
    words, mask, data, s = _state(6, sweeps=4)
    n_dk, n_kw, _ = ref.counts(s.z, words, mask, K, V)
    p_phi = ref.phi_params(n_kw, s.hypers["eta"])
    p_theta = ref.theta_params(n_dk, s.hypers["alpha"], s.beta)
    g = _gen(12)
    phi_fit, theta_fit = ref.DirichletFit(), ref.DirichletFit()
    wrong = ref.DirichletFit()
    for _ in range(20):
        phi, theta = hdp._draw_phi_theta(s, g)
        phi_fit.add(phi, p_phi, n_kw > 0, 3)
        theta_fit.add(theta, p_theta, n_dk > 0, K)
        wrong.add(hdp._dirichlet(s.topic_word + 4.0 * s.hypers["eta"], g), p_phi, n_kw > 0, 3)
    assert phi_fit.t() < 5 and theta_fit.t() < 5, (phi_fit.t(), theta_fit.t())
    assert wrong.t() > 10, wrong.t()


def test_the_ports_beta_draw_fits_its_parameters():
    """beta | m ~ Dir(m_1 + 1e-8, ..., m_K + 1e-8, gamma): 200 of the port's
    draws read within 5 of the reference's parameters (the 1e-12 floor moves
    no entry that the fit's groups can see); with gamma tenfold they do not."""
    m_k = torch.tensor([40.0, 0.0, 7.0, 1.0, 0.0, 120.0])
    gamma = torch.tensor(1.5)
    params = ref.beta_params(m_k, gamma)
    occupied = torch.cat([m_k > 0, torch.tensor([True])])
    g = _gen(13)
    fit, wrong = ref.DirichletFit(), ref.DirichletFit()
    for _ in range(200):
        fit.add(hdp._beta_from_tables(m_k, gamma, g)[None], params[None], occupied[None], K)
        wrong.add(hdp._beta_from_tables(m_k, 10.0 * gamma, g)[None], params[None], occupied[None], K)
    assert fit.t() < 5 and wrong.t() > 10, (fit.t(), wrong.t())
