"""BASELINE config 3 as a whole: the port's runner against the JAX runner.

The recipe of bench.py:903-1007 (a plain blocked sweep, NUTS over the gp
and bb hypers, NUTS over the CRP concentration, Exp(1) priors, two
transitions of depth at most 5 each), cut to a niw(2) + gp + bb mixture of
240 rows (3 planted clusters, 120 more held out) and K_max = 8. One initial
state (four random groups), made by the port and carried to JAX as numpy
leaves, starts SEEDS chains of ITERS iterations in each package: the port's
`runner(...).run`, and the JAX runner's own `make_step` scanned under
`jax.vmap`. The streams differ (Philox and threefry), so the two are
compared as distributions: each chain's mean of alpha and of the four
hypers over its second half, and its final held-out logp/row, averaged
over the seeds; the two packages' seed means agree within 3 combined
standard errors (sqrt(se_port^2 + se_jax^2), se = sd / sqrt(SEEDS)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from common_tpu import runner as jrunner
from common_tpu import scalar_functions as jsf
from common_tpu import state as jst
from common_tpu_torch import convert, models, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.runner import runner

torch.set_num_threads(2)

N, HELD, K_MAX, SEEDS, ITERS = 240, 120, 8, 6, 20
NAMES = ("alpha", "gp.alpha", "gp.inv_beta", "bb.alpha", "bb.beta", "heldout")


def _rows():
    r = np.random.default_rng(0)
    z = r.integers(0, 3, N + HELD)
    xg = np.array([[-3.0, 0.0], [3.0, 0.0], [0.0, 4.0]])[z] + r.normal(size=(N + HELD, 2))
    xp = r.poisson(np.array([0.5, 3.0, 9.0])[z])
    xb = r.random(N + HELD) < np.array([0.15, 0.5, 0.85])[z]
    return [a.astype(np.float32) for a in (xg, xp, xb)]


def _config(lib_sf):
    exp1 = lib_sf.log_exponential(1.0)
    priors = {1: lambda h: exp1(h["alpha"]) + exp1(h["inv_beta"]),
              2: lambda h: exp1(h["alpha"]) + exp1(h["beta"])}
    return [("assign_blocked", {}),
            ("nuts_hp", {"priors": priors, "num_steps": 2, "max_depth": 5}),
            ("nuts_cluster_hp", {"prior": exp1, "num_steps": 2, "max_depth": 5})]


def _summary(track, heldout):
    """[SEEDS, 6]: the second-half means of the five hypers, the held-out logp/row."""
    track = np.asarray(track, np.float64)  # [SEEDS, ITERS, 5]
    return np.concatenate([track[:, ITERS // 2:].mean(1), np.asarray(heldout)[:, None]], 1)


def _port_chains(leaves, data, held):
    defn = st.model_definition(N, [models.niw(2), models.gp, models.bb], k_max=K_MAX)
    s0 = convert.state_from_numpy(leaves, device="cpu")
    tracks, lps = [], []
    for seed in range(SEEDS):
        run, g, track = runner(defn, data, s0, _config(sf)), rng(100 + seed, "cpu").generator, []
        for _ in range(ITERS):
            s = run.run(g, 1, collect=False)
            track.append([float(s.cluster_hp["alpha"]), float(s.hypers[1]["alpha"]),
                          float(s.hypers[1]["inv_beta"]), float(s.hypers[2]["alpha"]),
                          float(s.hypers[2]["beta"])])
        tracks.append(track)
        lps.append(float(st.heldout_logp(s, held).mean()))
    return _summary(tracks, lps)


def _jax_chains(leaves, cols):
    arr = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    js0 = jst.MixtureState(
        assignments=jnp.asarray(leaves["assignments"]), counts=jnp.asarray(leaves["counts"]),
        cluster_hp=arr(leaves["cluster_hp"]), stats=tuple(arr(s) for s in leaves["stats"]),
        hypers=tuple(arr(h) for h in leaves["hypers"]), lik_names=tuple(leaves["lik_names"]))
    jdata = tuple((jnp.asarray(c[:N]), jnp.ones(N)) for c in cols)
    jheld = tuple((jnp.asarray(c[N:]), jnp.ones(HELD)) for c in cols)
    step = jrunner.make_step(_config(jsf), jdata)

    def chain(key):
        def body(s, t):
            s = step(s, jax.random.fold_in(key, t))
            return s, jnp.stack([s.cluster_hp["alpha"], s.hypers[1]["alpha"], s.hypers[1]["inv_beta"],
                                 s.hypers[2]["alpha"], s.hypers[2]["beta"]])

        s, track = jax.lax.scan(body, js0, jnp.arange(ITERS))
        return track, jnp.mean(jst.heldout_logp(s, jheld))

    track, lps = jax.jit(jax.vmap(chain))(jax.random.split(jax.random.key(7), SEEDS))
    return _summary(track, lps)


def test_config3_mix_agrees_with_the_jax_runner():
    cols = _rows()
    data = tuple((torch.from_numpy(c[:N]), torch.ones(N)) for c in cols)
    held = tuple((torch.from_numpy(c[N:]), torch.ones(HELD)) for c in cols)
    defn = st.model_definition(N, [models.niw(2), models.gp, models.bb], k_max=K_MAX)
    hps = [{"mu0": np.zeros(2, np.float32), "kappa": 1.0, "psi": np.eye(2, dtype=np.float32), "nu": 4.0},
           {"alpha": 1.0, "inv_beta": 1.0}, {"alpha": 1.0, "beta": 1.0}]
    # a start of four random groups (the blocked sweep then fills the K_MAX
    # slots in both packages: its empty slots draw from the prior)
    z0 = np.random.default_rng(1).integers(0, 4, N).astype(np.int32)
    s0 = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0}, feature_hps=hps,
                       assignment=z0)
    leaves = convert.state_to_numpy(s0)

    port, jx = _port_chains(leaves, data, held), _jax_chains(leaves, cols)
    assert np.isfinite(port).all() and np.isfinite(jx).all()
    assert (port[:, :5] > 0).all() and (jx[:, :5] > 0).all()
    m_p, m_j = port.mean(0), jx.mean(0)
    se = np.sqrt(port.var(0, ddof=1) / SEEDS + jx.var(0, ddof=1) / SEEDS)
    report = {n: (round(a, 4), round(b, 4), round(c, 4)) for n, a, b, c in zip(NAMES, m_p, m_j, se)}
    assert (np.abs(m_p - m_j) <= 3 * se).all(), report
    # the chains learned the planted structure: held out above one cluster's
    one = st.initialize(defn, data, rng(0, "cpu").generator, feature_hps=hps,
                        assignment=np.zeros(N, np.int32))
    assert m_p[-1] > float(st.heldout_logp(one, held).mean()) + 1.0, report


def test_a_mixed_state_carries_both_ways():
    """`state_from_numpy` carries a niw + gp + bb state: every leaf's dtype
    and values kept, and the JAX package scores it as the port does (the
    joint score to 1e-6)."""
    cols = _rows()
    data = tuple((torch.from_numpy(c[:N]), torch.ones(N)) for c in cols)
    defn = st.model_definition(N, [models.niw(2), models.gp, models.bb], k_max=K_MAX)
    s = st.initialize(defn, data, rng(2, "cpu").generator, cluster_hp={"alpha": 1.3})
    leaves = convert.state_to_numpy(s)
    back = convert.state_from_numpy(leaves, device="cpu")
    assert back.lik_names == ("niw", "gp", "bb") and back.fixed is False
    assert torch.equal(back.assignments, s.assignments) and torch.equal(back.counts, s.counts)
    for got, want in zip(back.stats + back.hypers, s.stats + s.hypers):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    arr = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    js = jst.MixtureState(
        assignments=jnp.asarray(leaves["assignments"]), counts=jnp.asarray(leaves["counts"]),
        cluster_hp=arr(leaves["cluster_hp"]), stats=tuple(arr(x) for x in leaves["stats"]),
        hypers=tuple(arr(h) for h in leaves["hypers"]), lik_names=tuple(leaves["lik_names"]))
    np.testing.assert_allclose(float(st.score_joint(back)), float(jst.score_joint(js)), rtol=1e-6)
