"""The port's entry points put their tensors on the card unless the caller
names another device, and never carry on on the CPU without being asked.

`rng`, `numpy_dataview`, `variadic_dataview`, `sparse_ndarray_dataview`,
`state_from_numpy`, `hdp_from_numpy`, `lda_from_numpy`, `irm_from_numpy`,
`io.deserialize`, `io.load`, the hyper validators, `hmc.da_init`,
`hmc.welford_init` and `profiling.benchmark` default to `device="cuda"`,
and so does an IRM state made from a default dataview: with a card their
output lies there; without one they raise, as `torch.Generator("cuda")`
does. With `device="cpu"` they work anywhere. Each test decides inside its
body whether a card is present.
"""

import numpy as np
import pytest
import torch

from common_tpu_torch import convert, io, models, rng, topic
from common_tpu_torch import relational as irm
from common_tpu_torch import state as st
from common_tpu_torch.data import numpy_dataview, sparse_ndarray_dataview, variadic_dataview
from common_tpu_torch.kernels import hmc
from common_tpu_torch.utils import profiling
from common_tpu_torch.likelihoods import bbv  # the registered likelihood

torch.set_num_threads(2)


def _state():
    X = np.random.default_rng(0).normal(size=(12, 2)).astype(np.float32)
    defn = st.model_definition(12, [models.niw(2)], k_max=4)
    data = ((torch.from_numpy(X), torch.ones(12)),)
    return st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0})


def _hdp_state():
    data = topic.token_data(variadic_dataview([np.array([0, 1, 1]), np.array([2])], device="cpu"))
    return topic.initialize(data, 3, 4, rng(0, "cpu").generator, n_docs=2)


def _irm_state(**kw):
    """An IRM state over a default (or `device=`) dataview: it lives on the views' device."""
    rel = np.eye(4, dtype=np.float32)
    defn = irm.model_definition([4], [((0, 0), models.bb)], k_max=3)
    return irm.initialize(defn, [sparse_ndarray_dataview(dense=rel, **kw)], rng(0, **kw).generator)


def _timed_on(**kw):
    """A tensor on the device `profiling.benchmark` timed on (the card by default)."""
    out = []
    profiling.benchmark(lambda: out.append(torch.ones(2, device=kw.get("device", "cuda"))), iters=1, **kw)
    return out[-1]


def _load(tmp_path, **kw):
    path = str(tmp_path / "state.npz")
    io.save(path, _state())
    return io.load(path, **kw)[0].assignments


# each entry point, called with keyword arguments kw, returns a tensor or
# generator whose .device is where the entry point put its output
ENTRY_POINTS = {
    "rng": lambda tmp, **kw: rng(3, **kw).generator,
    "numpy_dataview": lambda tmp, **kw: numpy_dataview(np.zeros((5, 2), np.float32), **kw).columns[0][0],
    "state_from_numpy": lambda tmp, **kw: convert.state_from_numpy(
        convert.state_to_numpy(_state()), **kw).counts,
    "io.deserialize": lambda tmp, **kw: io.deserialize(io.serialize(_state()), **kw)[0].stats[0]["sum_x"],
    "io.load": _load,
    "canonical_hyper": lambda tmp, **kw: models.niw(2).canonical_hyper(**kw)["mu0"],
    "validate_hyper": lambda tmp, **kw: bbv.validate_hyper(
        {"alpha": np.ones(3), "beta": np.ones(3)}, **kw)["alpha"],
    "hmc.da_init": lambda tmp, **kw: hmc.da_init(0.1, **kw).log_eps,
    "hmc.welford_init": lambda tmp, **kw: hmc.welford_init(3, **kw).mean,
    "variadic_dataview": lambda tmp, **kw: variadic_dataview([np.arange(3), np.arange(2)], **kw).tokens,
    "hdp_from_numpy": lambda tmp, **kw: convert.hdp_from_numpy(
        convert.hdp_to_numpy(_hdp_state()), **kw).doc_topic,
    "lda_from_numpy": lambda tmp, **kw: convert.lda_from_numpy(
        {"lam": np.ones((2, 4), np.float32), "alpha": np.ones(2, np.float32),
         "eta": np.float32(0.1)}, **kw).lam,
    "io.deserialize(HDPState)": lambda tmp, **kw: io.deserialize(io.serialize(_hdp_state()), **kw)[0].z,
    "sparse_ndarray_dataview": lambda tmp, **kw: sparse_ndarray_dataview(dense=np.ones((2, 3)), **kw).indices,
    "irm.initialize": lambda tmp, **kw: _irm_state(**kw).suffstats[0]["n"],
    "irm_from_numpy": lambda tmp, **kw: convert.irm_from_numpy(
        convert.irm_to_numpy(_irm_state(device="cpu")), **kw).counts[0],
    "io.deserialize(IRMState)": lambda tmp, **kw: io.deserialize(
        io.serialize(_irm_state(device="cpu")), **kw)[0].assignments[0],
    "profiling.benchmark": lambda tmp, **kw: _timed_on(**kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, tmp_path):
    call = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert call(tmp_path).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(tmp_path)
    assert call(tmp_path, device="cpu").device == torch.device("cpu")


def test_state_follows_the_data_device():
    """`initialize` takes the data's device for the state and its hypers,
    whatever the entry points' default."""
    s = _state()
    assert s.assignments.device.type == "cpu"
    assert all(v.device.type == "cpu" for h in s.hypers for v in h.values())
    assert all(v.device.type == "cpu" for f in s.stats for v in f.values())


def test_topic_states_follow_their_inputs():
    """`topic.initialize` follows the corpus's device and `topic.svi.init`
    the generator's, whatever the entry points' default."""
    s = _hdp_state()
    assert all(t.device.type == "cpu" for t in (s.z, s.beta, s.doc_topic, s.topic_word, *s.hypers.values()))
    post = topic.svi.init(2, 5, rng(1, "cpu").generator)
    assert all(t.device.type == "cpu" for t in (post.lam, post.alpha, post.eta))


def test_irm_state_follows_its_views():
    """`relational.initialize` puts the state where its views lie, and a
    kernel keeps it there."""
    s = _irm_state(device="cpu")
    leaves = [*s.assignments, *s.counts, s.cluster_hps[0]["alpha"], *s.suffstats[0].values(),
              *s.hypers[0].values()]
    assert all(t.device.type == "cpu" for t in leaves)
    views = [sparse_ndarray_dataview(dense=np.eye(4, dtype=np.float32), device="cpu")]
    out = irm.kernels.assign(s, views, rng(1, "cpu").generator)
    assert out.suffstats[0]["n"].device.type == "cpu"
