"""The port's entry points put their tensors on the card unless the caller
names another device, and never carry on on the CPU without being asked.

`rng`, `numpy_dataview`, `state_from_numpy`, `io.deserialize`, `io.load`
and the hyper validators default to `device="cuda"`: with a card their
output lies there; without one they raise, as `torch.Generator("cuda")`
does. With `device="cpu"` they work anywhere. Each test decides inside its
body whether a card is present.
"""

import numpy as np
import pytest
import torch

from common_tpu_torch import convert, io, models, rng
from common_tpu_torch import state as st
from common_tpu_torch.data import numpy_dataview
from common_tpu_torch.likelihoods import bbv  # the registered likelihood

torch.set_num_threads(2)


def _state():
    X = np.random.default_rng(0).normal(size=(12, 2)).astype(np.float32)
    defn = st.model_definition(12, [models.niw(2)], k_max=4)
    data = ((torch.from_numpy(X), torch.ones(12)),)
    return st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0})


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
