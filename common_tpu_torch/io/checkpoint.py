"""State serialization and checkpoint-resume (port of `common_tpu/io/checkpoint.py`).

Reference analog: ``common:src/io/schema.proto`` and
``group_manager::serialize()``: persistence of the assignment vector,
per-group counts, packed suffstats and hypers, surfaced in Python as
``state.serialize()`` / ``deserialize``.

The format is the JAX package's, version 2: an npz archive with one array
per leaf, stored under its path (``f.stats.0.sum_x``), and a JSON header
under ``__meta__`` holding the state type, the container skeleton, the
static fields and the skeleton of `extra`. So a blob written by
`common_tpu.io.checkpoint.serialize` loads here, and the reverse. Leading
batch axes (stacked chains) ride along, since leaves are saved verbatim.

The port handles `MixtureState`, `SVIPosterior` (kernels/svi.py), `HDPState`
(topic/hdp.py), `LDAPosterior` (topic/svi.py) and `IRMState`
(relational/state.py), under the JAX package's type names and field paths;
a blob whose fields are not those of its type is refused. A state's
tensors are saved in their dtype; an HDP state's word and doc ids are not
state (they are the corpus). `extra` carries what a bit-exact resume
needs: a `torch.Generator` is saved through `get_state()` under the kind
``torch_generator``. A JAX PRNG key (kind ``prng_key``) is refused on load:
threefry keys have no torch counterpart.
"""

from __future__ import annotations

import dataclasses
import io as _io
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from common_tpu_torch import validator

_META_KEY = "__meta__"
_STATIC = ("lik_names", "fixed", "rel_domains")  # the JAX dataclasses' static fields


def _state_types() -> Dict[str, type]:
    # late imports: io need not pull in the samplers at import
    from common_tpu_torch.kernels.svi import SVIPosterior
    from common_tpu_torch.relational.state import IRMState
    from common_tpu_torch.state import MixtureState
    from common_tpu_torch.topic.hdp import HDPState
    from common_tpu_torch.topic.svi import LDAPosterior

    return {"MixtureState": MixtureState, "HDPState": HDPState, "SVIPosterior": SVIPosterior,
            "LDAPosterior": LDAPosterior, "IRMState": IRMState}


def _flatten_value(v, path: str, arrays: Dict[str, np.ndarray]):
    """Value -> JSON skeleton; array leaves collected into `arrays`."""
    if isinstance(v, dict):
        return {"kind": "dict",
                "items": {k: _flatten_value(v[k], f"{path}.{k}", arrays) for k in sorted(v)}}
    if isinstance(v, (tuple, list)):
        return {"kind": "tuple" if isinstance(v, tuple) else "list",
                "items": [_flatten_value(x, f"{path}.{i}", arrays) for i, x in enumerate(v)]}
    if isinstance(v, torch.Generator):
        arrays[path] = v.get_state().numpy()
        return {"kind": "torch_generator", "device": v.device.type}
    arrays[path] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return {"kind": "array"}


def _rebuild_value(spec, path: str, z, device: torch.device):
    kind = spec["kind"]
    if kind == "dict":
        return {k: _rebuild_value(s, f"{path}.{k}", z, device) for k, s in spec["items"].items()}
    if kind in ("tuple", "list"):
        items = [_rebuild_value(s, f"{path}.{i}", z, device) for i, s in enumerate(spec["items"])]
        return tuple(items) if kind == "tuple" else items
    if kind == "prng_key":
        raise ValueError(
            f"checkpoint leaf {path!r} is a JAX PRNG key: threefry keys have no torch "
            "counterpart; save a torch.Generator in `extra`, or drop the key")
    if kind == "torch_generator":
        if spec["device"] != device.type:
            raise ValueError(
                f"checkpoint leaf {path!r} is a {spec['device']} generator; "
                f"it cannot resume on a {device.type} device")
        g = torch.Generator(device=device)
        g.set_state(torch.from_numpy(np.array(z[path])))
        return g
    return torch.from_numpy(np.array(z[path])).to(device)


def serialize(state, extra: Optional[Dict[str, Any]] = None) -> bytes:
    """state -> bytes (reference parity: state.serialize())."""
    tname, types = type(state).__name__, _state_types()
    if types.get(tname) is not type(state):
        raise TypeError(f"cannot checkpoint {tname}; known state types: {sorted(types)}")
    arrays: Dict[str, np.ndarray] = {}
    fields, static = {}, {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name in _STATIC:
            static[f.name] = v
        else:
            fields[f.name] = _flatten_value(v, f"f.{f.name}", arrays)
    extra_spec = {k: _flatten_value(v, f"extra.{k}", arrays) for k, v in (extra or {}).items()}
    meta = {"type": tname, "fields": fields, "static": static,
            "extra": extra_spec, "version": 2}
    buf = _io.BytesIO()
    np.savez(buf, **arrays, **{_META_KEY: np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)})
    return buf.getvalue()


def _tuplify(v):
    """JSON round-trips tuples as lists; static fields expect tuples."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def deserialize(blob: bytes, device="cuda"):
    """bytes -> (state, extra), with every tensor and generator on `device`:
    the card unless the caller names another (without a card the default
    raises)."""
    device = torch.device(device)
    with np.load(_io.BytesIO(blob)) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
        validator.validate_one_of(meta["version"], (2,), "checkpoint version")
        types = _state_types()
        validator.validate_one_of(meta["type"], sorted(types), "checkpoint state type")
        names = {f.name for f in dataclasses.fields(types[meta["type"]])}
        if set(meta["fields"]) | set(meta["static"]) != names:
            raise ValueError(
                f"checkpoint fields {sorted(set(meta['fields']) | set(meta['static']))} are not "
                f"those of its checkpoint state type {meta['type']}: {sorted(names)}")
        kwargs = {name: _rebuild_value(spec, f"f.{name}", z, device)
                  for name, spec in meta["fields"].items()}
        for name, v in meta["static"].items():
            kwargs[name] = _tuplify(v)
        extra = {k: _rebuild_value(spec, f"extra.{k}", z, device) for k, spec in meta["extra"].items()}
    return types[meta["type"]](**kwargs), extra


def save(path: str, state, extra: Optional[Dict[str, Any]] = None):
    with open(path, "wb") as f:
        f.write(serialize(state, extra))


def load(path: str, device="cuda"):
    with open(path, "rb") as f:
        return deserialize(f.read(), device)
