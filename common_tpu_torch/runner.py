"""Inference runner (port of `common_tpu/runner.py`: mixture, HDP and IRM families).

Reference analog: the `runner` layer of the reference ecosystem
(`kernels:microscopes/kernels/runner.py`): takes a model definition, a
dataview, an initialized latent state and a *kernel config* -- an ordered
list like ``[('assign', {}), ('grid_feature_hp', spec), ('theta', {})]`` --
and applies each kernel once per iteration. A mix such as
``[('assign_blocked_fused', {}), ('slice_hp', {'specs': ..., 'cluster': ...})]``
sweeps the rows, then slice-samples the hyperparameters.

The JAX package runs the loop as one `lax.scan`; here it is a Python loop.
The per-sweep traces (joint score, active-cluster count, counts and,
optionally, assignments) stay on the device until the end of `run`, so the
loop itself never waits on the device between sweeps (the slice sampler
does, inside `slice_hp` and `slice_theta`: see `kernels/slice_.py`; so do
the NUTS kernels, one boolean a leaf and a doubling: see `kernels/hmc.py`).
`jsonl_path` adds one JSON line per sweep, written at the end of each `run`.
Under `utils.profiling.recording()` a step is the span `runner.step`, each
kernel in it `runner.<kernel>`, and `run`'s copies of the chunk's traces
to the host the read `read.runner.trace`.

A state family supplies its kernel registry, joint score, counts,
assignments, saturation test and default kernel keywords: `MixtureState`
(`KERNELS` below), `HDPState` (`HDP_KERNELS`: assign, assign_blocked,
assign_blocked_dense, beta, concentrations, with the CRT cap `max_count`
and the dense route's doc length worked out once, on the host, when the
runner is built; that route needs a doc-major rectangular corpus) and
`IRMState` (`IRM_KERNELS`: assign, over
one `domain` or all, assign_blocked, ew_domain_alpha, grid_domain_alpha;
its data is the relation views, its counts and assignments are those of
all domains concatenated).
"""

from __future__ import annotations

import json
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch import validator
from common_tpu_torch.kernels import blocked, gibbs, hmc, slice_, splitmerge
from common_tpu_torch.relational import kernels as irm_kernels
from common_tpu_torch.relational import state as irm_state
from common_tpu_torch.state import MixtureState
from common_tpu_torch.topic import hdp
from common_tpu_torch.utils import diagnostics, profiling


def _k_assign(state, data, generator, **kw):
    return gibbs.assign_resample(state, data, generator, m=kw.get("m", 1))


def _k_assign_resample(state, data, generator, **kw):
    return gibbs.assign_resample(state, data, generator, m=kw.get("m", 2))


def _k_assign_fixed(state, data, generator, **kw):
    return gibbs.assign_resample(state, data, generator, m=1)


def _k_assign_blocked(state, data, generator, **kw):
    return blocked.sweep(state, data, generator)


def _k_assign_blocked_fused(state, data, generator, tile_n=None, k_tile=None,
                            interpret=False, fused_restat=True):
    # tile_n, k_tile and interpret tile the JAX package's Pallas kernels on
    # the TPU; the CUDA kernels pick their own tiling, so they mean nothing
    # here and are accepted for configs written for the JAX runner.
    del tile_n, k_tile, interpret
    return blocked.sweep_fused(state, data, generator, fused_restat=fused_restat)


def _k_grid_feature_hp(state, data, generator, **kw):
    return gibbs.hp(state, kw["specs"], generator)


def _k_grid_cluster_hp(state, data, generator, **kw):
    return gibbs.cluster_hp(state, kw["prior"], kw["grid"], generator)


def _k_ew_cluster_hp(state, data, generator, **kw):
    return gibbs.cluster_hp_escobar_west(state, generator, kw.get("a", 1.0), kw.get("b", 1.0))


def _k_theta(state, data, generator, **kw):
    return gibbs.theta(state, generator)


def _k_slice_theta(state, data, generator, **kw):
    return slice_.theta(state, generator, **kw)


def _k_nuts_hp(state, data, generator, **kw):
    return hmc.hp(state, data, generator, **kw)


def _k_nuts_cluster_hp(state, data, generator, prior, **kw):
    return hmc.cluster_hp(state, generator, prior, **kw)


def _k_nuts_theta(state, data, generator, **kw):
    return hmc.theta(state, generator, **kw)


# kernel name -> fn(state, data, generator, **kw) -> state
KERNELS: Dict[str, Callable] = {
    "assign": _k_assign,
    "assign_resample": _k_assign_resample,
    "assign_fixed": _k_assign_fixed,
    "assign_blocked": _k_assign_blocked,
    "assign_blocked_fused": _k_assign_blocked_fused,  # kw: fused_restat (tile_n, k_tile, interpret ignored)
    "grid_feature_hp": _k_grid_feature_hp,  # kw: specs
    "grid_cluster_hp": _k_grid_cluster_hp,  # kw: prior, grid
    "ew_cluster_hp": _k_ew_cluster_hp,  # kw: a, b
    "theta": _k_theta,
    "slice_theta": _k_slice_theta,  # kw: w
    "slice_hp": slice_.hp,  # kw: specs, cluster
    "nuts_hp": _k_nuts_hp,  # kw: priors, transforms, step_size, num_steps, max_depth
    "nuts_cluster_hp": _k_nuts_cluster_hp,  # kw: prior, step_size, num_steps, max_depth
    "nuts_theta": _k_nuts_theta,  # kw: step_size, num_steps, max_depth
    "split_merge": splitmerge.moves,  # kw: n_moves, t_scans
}


# ---------------------------------------------------------------------------
# state families: the runner drives mixture and HDP states through the same
# kernel-config interface (reference runner parity for the lda sibling repo)
# ---------------------------------------------------------------------------
def _k_hdp_assign(state, data, generator, **kw):
    return hdp.collapsed_sweep(state, data, generator)


def _k_hdp_blocked(state, data, generator, **kw):
    return hdp.blocked_sweep(state, data, generator)


def _k_hdp_blocked_dense(state, data, generator, doc_chunk=None, doc_len=None, **kw):
    # the flat corpus viewed as its [D, L] doc-major layout; doc_len is the
    # static L that `_hdp_default_kw` found on the host, None for any other
    # layout; D is the state's, a static shape
    D = state.n_docs
    if doc_len is None or D * doc_len != data.words.shape[0]:
        raise ValueError("assign_blocked_dense needs a doc-major rectangular corpus (hdp.dense_token_data) "
                         f"of the state's {D} docs: {data.words.shape[0]} tokens are not D rows of L in doc order")
    return hdp.blocked_sweep_dense(state, data.words.view(D, doc_len), data.mask.view(D, doc_len),
                                   generator, doc_chunk=doc_chunk)


def _k_hdp_beta(state, data, generator, **kw):
    return hdp.sample_beta(state, generator, kw["max_count"])


def _k_hdp_concentrations(state, data, generator, **kw):
    return hdp.sample_concentrations(
        state, generator, kw["max_count"], kw.get("a_alpha", 1.0), kw.get("b_alpha", 1.0),
        kw.get("a_gamma", 1.0), kw.get("b_gamma", 1.0))


# every HDP kernel gets max_count (the longest document) and doc_len (the dense
# route's L, or None) unless its config names them
HDP_KERNELS: Dict[str, Callable] = {
    "assign": _k_hdp_assign,
    "assign_blocked": _k_hdp_blocked,
    "assign_blocked_dense": _k_hdp_blocked_dense,  # kw: doc_chunk; a doc-major rectangular corpus
    "beta": _k_hdp_beta,
    "concentrations": _k_hdp_concentrations,  # kw: a_alpha, b_alpha, a_gamma, b_gamma
}


def _hdp_default_kw(data) -> dict:
    """The static CRT cap: the most valid tokens in any doc bounds every n_dk;
    and the dense route's doc length L where the corpus is doc-major and
    rectangular as `hdp.dense_token_data` builds it (T = D L tokens, doc ids
    0..D-1 each repeated L times in a row), else None. Worked out once, on
    the host."""
    doc_ids, mask = data.doc_ids.cpu().numpy(), data.mask.cpu().numpy()
    lengths = np.bincount(doc_ids, weights=mask) if doc_ids.size else np.ones(1)
    D = int(doc_ids.max()) + 1 if doc_ids.size else 0
    L = doc_ids.size // D if D else 0
    dense = L > 0 and D * L == doc_ids.size and bool((doc_ids.reshape(D, L) == np.arange(D)[:, None]).all())
    return {"max_count": max(int(np.max(lengths)), 1), "doc_len": L if dense else None}


def _host_copy(assignments: torch.Tensor, state, stream):
    """The mixture and IRM families' trace copy: waits for the device."""
    return assignments.cpu().numpy(), None


_PLANES = (8, 4, 2, 1)  # bit-plane widths, each a divisor of 8


class PackedZ(NamedTuple):
    """A chunk's HDP trace on the host: `bits` bits a token (`_pack_bits`)."""

    data: np.ndarray  # [sweeps, ceil(tokens / 8) * bits] uint8
    bits: int
    tokens: int

    def unpack(self) -> np.ndarray:
        """[sweeps, tokens] int32."""
        S, n8 = self.data.shape[0], -(-self.tokens // 8) * 8
        out = np.zeros((S, n8), np.int32)
        start = shift = 0
        for w in _PLANES:
            if self.bits & w:
                per = 8 // w
                plane = self.data[:, start:start + n8 // per].astype(np.int32)
                vals = np.stack([(plane >> (w * i)) & ((1 << w) - 1) for i in range(per)], axis=-1)
                out |= vals.reshape(S, n8) << shift
                start, shift = start + n8 // per, shift + w
        return out[:, :self.tokens]


def _pack_bits(z: torch.Tensor, bits: int) -> torch.Tensor:
    """[S, T] ids below 2^bits (bits <= 8) as uint8 [S, ceil(T / 8) * bits],
    on z's device: one bit plane for each binary digit of bits (8, 4, 2 or 1
    bits wide, low bits first), each packing 8 / width tokens a byte. Only
    byte-wide operations, so the packing costs a few passes over a byte a
    token."""
    S, T = z.shape
    z = z.to(torch.uint8)
    if T % 8:
        z = torch.nn.functional.pad(z, (0, -T % 8))
    planes, shift = [], 0
    for w in _PLANES:
        if bits & w:
            part = ((z >> shift) & ((1 << w) - 1)).view(S, -1, 8 // w)
            byte = part[..., 0]
            for i in range(1, 8 // w):
                byte = byte | (part[..., i] << (w * i))
            planes.append(byte)
            shift += w
    return torch.cat(planes, dim=1)


def _hdp_host_z(z: torch.Tensor, state, stream):
    """A chunk's z on the host: where the topics fit in a byte (K <= 256),
    ceil(log2 K) bits a token (`PackedZ`, packed on the device), into pinned
    memory, on a stream of its own that waits for the chunk's sweeps and
    overlaps the next chunk. At config 4's 1M docs x 50 tokens and K = 32 a
    sweep keeps 31.25 MB, so a run of a few thousand sweeps fits the host
    (one byte a token in pinned blocks, which round up to a power of two,
    kept 64 MB a sweep). `stream` is the runner's copy stream (None off the
    card). Returns the host copy and the event after which it is whole."""
    host = lambda a: a  # noqa: E731
    if state.n_topics <= 256:
        bits, tokens = max(1, (state.n_topics - 1).bit_length()), z.shape[1]
        host = lambda a: PackedZ(a, bits, tokens)  # noqa: E731
        z = _pack_bits(z, bits)
    if stream is None:
        return host(z.cpu().numpy()), None
    stream.wait_stream(torch.cuda.current_stream(z.device))
    out = torch.empty(z.shape, dtype=z.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        out.copy_(z, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    z.record_stream(stream)  # the source outlives the copy
    return host(out.numpy()), done


def _hdp_saturated(st) -> torch.Tensor:
    # transient counts on every truncation slot are normal for blocked sweeps;
    # the truncation only binds once the remainder stick mass is spent too
    return (st.topic_total > 0).all() & (st.beta[-1] < 1e-3)


def _k_irm_assign(state, data, generator, **kw):
    if "domain" in kw:
        return irm_kernels.assign(state, data, generator, domain=kw["domain"])
    return irm_kernels.assign_all(state, data, generator)


def _k_irm_blocked(state, data, generator, **kw):
    return irm_kernels.sweep(state, data, generator)


def _k_irm_ew(state, data, generator, **kw):
    return irm_kernels.domain_alpha_escobar_west(state, generator, kw.get("a", 1.0), kw.get("b", 1.0))


def _k_irm_grid(state, data, generator, **kw):
    return irm_kernels.domain_alpha_grid(state, kw["prior"], kw["grid"], generator)


IRM_KERNELS: Dict[str, Callable] = {
    "assign": _k_irm_assign,  # kw: domain (else every domain in turn)
    "assign_blocked": _k_irm_blocked,
    "ew_domain_alpha": _k_irm_ew,  # kw: a, b
    "grid_domain_alpha": _k_irm_grid,  # kw: prior, grid
}


def _irm_saturated(st) -> torch.Tensor:
    return torch.stack([(c > 0).all() for c in st.counts]).any()


# a family: kernel registry, score_joint, counts, assignments, is_saturated,
# the default keywords of its kernels given the data, and the host copy of a
# chunk's assignments
MIXTURE_FAMILY = dict(kernels=KERNELS, score_joint=state_mod.score_joint, counts=lambda st: st.counts,
                      assignments=lambda st: st.assignments, is_saturated=state_mod.is_saturated,
                      default_kw=lambda data: {}, host_assignments=_host_copy)
HDP_FAMILY = dict(kernels=HDP_KERNELS, score_joint=hdp.score_joint, counts=lambda st: st.topic_total,
                  assignments=lambda st: st.z, is_saturated=_hdp_saturated, default_kw=_hdp_default_kw,
                  host_assignments=_hdp_host_z)
IRM_FAMILY = dict(kernels=IRM_KERNELS, score_joint=irm_state.score_joint, counts=lambda st: torch.cat(st.counts),
                  assignments=lambda st: torch.cat(st.assignments), is_saturated=_irm_saturated,
                  default_kw=lambda data: {}, host_assignments=_host_copy)


def _family_of(state) -> dict:
    if isinstance(state, MixtureState):
        return MIXTURE_FAMILY
    if isinstance(state, hdp.HDPState):
        return HDP_FAMILY
    if isinstance(state, irm_state.IRMState):
        return IRM_FAMILY
    raise TypeError(f"no runner family for state type {type(state).__name__}")


def normalize_config(kernel_config: Sequence,
                     kernels: Optional[Dict[str, Callable]] = None) -> Tuple[Tuple[str, dict], ...]:
    """Accept ['assign_blocked'] or [('assign_blocked', {...})] mixes."""
    registry = KERNELS if kernels is None else kernels
    out: List[Tuple[str, dict]] = []
    for entry in kernel_config:
        if isinstance(entry, str):
            name, kw = entry, {}
        else:
            name, kw = entry
        validator.validate_one_of(name, registry, "kernel name")
        out.append((name, dict(kw)))
    return tuple(out)


def make_step(kernel_config: Sequence, data, family: Optional[dict] = None) -> Callable:
    """Compose a kernel config into one `step(state, generator) -> state`
    (the mixture family's unless `family` names another). A step is the
    span `runner.step`, each kernel in it the span `runner.<kernel>`."""
    family = MIXTURE_FAMILY if family is None else family
    kernels = family["kernels"]
    defaults = family["default_kw"](data)
    config = tuple((name, {**defaults, **kw}, f"runner.{name}")
                   for name, kw in normalize_config(kernel_config, kernels))

    def step(state, generator):
        with profiling.span("runner.step"):
            for name, kw, span_name in config:
                with profiling.span(span_name):
                    state = kernels[name](state, data, generator, **kw)
        return state

    return step


def _trace(family: dict, state, collect_assignments: bool) -> Dict[str, torch.Tensor]:
    counts = family["counts"](state)
    out = {"score": family["score_joint"](state), "k_active": (counts > 0).sum(), "counts": counts}
    if collect_assignments:
        out["assignments"] = family["assignments"](state)
    return out


def _run_loop(state, generator, step, family: dict, niters: int, collect_assignments: bool):
    traces = []
    for _ in range(niters):
        state = step(state, generator)
        traces.append(_trace(family, state, collect_assignments))
    stacked = {k: torch.stack([t[k] for t in traces]) for k in traces[0]}
    return state, stacked


class runner:
    """Reference-parity runner: r = runner(defn, data, state, config);
    r.run(generator, niters). Traces (assignments, joint score, active
    cluster count) are collected per sweep and exposed as host arrays.
    Drives a MixtureState through `KERNELS`, an HDPState through
    `HDP_KERNELS` (defn may be None there; data is its `TokenData`) and an
    IRMState through `IRM_KERNELS` (data: its relation views).

    jsonl_path: optional per-sweep record, one JSON line per sweep with the
    joint log score, the active-cluster count, the occupancy histogram and,
    on the last line of each `run`, the ESS of the whole score trace.
    """

    def __init__(self, defn, data, state, kernel_config, jsonl_path: Optional[str] = None):
        self._defn = defn
        self._data = data
        self._state = state
        self._family = _family_of(state)
        self._config = normalize_config(kernel_config, self._family["kernels"])
        self._step = make_step(self._config, data, self._family)
        assignments = self._family["assignments"](state)
        self._assign_width = int(assignments.shape[0])
        self._assignment_trace = []
        self._copy_stream = torch.cuda.Stream(assignments.device) if assignments.is_cuda else None
        self._copies = []  # events after which the host's assignment arrays are whole
        self._score_trace = []
        self._k_active_trace = []
        self._jsonl_path = jsonl_path
        self._sweep_idx = 0

    def run(self, generator: torch.Generator, niters: int = 1, collect: bool = True):
        validator.validate_positive(niters, "niters")
        self._state, trace = _run_loop(
            self._state, generator, self._step, self._family, int(niters), collect
        )
        if collect:
            with profiling.span("read.runner.trace"):
                z, copied = self._family["host_assignments"](trace["assignments"], self._state, self._copy_stream)
                self._assignment_trace.append(z)
                if copied is not None:
                    self._copies.append(copied)
                self._score_trace.append(trace["score"].cpu().numpy())
                self._k_active_trace.append(trace["k_active"].cpu().numpy())
        if self._jsonl_path is not None:
            self._write_jsonl(trace)
        self._warn_if_saturated()
        return self._state

    def _write_jsonl(self, trace):
        with profiling.span("read.runner.jsonl"):
            scores = trace["score"].cpu().numpy()
            k_active = trace["k_active"].cpu().numpy()
            counts = trace["counts"].cpu().numpy()
        full = self.score_trace
        ess = float(diagnostics.ess(full)) if full.shape[-1] >= 4 else None
        with open(self._jsonl_path, "a") as f:
            for i in range(scores.shape[0]):
                occ = counts[i][counts[i] > 0]
                f.write(json.dumps({
                    "sweep": self._sweep_idx,
                    "score_joint": float(scores[i]),
                    "k_active": int(k_active[i]),
                    "occupancy": np.sort(occ)[::-1].tolist(),
                    "ess": ess if i == scores.shape[0] - 1 else None,
                }) + "\n")
                self._sweep_idx += 1

    def _warn_if_saturated(self):
        if profiling.read(self._family["is_saturated"](self._state), "runner.saturated"):
            warnings.warn(
                "all cluster/topic slots are occupied: the sampler can no longer "
                "open new groups and the truncation may bias the posterior. "
                "Rebuild the state with more slots (k_max, n_topics).",
                RuntimeWarning,
                stacklevel=3,
            )

    def get_latent(self):
        return self._state

    @property
    def assignment_trace(self):
        if not self._assignment_trace:
            return np.zeros((0, self._assign_width), np.int32)
        for copied in self._copies:
            copied.synchronize()
        self._copies.clear()
        # the HDP family keeps a few bits a token; the trace reads as int32
        return np.concatenate([p.unpack() if isinstance(p, PackedZ) else p for p in self._assignment_trace])

    @property
    def score_trace(self):
        return np.concatenate(self._score_trace) if self._score_trace else np.zeros((0,))

    @property
    def k_active_trace(self):
        return (
            np.concatenate(self._k_active_trace)
            if self._k_active_trace
            else np.zeros((0,), np.int64)
        )


def run_chain(state, data, generator, niters, kernel_config, collect_assignments=True):
    """Functional one-shot: returns (final_state, trace dict of [T, ...] tensors)."""
    validator.validate_positive(niters, "niters")
    family = _family_of(state)
    step = make_step(kernel_config, data, family)
    return _run_loop(state, generator, step, family, int(niters), collect_assignments)
