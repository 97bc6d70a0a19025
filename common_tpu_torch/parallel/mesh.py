"""A (chains x data) process mesh over `torch.distributed` (port of
`common_tpu/parallel/mesh.py`).

The JAX package lays a `jax.sharding.Mesh` with named axes over its devices:

  chains  independent MCMC chains (no communication between them)
  data    row sharding of the likelihood and suffstat work

and expresses every exchange as an XLA collective. Here each device is one
process of a `torch.distributed` job, rank = chain_index * data + data_index,
and the mesh is a small object over the process group: its shape, this
rank's coordinates, one subgroup per chain row for the reductions over
`data` (built with `dist.new_group` on every rank in the same order), and
the rank's device.

The caller names the backend; nothing picks one for it:

  "nccl"  every rank has its own card, `cuda:{LOCAL_RANK}`;
  "gloo"  CPU processes, and ranks that share one card.

Only `all_reduce`, `all_gather` and `broadcast` are used, which gloo takes
on CUDA tensors as well (it stages them through the host itself; checked on
an H100 with two ranks on one card), so no collective here copies to the
host by hand.

    init_distributed("nccl")                   # torchrun's environment
    mesh = make_mesh(chains=1, data=4, backend="nccl")
    states, data = shard_state(mesh, states, data)
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from common_tpu_torch import validator
from common_tpu_torch.parallel.chains import map_tensors
from common_tpu_torch.rng import shard_generator

CHAINS, DATA = "chains", "data"
BACKENDS = ("nccl", "gloo")

# Environment markers of a launched multi-process job (torchrun / torch
# elastic): an init failure then raises, never degrades to one process
# (each process would compute the whole job alone).
_DIST_ENV_MARKERS = (
    "TORCHELASTIC_RUN_ID",
    "TORCHELASTIC_RESTART_COUNT",
    "GROUP_RANK",
    "LOCAL_WORLD_SIZE",
    "MASTER_ADDR",
    "MASTER_PORT",
)


def _distributed_env_detected() -> bool:
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        return True
    return any(os.environ.get(k) for k in _DIST_ENV_MARKERS)


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> int:
    """Initialise the default process group once; returns this process's rank.

    With no arguments it reads torchrun's environment (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`); or pass `init_method`
    (e.g. "file:///path/store" or "tcp://localhost:29500"), `world_size`
    and `rank`. Already initialised: returns the rank.

    Failure policy (as the JAX package's): an init error re-raises when a
    distributed job is detectable (any explicit argument, WORLD_SIZE > 1,
    a torchrun / elastic variable). Otherwise it warns and initialises a
    one-process group, rank 0, over an in-memory store.
    """
    validator.validate_one_of(backend, BACKENDS, "backend")
    if dist.is_initialized():
        return dist.get_rank()
    given = {k: v for k, v in (("init_method", init_method), ("world_size", world_size), ("rank", rank))
             if v is not None}
    try:
        dist.init_process_group(backend, **(given or {"init_method": "env://"}))
    except (RuntimeError, ValueError) as e:
        if given or _distributed_env_detected():
            raise
        warnings.warn(
            f"torch.distributed init failed with no distributed environment detected ({e!r}); "
            "falling back to a single-process group (rank 0)",
            RuntimeWarning, stacklevel=2,
        )
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    return dist.get_rank()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (chains, data) mesh over the default process group."""

    shape: tuple            # (chains, data)
    chain_index: int
    data_index: int
    data_group: object      # the process group of this rank's chain row
    device: torch.device
    axis_names = (CHAINS, DATA)

    @property
    def chains(self) -> int:
        return self.shape[0]

    @property
    def data(self) -> int:
        return self.shape[1]

    @property
    def rank(self) -> int:
        return self.chain_index * self.data + self.data_index

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, chain_index={self.chain_index}, "
                f"data_index={self.data_index}, device={self.device})")


def _rank_device(backend: str, device) -> torch.device:
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
        want = torch.device("cuda", local)
        if device is not None and torch.device(device) != want:
            raise ValueError(f"nccl ranks each own a card: this rank's is {want}, not {device}")
        return want
    return torch.device("cuda" if device is None else device)


def make_mesh(chains: int = 1, data: int = 1, backend: Optional[str] = None, device=None) -> Mesh:
    """The (chains, data) mesh over the default process group.

    backend must be named ("nccl" or "gloo") and equal the group's;
    init_distributed(backend) is called first if no group exists. The
    world size must be chains * data. device: the rank's device, for gloo
    the card unless the caller names another ("cpu" for CPU processes);
    for nccl always `cuda:{LOCAL_RANK}`.
    """
    validator.validate_positive(chains, "chains")
    validator.validate_positive(data, "data")
    if backend is None:
        raise ValueError(f"make_mesh needs the backend named: one of {BACKENDS}")
    init_distributed(backend)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    world = dist.get_world_size()
    if world != chains * data:
        raise ValueError(f"a {chains}x{data} mesh needs {chains * data} processes, the group has {world}")
    rank = dist.get_rank()
    groups = [dist.new_group(list(range(c * data, (c + 1) * data))) for c in range(chains)]
    dev = _rank_device(backend, device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return Mesh((chains, data), rank // data, rank % data, groups[rank // data], dev)


# ---------------------------------------------------------------------------
# placement: what each rank keeps
# ---------------------------------------------------------------------------
def state_pspec(state) -> dict:
    """The mesh axes each leaf of a chain-stacked MixtureState is split over.

    assignments [C, N] over (chains, data); every other leaf (counts,
    stats, hypers, cluster_hp) over chains only: each data rank keeps its
    chains' whole global suffstats (O(K x suffstat), kept equal by an
    all_reduce over `data` every sweep).
    """
    del state
    return {"assignments": (CHAINS, DATA), "*": (CHAINS,)}


def data_pspec(data) -> tuple:
    """Columns split their row axis over `data`; every chain row holds them all."""
    return tuple(((DATA,), (DATA,)) for _ in data)


def _span(total: int, parts: int, index: int, what: str):
    if total % parts:
        raise ValueError(f"{what} {total} must divide over {parts} mesh ranks")
    size = total // parts
    return index * size, (index + 1) * size


def row_span(mesh: Mesh, n: int):
    """This rank's rows [r0, r1) of n (n must divide over the data ranks)."""
    return _span(n, mesh.data, mesh.data_index, "rows")


def chain_span(mesh: Mesh, n_chains: int):
    """This rank's chains [c0, c1) of n_chains (must divide over the chain ranks)."""
    return _span(n_chains, mesh.chains, mesh.chain_index, "chains")


def data_generator(mesh: Mesh, generator: torch.Generator) -> torch.Generator:
    """The generator of this rank's own draws over its data shard (its rows',
    tokens' or docs' noise), given the chain's generator, seeded alike on
    every data rank.

    One data rank: `generator` itself, so a sharded sweep at world size 1
    draws what the one-device sweep draws. Several: `rng.shard_generator`
    of `generator` and the rank's data index, so each rank draws only for
    its shard, from a stream no other rank shares, and `generator` advances
    alike on every rank.
    """
    return generator if mesh.data == 1 else shard_generator(generator, mesh.data_index)


def shard_state(mesh: Mesh, state, data):
    """This rank's shard of a chain-stacked state and of the data columns, on
    the mesh's device: its chains (all leaves), their assignments at its
    rows, and its rows of every column."""
    c0, c1 = chain_span(mesh, state.counts.shape[0])
    r0, r1 = row_span(mesh, state.assignments.shape[-1])
    local = map_tensors(lambda t: t[c0:c1].to(mesh.device), state)
    local = dataclasses.replace(local, assignments=state.assignments[c0:c1, r0:r1].to(mesh.device).contiguous())
    cols = tuple((x[r0:r1].to(mesh.device).contiguous(), m[r0:r1].to(mesh.device).contiguous())
                 for x, m in data)
    return local, cols


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce_sum(tensors, group):
    """Sums of the tensors over the group's ranks, as new tensors.

    One all_reduce per dtype: the tensors of a dtype travel flattened in
    one buffer.
    """
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.reshape(tensors[i].shape)
    return out


def require_equal_shards(mesh: Mesh, n_local: int, what: str) -> None:
    """Every data rank of this rank's chain row holds n_local `what`s (one
    all_gather), or ValueError."""
    sizes = all_gather_cat(torch.tensor([n_local], device=mesh.device), mesh.data_group)
    if not bool((sizes == n_local).all()):
        raise ValueError(f"data ranks hold unequal {what} counts {sizes.tolist()}: {what}s must divide over data")


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of t over the group's ranks, as a new tensor."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors of equal shape concatenated along the first axis, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def spawn(fn, args: tuple, nprocs: int, timeout_s: float) -> None:
    """Run fn(rank, *args) in nprocs processes started by the spawn method
    and wait for all of them. A rank that raises or dies raises here; past
    timeout_s every process is killed and TimeoutError raised."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} still running after {timeout_s} s")
