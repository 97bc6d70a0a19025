"""Chain stacks on one device and the (chains x data) process mesh (port of
`common_tpu/parallel/`)."""

from common_tpu_torch.parallel.chains import stack_states, unstack_state, vmap_sweep  # noqa: F401
from common_tpu_torch.parallel.mesh import (  # noqa: F401
    CHAINS,
    DATA,
    data_pspec,
    init_distributed,
    make_mesh,
    shard_state,
    state_pspec,
)
from common_tpu_torch.parallel.sharded import (  # noqa: F401
    chain_generators,
    gather_chain,
    initialize_chains,
    make_sharded_sweep,
)
from common_tpu_torch.parallel.scaling import measure_row_scaling  # noqa: F401

__all__ = [
    "CHAINS", "DATA", "chain_generators", "data_pspec", "gather_chain", "init_distributed",
    "initialize_chains", "make_mesh", "make_sharded_sweep", "measure_row_scaling", "shard_state",
    "stack_states", "state_pspec", "unstack_state", "vmap_sweep",
]
