"""Chain parallelism on one device (port of `common_tpu/parallel/`, chains only)."""

from common_tpu_torch.parallel.chains import stack_states, unstack_state, vmap_sweep  # noqa: F401

__all__ = ["stack_states", "unstack_state", "vmap_sweep"]
