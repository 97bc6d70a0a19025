"""Utilities (port of `common_tpu/utils/`): MCMC diagnostics, numeric
helpers, tracing and timing. The JAX package's `debug`, `fastrand` and
`linalg` work around JAX and XLA and have no counterpart here."""

from common_tpu_torch.utils.util import (  # noqa: F401
    almost_eq,
    logsumexp,
    random_assignment_vector,
    random_orthonormal_matrix,
)
