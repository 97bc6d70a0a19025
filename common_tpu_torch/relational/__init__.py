"""Infinite Relational Model (port of `common_tpu/relational`, one device).

Public surface, as in the JAX package:
  model_definition, RelationDefinition, IRMDefinition, initialize, IRMState,
  RelView, as_views, score_assignment / score_likelihood / score_joint,
  pred_logpdf / predict_missing (link prediction),
  kernels.assign (exact collapsed Gibbs), kernels.sweep (blocked),
  kernels.domain_alpha_escobar_west / domain_alpha_grid,
  kernels.shard_cells / kernels.make_sharded_sweep (the blocked sweep with
  each relation's cells sharded over a `parallel.mesh.Mesh`'s data ranks).
"""

from common_tpu_torch.relational import kernels  # noqa: F401
from common_tpu_torch.relational.state import (  # noqa: F401
    IRMDefinition,
    IRMState,
    RelationDefinition,
    RelView,
    as_views,
    initialize,
    model_definition,
    pred_logpdf,
    predict_missing,
    score_assignment,
    score_joint,
    score_likelihood,
)
