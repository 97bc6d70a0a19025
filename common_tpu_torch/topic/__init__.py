"""HDP-LDA topic modelling (port of `common_tpu/topic`), with the token- and
doc-sharded sweeps over a `parallel.mesh.Mesh`."""

from common_tpu_torch.topic.hdp import (  # noqa: F401
    HDPState,
    TokenData,
    blocked_sweep,
    blocked_sweep_dense,
    collapsed_sweep,
    crt_sample,
    dense_token_data,
    densify_corpus,
    initialize,
    make_sharded_sweep,
    make_sharded_sweep_dense,
    perplexity,
    sample_beta,
    sample_concentrations,
    score_joint,
    shard_corpus,
    shard_dense_corpus,
    token_data,
)
from common_tpu_torch.topic import svi  # noqa: F401
