"""HDP-LDA topic modelling (port of `common_tpu/topic`, single device)."""

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
    perplexity,
    sample_beta,
    sample_concentrations,
    score_joint,
    token_data,
)
from common_tpu_torch.topic import svi  # noqa: F401
