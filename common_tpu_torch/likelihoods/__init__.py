"""Likelihood registry (port of `common_tpu/likelihoods/__init__.py`).

This port registers `niw` and `bbv`; see `base.py` for the interface.
"""

from common_tpu_torch.likelihoods.base import (  # noqa: F401
    Likelihood,
    get,
    names,
    register,
)
from common_tpu_torch.likelihoods.bbv import bbv  # noqa: F401
from common_tpu_torch.likelihoods.niw import niw  # noqa: F401
