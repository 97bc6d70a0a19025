"""Likelihood registry (port of `common_tpu/likelihoods/__init__.py`).

The conjugate zoo (bb, bbv, bnb, dd, dm, gp, nich, niw) and the
non-conjugate bbnc; see `base.py` for the interface.
"""

from common_tpu_torch.likelihoods.base import (  # noqa: F401
    Likelihood,
    fold,
    get,
    names,
    register,
    scatter_fold,
    zero_slot,
)
from common_tpu_torch.likelihoods.bb import bb  # noqa: F401
from common_tpu_torch.likelihoods.bbnc import bbnc  # noqa: F401
from common_tpu_torch.likelihoods.bbv import bbv  # noqa: F401
from common_tpu_torch.likelihoods.bnb import bnb  # noqa: F401
from common_tpu_torch.likelihoods.dd import dd  # noqa: F401
from common_tpu_torch.likelihoods.dm import dm  # noqa: F401
from common_tpu_torch.likelihoods.gp import gp  # noqa: F401
from common_tpu_torch.likelihoods.nich import nich  # noqa: F401
from common_tpu_torch.likelihoods.niw import niw  # noqa: F401
