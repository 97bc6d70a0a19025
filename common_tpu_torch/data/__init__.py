"""Data layer (port of `common_tpu/data`): the tabular and variadic dataviews."""

from common_tpu_torch.data.recarray import numpy_dataview  # noqa: F401
from common_tpu_torch.data.variadic import variadic_dataview  # noqa: F401
