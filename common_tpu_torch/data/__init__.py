"""Data layer (port of `common_tpu/data`): the tabular dataview."""

from common_tpu_torch.data.recarray import numpy_dataview  # noqa: F401
