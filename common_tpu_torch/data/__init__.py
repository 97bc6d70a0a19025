"""Data layer (port of `common_tpu/data`): the tabular, variadic and sparse dataviews."""

from common_tpu_torch.data.recarray import numpy_dataview  # noqa: F401
from common_tpu_torch.data.sparse import sparse_ndarray_dataview  # noqa: F401
from common_tpu_torch.data.variadic import variadic_dataview  # noqa: F401
