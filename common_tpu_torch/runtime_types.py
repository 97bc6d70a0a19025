"""Runtime column-type schema (port of `common_tpu/runtime_types.py`).

The reference's runtime type system
(``common:include/microscopes/common/runtime_type.hpp`` /
``type_helper.hpp``) describes each data column by a primitive tag + an
optional fixed vector length. Here a column type is a (dtype, shape-suffix)
pair that maps onto a tensor of shape ``[N, *shape]``; the schema validates
and converts host data before it becomes a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from common_tpu_torch import validator


@dataclass(frozen=True)
class runtime_type:
    """A column schema entry: primitive dtype + per-row trailing shape.

    ``runtime_type(np.float32)`` — scalar column;
    ``runtime_type(np.float32, (3,))`` — fixed length-3 vector column
    (the reference's ``runtime_type(TYPE_F32, 3)``).
    """

    dtype: np.dtype
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        for s in self.shape:
            validator.validate_positive(s, "runtime_type.shape entry")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    def validate_column(self, arr: np.ndarray, name: str = "column") -> np.ndarray:
        """Check an [N, *shape] host array against this schema; returns it cast."""
        arr = np.asarray(arr)
        want = arr.shape[1:]
        if want != self.shape:
            raise ValueError(
                f"{name}: per-row shape {want} does not match schema {self.shape}"
            )
        return arr.astype(self.dtype, copy=False)


# Primitive aliases mirroring the reference's TYPE_* enum
TYPE_B = runtime_type(np.bool_)
TYPE_I8 = runtime_type(np.int8)
TYPE_I16 = runtime_type(np.int16)
TYPE_I32 = runtime_type(np.int32)
TYPE_I64 = runtime_type(np.int64)
TYPE_F32 = runtime_type(np.float32)
TYPE_F64 = runtime_type(np.float64)


def vector(base: runtime_type, n: int) -> runtime_type:
    """Fixed-length vector column of a primitive type."""
    validator.validate_positive(n, "vector length")
    return runtime_type(base.dtype, (n,))
