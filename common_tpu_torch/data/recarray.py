"""Tabular (recarray) dataview (port of `common_tpu/data/recarray.py`).

Reference analog: ``common:include/microscopes/common/recarray/dataview.hpp``
+ ``_dataview.pyx`` (`numpy_dataview(recarray)`): a read-only view over
numpy structured or masked arrays.

Columns become a tuple of ``(values [N, ...], mask [N])`` tensors on one
device, the `data` layout every kernel consumes. Ingestion is host-side;
per-element masks on vector cells reduce to a row mask with "any missing
element masks the cell" semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from common_tpu_torch import validator
from common_tpu_torch.state import MixtureDefinition


class numpy_dataview:
    """Columns-of-tensors view over tabular host data, on `device`.

    Accepts, as the reference does:
      - a numpy structured array (one field per feature), optionally
        ``numpy.ma`` masked;
      - a list or tuple of per-feature arrays ([N] or [N, d]), optionally
        masked arrays;
      - one plain array, a single feature.

    ``.columns`` is ``tuple[(values, mask), ...]`` with float32 0/1 masks
    (1 = observed): the `data` argument of every kernel. With `defn`, each
    column is checked and cast by its model's runtime type first. The
    columns go to the card unless `device` names another; without a card
    the default raises.
    """

    def __init__(self, arr, defn: Optional[MixtureDefinition] = None, device="cuda"):
        if isinstance(arr, (list, tuple)):
            cols = [self._one_column(a) for a in arr]
        elif isinstance(arr, np.ndarray) and arr.dtype.names:
            cols = [self._one_column(arr[name]) for name in arr.dtype.names]
        elif isinstance(arr, np.ndarray):
            cols = [self._one_column(arr)]
        else:
            raise ValueError(f"unsupported data input of type {type(arr).__name__}")
        ns = {c[0].shape[0] for c in cols}
        if len(ns) != 1:
            raise ValueError(f"columns disagree on row count: {sorted(ns)}")
        self._n = ns.pop()
        if defn is not None:
            validator.validate_len(cols, defn.nfeatures, "data columns")
            cols = [(d.rtype.validate_column(v, f"column {i}"), m)
                    for i, ((v, m), d) in enumerate(zip(cols, defn.models))]
        self.columns: Tuple = tuple(
            (torch.from_numpy(np.ascontiguousarray(v)).to(device), torch.from_numpy(m).to(device))
            for v, m in cols
        )

    @staticmethod
    def _one_column(a):
        """(values, float32 mask) host arrays of one column."""
        if np.ma.isMaskedArray(a):
            mask_elems = np.ma.getmaskarray(a)
            row_missing = (mask_elems if mask_elems.ndim == 1
                           else mask_elems.reshape(mask_elems.shape[0], -1).any(axis=1))
            return np.ascontiguousarray(np.ma.getdata(a)), (~row_missing).astype(np.float32)
        values = np.ascontiguousarray(a)
        return values, np.ones(len(values), np.float32)

    def size(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def view(self):
        """The kernel-facing representation (tuple of (values, mask))."""
        return self.columns

    def toarray(self) -> list:
        """Host round trip (masked numpy arrays), for tests and debugging."""
        out = []
        for v, m in self.columns:
            vv = v.cpu().numpy()
            mm = m.cpu().numpy() == 0.0
            if vv.ndim > 1:
                mm = np.broadcast_to(mm.reshape(-1, *([1] * (vv.ndim - 1))), vv.shape)
            out.append(np.ma.masked_array(vv, mask=mm))
        return out
