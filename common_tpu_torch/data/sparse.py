"""Sparse N-d relation dataview (port of `common_tpu/data/sparse.py`).

Reference analog:
``common:include/microscopes/common/sparse_ndarray/dataview.hpp`` +
``_dataview.pyx``: the IRM data layer, the observed cells of an
N-dimensional (usually 2-D) relation with their index tuples, from a dense
array with a missing-mask or from sparse COO triples.

Observed cells become COO triples padded to a fixed length,
``(indices [M_pad, ndim] int32, values [M_pad], mask [M_pad] float32)``,
so relation scans are flat gathers and scatter-adds over the cell axis.
Padding cells carry index 0 and mask 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from common_tpu_torch import validator


class sparse_ndarray_dataview:
    """COO view over an N-dim relation.

    Construct from either:
      - a dense array + optional boolean missing-mask (True = missing), or a
        numpy masked array, or
      - explicit (indices [M, ndim], values [M], shape).

    The tensors go to the card unless `device` names another; without a
    card the default raises.
    """

    def __init__(
        self,
        dense: Optional[np.ndarray] = None,
        missing_mask: Optional[np.ndarray] = None,
        indices: Optional[np.ndarray] = None,
        values: Optional[np.ndarray] = None,
        shape: Optional[Tuple[int, ...]] = None,
        pad_to: Optional[int] = None,
        device="cuda",
    ):
        if dense is not None:
            if np.ma.isMaskedArray(dense):
                missing_mask = np.ma.getmaskarray(dense)
                dense = np.ma.getdata(dense)
            dense = np.asarray(dense)
            observed = (
                np.ones(dense.shape, bool)
                if missing_mask is None
                else ~np.asarray(missing_mask, bool)
            )
            idx = np.argwhere(observed).astype(np.int32)
            vals = dense[observed]
            shape = dense.shape
        else:
            validator.validate_not_none(indices, "indices")
            validator.validate_not_none(values, "values")
            validator.validate_not_none(shape, "shape")
            idx = np.asarray(indices, np.int32)
            vals = np.asarray(values)
            if idx.ndim != 2 or idx.shape[0] != len(vals):
                raise ValueError(
                    f"indices {idx.shape} inconsistent with values {vals.shape}"
                )

        m = len(vals)
        cap = int(pad_to) if pad_to is not None else m
        if cap < m:
            raise ValueError(f"pad_to={cap} < observed cell count {m}")
        pad = cap - m
        if pad:
            idx = np.concatenate([idx, np.zeros((pad, idx.shape[1]), np.int32)])
            vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
        mask = (np.arange(cap) < m).astype(np.float32)

        self.shape = tuple(int(s) for s in shape)
        self.indices = torch.from_numpy(idx).to(device)
        self.values = torch.from_numpy(np.ascontiguousarray(vals)).to(device)
        self.mask = torch.from_numpy(mask).to(device)
        self._nobserved = m
        # per-entity cell index and blocked-table cell order of the relational
        # kernels, built on first use
        self.entity_cells = {}
        self.cell_orders = {}

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def nobserved(self) -> int:
        return self._nobserved

    def __len__(self) -> int:
        return self._nobserved

    def todense(self, fill=0) -> np.ma.MaskedArray:
        """Host round trip as a masked dense array (tests, debugging)."""
        vals = self.values[: self._nobserved].cpu().numpy()
        idx = self.indices[: self._nobserved].cpu().numpy()
        dense = np.full(self.shape, fill, vals.dtype)
        missing = np.ones(self.shape, bool)
        dense[tuple(idx.T)] = vals
        missing[tuple(idx.T)] = False
        return np.ma.masked_array(dense, mask=missing)
