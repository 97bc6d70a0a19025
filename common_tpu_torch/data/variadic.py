"""Variadic (ragged-row) dataview (port of `common_tpu/data/variadic.py`).

Reference analog: ``common:include/microscopes/common/variadic/dataview.hpp``
+ ``_dataview.pyx`` (`numpy_dataview(list_of_arrays)`): the LDA data layer.

Ragged rows become a CSR-style flat layout with fixed shapes,
``(tokens [T_pad], row_ptr [N+1], token_mask [T_pad], doc_ids [T_pad])``,
so per-document reductions are scatter-adds over one flat token axis.
Padding slots carry mask 0 and document id N, one past the last row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from common_tpu_torch import validator


class variadic_dataview:
    """Flat CSR view over a list of variable-length integer or float rows.

    The tensors go to the card unless `device` names another; without a
    card the default raises. Row lengths stay on the host.
    """

    def __init__(self, rows: Sequence, pad_to: Optional[int] = None, device="cuda"):
        validator.validate_nonempty(rows, "rows")
        lengths = np.array([len(r) for r in rows], np.int32)
        total = int(lengths.sum())
        cap = int(pad_to) if pad_to is not None else total
        if cap < total:
            raise ValueError(f"pad_to={cap} < total token count {total}")
        flat = np.concatenate([np.asarray(r) for r in rows]) if total else np.array([])
        pad = cap - total
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
        row_ptr = np.zeros(len(rows) + 1, np.int32)
        np.cumsum(lengths, out=row_ptr[1:])
        mask = np.arange(cap) < total
        # per-token document id, the segment key of doc-level reductions
        doc_ids = np.repeat(np.arange(len(rows), dtype=np.int32), lengths)
        if pad:
            doc_ids = np.concatenate([doc_ids, np.full(pad, len(rows), np.int32)])

        self.tokens = torch.from_numpy(flat).to(device)
        self.row_ptr = torch.from_numpy(row_ptr).to(device)
        self.token_mask = torch.from_numpy(mask.astype(np.float32)).to(device)
        self.doc_ids = torch.from_numpy(doc_ids).to(device)
        self._n = len(rows)
        self._lengths = lengths
        self._row_ptr = row_ptr

    def size(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def rowsize(self, i: int) -> int:
        return int(self._lengths[i])

    def row(self, i: int) -> np.ndarray:
        """Host-side row extraction (tests, debugging)."""
        lo, hi = int(self._row_ptr[i]), int(self._row_ptr[i + 1])
        return self.tokens[lo:hi].cpu().numpy()

    def toarray(self) -> list:
        return [self.row(i) for i in range(self._n)]
