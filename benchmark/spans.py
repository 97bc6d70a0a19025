"""Ranges around the program's Python entries, opened from the benchmark.

`Spans.wrap(owner, attr, name)` replaces `owner.attr` (or `owner[attr]`
for a dict such as the runner's kernel registry) by a wrapper that opens a
`torch.profiler.record_function(name)` range while `tracing` is set (no
range where `name` is None), and calls the driver's `before` and `after`
hooks, with which a driver keeps
what the timed path produced for the comparison. The program looks its
entries up by name at each call (the runner its `KERNELS`, `kernels/
blocked.py` the ops it imports), so the wrapper sees every call. Device
time is attributed to the range by where each kernel was launched, so it
stays the op's time whatever implements it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

from torch.profiler import record_function


def _get(owner, attr):
    return owner[attr] if isinstance(owner, dict) else getattr(owner, attr)


def _set(owner, attr, value) -> None:
    if isinstance(owner, dict):
        owner[attr] = value
    else:
        setattr(owner, attr, value)


class Spans:
    def __init__(self):
        self.tracing = False
        self.names: list[str] = []
        self._undo: list[tuple[Any, str, Any]] = []

    def wrap(self, owner, attr: str, name: Optional[str], before: Optional[Callable] = None,
             after: Optional[Callable] = None) -> None:
        fn = _get(owner, attr)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            if self.tracing and name is not None:
                with record_function(name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if after is not None:
                after(args, kwargs, out)
            return out

        _set(owner, attr, wrapper)
        self._undo.append((owner, attr, fn))
        if name is not None:
            self.names.append(name)

    def restore(self) -> None:
        """Put every wrapped entry back, last wrapped first."""
        while self._undo:
            owner, attr, fn = self._undo.pop()
            _set(owner, attr, fn)
