"""The two precisions the reference runs in.

`REFERENCE` computes in float64. `CONTROL` computes in TF32, the nearest
precision below the float32-with-TF32-off that the configurations state:
every operand of a stage is rounded to TF32 (10 explicit mantissa bits,
round to nearest, ties away from zero, as `cvt.rna.tf32.f32` does) and
the arithmetic runs in float32, which is what a TF32 tensor-core product
does to its inputs. The control is the reference put in the program's
place in the lower precision; it has to fail the comparison.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 and held in float32 (infinities and NaNs aside)."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    round: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, x) -> torch.Tensor:
        """An operand in this precision."""
        return self.round(torch.as_tensor(x).to(self.dtype))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b with both operands in this precision (float32 sums for TF32)."""
        return self(a) @ self(b)


REFERENCE = Precision("float64", torch.float64, lambda x: x)
CONTROL = Precision("tf32", torch.float32, tf32_round)
