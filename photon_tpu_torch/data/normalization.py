"""Feature normalization folded into the objective (port of
photon_tpu/data/normalization.py::NormalizationContext).

With factors f and shifts s the normalized margin is
x'·w = x·(f∘w) − s·(f∘w): training needs only the effective coefficients
ew = f∘w and the scalar total shift es = −s·ew.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def effective(self, w: Tensor) -> Tuple[Tensor, Tensor]:
        """(ew, es): effective coefficients and total scalar shift."""
        ew = w if self.factors is None else w * self.factors
        es = torch.zeros((), dtype=w.dtype, device=w.device) if self.shifts is None \
            else -torch.dot(self.shifts, ew)
        return ew, es
