"""Feature normalization folded into the objective (port of
photon_tpu/data/normalization.py).

With factors f and shifts s the normalized margin is
x'·w = x·(f∘w) − s·(f∘w): training needs only the effective coefficients
ew = f∘w and the scalar total shift es = −s·ew. The intercept keeps factor 1
and shift 0, and absorbs es when coefficients go back to the model space.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_tpu_torch.types import NormalizationType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def effective(self, w: Tensor) -> Tuple[Tensor, Tensor]:
        """(ew, es): effective coefficients and total scalar shift. Here and
        in the space conversions w may carry leading (entity) axes."""
        ew = w if self.factors is None else w * self.factors
        es = torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device) if self.shifts is None \
            else -(ew @ self.shifts)
        return ew, es

    def transformed_to_model_space(self, w: Tensor) -> Tensor:
        """Coefficients trained against normalized features, in the original
        feature space."""
        ew, es = self.effective(w)
        if self.intercept_index is not None and self.shifts is not None:
            ew = ew.clone()
            ew[..., self.intercept_index] += es
        return ew

    def model_to_transformed_space(self, w: Tensor) -> Tensor:
        out = w
        if self.intercept_index is not None and self.shifts is not None:
            out = out.clone()
            out[..., self.intercept_index] += w @ self.shifts
        if self.factors is not None:
            out = out / self.factors
        return out


def _safe_inv(a: Tensor) -> Tensor:
    return torch.where(a > 0, 1.0 / torch.where(a > 0, a, torch.ones_like(a)), torch.ones_like(a))


def build_normalization_context(
    norm_type: NormalizationType,
    mean: Tensor,
    std: Tensor,
    max_magnitude: Tensor,
    intercept_index: Optional[int],
) -> NormalizationContext:
    """Context from feature statistics (reference NormalizationContextFactory):

    - SCALE_WITH_STANDARD_DEVIATION: factor = 1/std
    - SCALE_WITH_MAX_MAGNITUDE:      factor = 1/max|x|
    - STANDARDIZATION:               factor = 1/std, shift = mean (requires intercept)

    A zero statistic gives factor 1; the intercept is pinned to factor 1,
    shift 0.
    """
    if norm_type == NormalizationType.NONE:
        return NormalizationContext(None, None, intercept_index)
    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors = _safe_inv(std)
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors = _safe_inv(torch.abs(max_magnitude))
    elif norm_type == NormalizationType.STANDARDIZATION:
        if intercept_index is None:
            raise ValueError("STANDARDIZATION requires an intercept feature")
        factors = _safe_inv(std)
    else:
        raise ValueError(f"unknown normalization type {norm_type}")

    shifts = mean.clone() if norm_type == NormalizationType.STANDARDIZATION else None
    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    return NormalizationContext(factors, shifts, intercept_index)
