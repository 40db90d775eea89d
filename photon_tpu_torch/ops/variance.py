"""Coefficient variances (port of photon_tpu/ops/variance.py).

SIMPLE inverts the Hessian diagonal element-wise; FULL takes the diagonal
of the inverse Hessian through a Cholesky solve.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.types import VarianceComputationType

Tensor = torch.Tensor


def coefficient_variances(
    objective: GLMObjective,
    w: Tensor,
    batch: LabeledBatch,
    variance_type: VarianceComputationType,
) -> Optional[Tensor]:
    """Per-coefficient variances of the trained GLM, or None for NONE.

    SIMPLE: 1 / diag(H), one pass over X, O(d) memory.
    FULL:   diag(H⁻¹) via Cholesky, O(d²) memory.
    """
    if variance_type == VarianceComputationType.NONE:
        return None
    if variance_type == VarianceComputationType.SIMPLE:
        return 1.0 / torch.clamp(objective.hessian_diagonal(w, batch), min=1e-12)
    if variance_type == VarianceComputationType.FULL:
        return full_hessian_variances(objective.hessian_matrix(w, batch))
    raise ValueError(f"unknown variance type {variance_type!r}")


def full_hessian_variances(H: Tensor) -> Tensor:
    """diag(H⁻¹) through a Cholesky solve against I.

    A Hessian that is not positive definite (an unpenalized dead feature)
    has no Cholesky factor: the factor is taken as all NaN, as the
    reference's is, and every coordinate whose result is not finite falls
    back to the SIMPLE estimate, so one degenerate column cannot poison the
    whole vector.
    """
    d = H.shape[-1]
    chol, info = torch.linalg.cholesky_ex(H)
    chol = torch.where((info == 0)[..., None, None], chol, float("nan"))
    inv = torch.cholesky_solve(torch.eye(d, dtype=H.dtype, device=H.device).expand_as(H), chol)
    full = torch.diagonal(inv, dim1=-2, dim2=-1)
    simple = 1.0 / torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12)
    return torch.where(torch.isfinite(full), full, simple)


def normalize_variance_type(value) -> VarianceComputationType:
    """Accept enum, string, bool (legacy --compute-variance flags), or None."""
    if isinstance(value, VarianceComputationType):
        return value
    if value is None or value is False:
        return VarianceComputationType.NONE
    if value is True:
        return VarianceComputationType.SIMPLE
    return VarianceComputationType(str(value).upper())
