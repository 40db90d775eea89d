"""Pointwise GLM losses l(z, y) with derivatives in the margin z.

Port of photon_tpu/ops/losses.py: the same four losses in the same stable
forms (softplus for the logistic loss, the ±1 label mapping for the smoothed
hinge). Binary labels are 0/1 in data. ``kernel_id`` names the loss inside
the CUDA kernels (csrc/glm_common.h, LossId).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    name: str
    value: Callable[[Tensor, Tensor], Tensor]
    dz: Callable[[Tensor, Tensor], Tensor]
    dzz: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]
    kernel_id: int


def _softplus(z: Tensor) -> Tensor:
    # log(1 + e^z) without overflow (jax.nn.softplus's exact value).
    return torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z)))


def _logistic_dzz(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LogisticLoss = PointwiseLoss(
    name="logisticLoss",
    value=lambda z, y: _softplus(z) - y * z,
    dz=lambda z, y: torch.sigmoid(z) - y,
    dzz=_logistic_dzz,
    mean=torch.sigmoid,
    kernel_id=0,
)

SquaredLoss = PointwiseLoss(
    name="squaredLoss",
    value=lambda z, y: 0.5 * (z - y) * (z - y),
    dz=lambda z, y: z - y,
    dzz=lambda z, y: torch.ones_like(z),
    mean=lambda z: z,
    kernel_id=1,
)

PoissonLoss = PointwiseLoss(
    name="poissonLoss",
    value=lambda z, y: torch.exp(z) - y * z,
    dz=lambda z, y: torch.exp(z) - y,
    dzz=lambda z, y: torch.exp(z),
    mean=torch.exp,
    kernel_id=2,
)


def _to_pm1(y: Tensor) -> Tensor:
    """Map {0,1} labels to {-1,+1}; ±1 labels pass through."""
    return torch.where(y > 0, 1.0, -1.0).to(y.dtype)


def _smoothed_hinge_value(z: Tensor, y: Tensor) -> Tensor:
    # Rennie's smoothed hinge on t = y z (y in ±1).
    t = _to_pm1(y) * z
    quad = 0.5 * torch.square(torch.clamp(1.0 - t, min=0.0))
    return torch.where(t <= 0.0, 0.5 - t, torch.where(t < 1.0, quad, torch.zeros_like(t)))


def _smoothed_hinge_dz(z: Tensor, y: Tensor) -> Tensor:
    s = _to_pm1(y)
    t = s * z
    dt = torch.where(t <= 0.0, -1.0, torch.where(t < 1.0, t - 1.0, 0.0))
    return s * dt


def _smoothed_hinge_dzz(z: Tensor, y: Tensor) -> Tensor:
    t = _to_pm1(y) * z
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


SmoothedHingeLoss = PointwiseLoss(
    name="smoothedHingeLoss",
    value=_smoothed_hinge_value,
    dz=_smoothed_hinge_dz,
    dzz=_smoothed_hinge_dzz,
    mean=lambda z: z,
    kernel_id=3,
)


_TASK_LOSSES = {
    TaskType.LOGISTIC_REGRESSION: LogisticLoss,
    TaskType.LINEAR_REGRESSION: SquaredLoss,
    TaskType.POISSON_REGRESSION: PoissonLoss,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLoss,
}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    """Task → loss (reference ObjectiveFunctionHelper.scala:40-70)."""
    return _TASK_LOSSES[task]
