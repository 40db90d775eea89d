"""Generalized linear models (port of photon_tpu/models/glm.py).

One class parameterized by TaskType; the mean function comes from the
task's PointwiseLoss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    coefficients: Coefficients
    task: TaskType

    @staticmethod
    def zeros(dim: int, task: TaskType, dtype=torch.float32, device="cpu") -> "GeneralizedLinearModel":
        return GeneralizedLinearModel(Coefficients(torch.zeros(dim, dtype=dtype, device=device)), task)

    def compute_score(self, features: Tensor) -> Tensor:
        """Raw margin x·w."""
        return self.coefficients.compute_score(features)

    def compute_scores(self, batch: LabeledBatch) -> Tensor:
        """Margins including the batch offsets."""
        return self.compute_score(batch.features) + batch.offset

    def compute_mean(self, features: Tensor, offset: Optional[Tensor] = None) -> Tensor:
        """E[y|x]: the task's inverse link applied to the margin."""
        z = self.compute_score(features)
        if offset is not None:
            z = z + offset
        return loss_for_task(self.task).mean(z)

    def predict_class(self, features: Tensor, threshold: float = 0.5) -> Tensor:
        """Binary decision for the classification tasks."""
        if self.task == TaskType.LOGISTIC_REGRESSION:
            return (self.compute_mean(features) > threshold).to(torch.int32)
        if self.task == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
            return (self.compute_score(features) > 0).to(torch.int32)
        raise ValueError(f"{self.task} is not a classification task")
