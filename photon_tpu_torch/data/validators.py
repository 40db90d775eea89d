"""Row-level training-data sanity checks (port of
photon_tpu/data/validators.py: ``validate_labeled_batch`` and
``validate_game_batch``).

Finite features (a sparse shard's values), labels in the task's domain,
non-negative finite weights, finite offsets; VALIDATE_SAMPLE checks a
deterministic stride subsample. Each check is a reduction on the batch's
device, so only booleans come to the host.
"""

from __future__ import annotations

import enum
from typing import List, Optional

import torch

from photon_tpu_torch.data.batch import Features, LabeledBatch, SparseFeatures
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.types import TaskType


class DataValidationType(enum.Enum):
    """How much of the data to validate (reference DataValidators modes)."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


class DataValidationError(ValueError):
    """Raised when training data fails a sanity check."""


_SAMPLE_TARGET = 10_000


def _subsample(a: torch.Tensor, mode: DataValidationType) -> torch.Tensor:
    if mode != DataValidationType.VALIDATE_SAMPLE or a.shape[0] <= _SAMPLE_TARGET:
        return a
    stride = max(1, a.shape[0] // _SAMPLE_TARGET)
    return a[::stride]


def _check_finite(name: str, a: torch.Tensor, errors: List[str]) -> None:
    if not bool(torch.isfinite(a).all()):
        errors.append(f"{name} contains non-finite values")


def _values(feats: Features) -> torch.Tensor:
    """The values to check: a dense matrix, or a sparse one's (n, k) values."""
    return feats.values if isinstance(feats, SparseFeatures) else feats


def _check_labels(task: TaskType, y: torch.Tensor, errors: List[str]) -> None:
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        # Binary labels: 0/1 (the ±1 mapping happens inside the loss).
        if not bool(((y == 0.0) | (y == 1.0)).all()):
            errors.append(f"{task.value} requires binary labels in {{0, 1}}")
    elif task == TaskType.POISSON_REGRESSION:
        if not bool((y >= 0.0).all()):
            errors.append("POISSON_REGRESSION requires non-negative labels")
    else:  # LINEAR_REGRESSION: any finite label
        _check_finite("labels", y, errors)


def _check_common(label, weight, offset, task: TaskType, mode: DataValidationType, errors: List[str]) -> None:
    """Labels finite and in the task's domain, weights finite and
    non-negative, offsets finite."""
    y = _subsample(label, mode)
    _check_finite("labels", y, errors)
    if not errors:
        _check_labels(task, y, errors)
    w = _subsample(weight, mode)
    _check_finite("weights", w, errors)
    if not bool((w >= 0.0).all()):
        errors.append("weights must be non-negative")
    _check_finite("offsets", _subsample(offset, mode), errors)


def validate_labeled_batch(
    batch: LabeledBatch,
    task: TaskType,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
) -> None:
    """Sanity-check one single-shard batch; raises DataValidationError."""
    if mode == DataValidationType.VALIDATE_DISABLED:
        return
    errors: List[str] = []
    _check_common(batch.label, batch.weight, batch.offset, task, mode, errors)
    _check_finite("features", _subsample(_values(batch.features), mode), errors)
    if errors:
        raise DataValidationError("; ".join(errors))


def validate_game_batch(
    batch: GameBatch,
    task: TaskType,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
    feature_shards: Optional[List[str]] = None,
) -> None:
    """Sanity-check a GAME batch across all (or the given) feature shards;
    raises DataValidationError."""
    if mode == DataValidationType.VALIDATE_DISABLED:
        return
    errors: List[str] = []
    _check_common(batch.label, batch.weight, batch.offset, task, mode, errors)
    for shard in feature_shards or list(batch.features):
        _check_finite(f"features[{shard}]", _subsample(_values(batch.features[shard]), mode), errors)
    if errors:
        raise DataValidationError("; ".join(errors))
