"""Core enums (copied from photon_tpu/types.py; the port does not import it)."""

from __future__ import annotations

import enum


class TaskType(enum.Enum):
    """Supported GLM training tasks (reference TaskType.scala)."""

    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"


class ConvergenceReason(enum.Enum):
    """Why an optimizer stopped (reference util/ConvergenceReason.scala)."""

    MAX_ITERATIONS = "MAX_ITERATIONS"
    FUNCTION_VALUES_CONVERGED = "FUNCTION_VALUES_CONVERGED"
    GRADIENT_CONVERGED = "GRADIENT_CONVERGED"
    OBJECTIVE_NOT_IMPROVING = "OBJECTIVE_NOT_IMPROVING"
    NOT_CONVERGED = "NOT_CONVERGED"
    # The solve hit a non-finite iterate and kept the last finite point.
    DIVERGED = "DIVERGED"
