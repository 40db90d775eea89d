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


class NormalizationType(enum.Enum):
    """Feature normalization schemes (reference NormalizationType.scala:20)."""

    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


class VarianceComputationType(enum.Enum):
    """Coefficient variances: SIMPLE = inverse Hessian diagonal, FULL =
    diagonal of the inverse Hessian (Cholesky)."""

    NONE = "NONE"
    SIMPLE = "SIMPLE"
    FULL = "FULL"


class OptimizerType(enum.Enum):
    """Optimizer selection (reference OptimizerType / OptimizerFactory)."""

    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    LBFGSB = "LBFGSB"
    TRON = "TRON"
    # Batched damped Newton for the per-entity random-effect solves
    # (optim/newton.py).
    NEWTON = "NEWTON"
