"""Copy of photon_tpu/hyperparameter/criteria.py (numpy and scipy only).

Acquisition criteria for Bayesian search.

Parity target: reference criteria (photon-lib hyperparameter/criteria/
ExpectedImprovement.scala, ConfidenceBound.scala). Minimization convention:
lower observed evaluation values are better (the reference transforms
maximize-metrics upstream).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm


def expected_improvement(mean: np.ndarray, std: np.ndarray, best: float) -> np.ndarray:
    """EI for minimization: E[max(best - Y, 0)]."""
    std = np.maximum(std, 1e-12)
    z = (best - mean) / std
    return (best - mean) * norm.cdf(z) + std * norm.pdf(z)


def confidence_bound(mean: np.ndarray, std: np.ndarray, kappa: float = 2.0) -> np.ndarray:
    """Lower-confidence-bound score (higher is better for selection):
    -(mean - kappa·std)."""
    return -(mean - kappa * std)
