"""Copy of photon_tpu/hyperparameter/shrink.py (numpy and scipy only).

Shrink the hyperparameter search range around the predicted best point.

Parity target: reference ``ShrinkSearchRange.getBounds``
(photon-client hyperparameter/ShrinkSearchRange.scala:28-80): rescale prior
observations to [0,1], fit a Matern52 Gaussian process, predict over a Sobol
candidate pool, take the candidate with the best predicted value, and return
``[best - radius, best + radius]`` (clipped to the unit cube, snapped for
discrete dims) scaled back to the original hyperparameter space.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import qmc

from photon_tpu_torch.hyperparameter.gp import GaussianProcessEstimator
from photon_tpu_torch.hyperparameter.kernels import Matern52
from photon_tpu_torch.hyperparameter.search import SearchRange


def shrink_search_range(
    prior_observations: Sequence[Tuple[np.ndarray, float]],
    search_range: SearchRange,
    radius: float,
    candidate_pool_size: int = 1024,
    seed: int = 1,
    estimator: Optional[GaussianProcessEstimator] = None,
) -> SearchRange:
    """Return a SearchRange shrunk to ±radius (in unit-cube coordinates)
    around the GP-predicted best candidate.

    prior_observations are (hyperparameter vector in original space, value)
    pairs with lower = better, e.g. loaded from a prior run's tuning output
    (HyperparameterSerialization.priorFromJson role).
    """
    if not prior_observations:
        return search_range
    dim = len(search_range.lower)
    X = np.stack([search_range.to_unit(np.asarray(x, float))
                  for x, _ in prior_observations])
    y = np.array([v for _, v in prior_observations], float)

    est = estimator or GaussianProcessEstimator(kernel_factory=Matern52, seed=seed)
    model = est.fit(X, y)

    sobol = qmc.Sobol(d=dim, scramble=True, seed=seed)
    candidates = sobol.random(candidate_pool_size)
    mean, _ = model.predict(candidates)
    best = candidates[int(np.argmin(mean))]

    lower_unit = np.clip(best - radius, 0.0, 1.0)
    upper_unit = np.clip(best + radius, 0.0, 1.0)
    new_lower = search_range.rescale(lower_unit[None, :])[0]
    new_upper = search_range.rescale(upper_unit[None, :])[0]
    # Discrete snapping can collapse an interval; keep it ordered and non-empty.
    lo = np.minimum(new_lower, new_upper)
    hi = np.maximum(new_lower, new_upper)
    degenerate = hi <= lo
    if np.any(degenerate):
        lo = np.where(degenerate, search_range.lower, lo)
        hi = np.where(degenerate, search_range.upper, hi)
    return SearchRange(lo, hi, search_range.discrete)
