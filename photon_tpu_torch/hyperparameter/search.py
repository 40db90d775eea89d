"""Copy of photon_tpu/hyperparameter/search.py (numpy and scipy only).

Hyperparameter search: Sobol quasi-random + GP Bayesian (EI) search.

Parity targets: reference ``RandomSearch`` with Sobol draws + discrete
snapping (photon-lib hyperparameter/search/RandomSearch.scala:34-165+) and
``GaussianProcessSearch`` (fit GP posterior on observations, pick argmax
Expected Improvement over candidate draws,
search/GaussianProcessSearch.scala:52-196), plus the ``EvaluationFunction``
adapter (hyperparameter/EvaluationFunction.scala:25-57) and vector rescaling
(VectorRescaling.scala).

Addition over the reference: ``find_batch``
proposes q points per round so candidate trainings can run concurrently on
the device instead of strictly sequentially.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import qmc

from photon_tpu_torch.hyperparameter.criteria import expected_improvement
from photon_tpu_torch.hyperparameter.gp import GaussianProcessEstimator

EvaluationFunction = Callable[[np.ndarray], float]
"""vector in [0,1]^d (rescaled hyperparameters) → evaluation value (lower
is better). The GameEstimator adapter lives in photon_tpu_torch.estimators."""


@dataclasses.dataclass
class SearchRange:
    """Per-dimension range + optional discrete grid (reference discrete-param
    snapping RandomSearch.scala:171+). Values searched in [0,1] and rescaled."""

    lower: np.ndarray
    upper: np.ndarray
    discrete: Optional[Sequence[Optional[np.ndarray]]] = None  # per-dim grids

    def rescale(self, unit: np.ndarray) -> np.ndarray:
        x = self.lower + unit * (self.upper - self.lower)
        if self.discrete is not None:
            x = x.copy()
            for j, grid in enumerate(self.discrete):
                if grid is not None:
                    g = np.asarray(grid, float)
                    x[..., j] = g[np.argmin(np.abs(g[None, :] - x[..., j, None]), axis=-1)]
        return x

    def to_unit(self, x: np.ndarray) -> np.ndarray:
        return (x - self.lower) / np.maximum(self.upper - self.lower, 1e-30)


class RandomSearch:
    """Sobol quasi-random search (reference RandomSearch.scala:34-165)."""

    def __init__(self, dim: int, evaluator: EvaluationFunction,
                 search_range: Optional[SearchRange] = None, seed: int = 1):
        self.dim = dim
        self.evaluator = evaluator
        self.range = search_range or SearchRange(np.zeros(dim), np.ones(dim))
        self._sobol = qmc.Sobol(d=dim, scramble=True, seed=seed)
        self.observations: List[Tuple[np.ndarray, float]] = []

    # --- candidate generation ---

    def draw_candidates(self, n: int) -> np.ndarray:
        return self.range.rescale(self._sobol.random(n))

    def next_point(self) -> np.ndarray:
        return self.draw_candidates(1)[0]

    def next_batch(self, q: int) -> np.ndarray:
        """(q, dim) proposals for one concurrent-evaluation round."""
        return self.draw_candidates(q)

    # --- driver loops (findWithPriors / find roles) ---

    def observe(self, x: np.ndarray, value: float) -> None:
        self.observations.append((np.asarray(x, float), float(value)))

    def find(self, n: int) -> Tuple[np.ndarray, float]:
        """Evaluate n points; return the best (point, value)."""
        from photon_tpu_torch.obs.metrics import registry
        from photon_tpu_torch.obs.trace import span

        registry().gauge("tuning_candidate_count").set(1)
        for i in range(n):
            with span(f"tuning/round{i}"):
                with span("propose"):
                    x = self.next_point()
                with span("train"):
                    value = self.evaluator(x)
                with span("observe"):
                    self.observe(x, value)
            registry().counter("tuning_rounds_total").inc()
        best = min(self.observations, key=lambda o: o[1])
        return best

    def find_batch(self, n_rounds: int, q: int,
                   batch_evaluator: Callable[[np.ndarray], Sequence[float]]) -> Tuple[np.ndarray, float]:
        """q proposals per round evaluated together (batched tuning).
        Proposals come from ``next_batch`` — Sobol here, top-q EI in the
        Bayesian subclass — so each round refines on the last round's
        observations."""
        from photon_tpu_torch.obs.metrics import registry
        from photon_tpu_torch.obs.trace import span

        registry().gauge("tuning_candidate_count").set(q)
        for i in range(n_rounds):
            with span(f"tuning/round{i}"):
                with span("propose"):
                    X = self.next_batch(q)
                with span("train"):
                    values = [float(v) for v in batch_evaluator(X)]
                with span("observe"):
                    for x, v in zip(X, values):
                        self.observe(x, v)
            registry().counter("tuning_rounds_total").inc()
        return min(self.observations, key=lambda o: o[1])


class GaussianProcessSearch(RandomSearch):
    """Bayesian search: GP posterior + EI argmax over Sobol candidates
    (reference GaussianProcessSearch.scala:52-196 uses 250/round; 256 here —
    Sobol sequences balance only at powers of two, and scipy warns
    otherwise). Falls back to pure Sobol until enough observations exist."""

    def __init__(self, dim: int, evaluator: EvaluationFunction,
                 search_range: Optional[SearchRange] = None, seed: int = 1,
                 num_candidates: int = 256, min_observations: int = 3,
                 estimator: Optional[GaussianProcessEstimator] = None):
        super().__init__(dim, evaluator, search_range, seed)
        self.num_candidates = num_candidates
        self.min_observations = min_observations
        self.estimator = estimator or GaussianProcessEstimator(seed=seed)

    def next_point(self) -> np.ndarray:
        if len(self.observations) < self.min_observations:
            return super().next_point()
        cand_unit, ei = self._ei_over_candidates()
        return self.range.rescale(cand_unit[int(np.argmax(ei))])

    def next_batch(self, q: int) -> np.ndarray:
        """Top-q EI candidates in one round (batch Bayesian proposals —
        the q Sobol candidates with the best acquisition, all from the same
        posterior; cheaper than q sequential constant-liar refits and
        adequate for the batched training win)."""
        if len(self.observations) < self.min_observations:
            return super().next_batch(q)
        cand_unit, ei = self._ei_over_candidates()
        top = np.argsort(-ei)[:q]
        return self.range.rescale(cand_unit[top])

    def _ei_over_candidates(self) -> Tuple[np.ndarray, np.ndarray]:
        X = np.stack([o[0] for o in self.observations])
        y = np.array([o[1] for o in self.observations])
        model = self.estimator.fit(self.range.to_unit(X), y)
        cand_unit = self._sobol.random(self.num_candidates)
        mean, std = model.predict(cand_unit)
        return cand_unit, expected_improvement(mean, std, float(np.min(y)))
