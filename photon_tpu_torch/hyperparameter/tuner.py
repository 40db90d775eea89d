"""Copy of photon_tpu/hyperparameter/tuner.py (numpy and scipy only).

Hyperparameter tuner SPI.

Parity target: reference ``HyperparameterTuner`` SPI +
``HyperparameterTunerFactory`` (DUMMY/ATLAS via Class.forName, photon-api
hyperparameter/tuner/HyperparameterTunerFactory.scala:19-40) and
``AtlasTuner`` (RandomSearch/GaussianProcessSearch dispatch,
tuner/AtlasTuner.scala:27-75).
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple

import numpy as np

from photon_tpu_torch.hyperparameter.search import (
    EvaluationFunction,
    GaussianProcessSearch,
    RandomSearch,
    SearchRange,
)


class TunerName(enum.Enum):
    DUMMY = "DUMMY"
    ATLAS = "ATLAS"


class TuningMode(enum.Enum):
    BAYESIAN = "BAYESIAN"
    RANDOM = "RANDOM"


class HyperparameterTuner:
    """search(n, dim, mode, eval_fn, prior observations) → best point/value
    (reference HyperparameterTuner.scala:39)."""

    def search(
        self,
        n: int,
        dim: int,
        mode: TuningMode,
        evaluator: EvaluationFunction,
        search_range: Optional[SearchRange] = None,
        prior_observations: Optional[List[Tuple[np.ndarray, float]]] = None,
        seed: int = 1,
        batch_size: int = 1,
    ) -> Tuple[Optional[np.ndarray], Optional[float], List[Tuple[np.ndarray, float]]]:
        raise NotImplementedError


class DummyTuner(HyperparameterTuner):
    """No-op (reference DummyTuner)."""

    def search(self, n, dim, mode, evaluator, search_range=None,
               prior_observations=None, seed=1, batch_size=1):
        return None, None, list(prior_observations or [])


class AtlasTuner(HyperparameterTuner):
    def search(self, n, dim, mode, evaluator, search_range=None,
               prior_observations=None, seed=1, batch_size=1):
        """``batch_size > 1`` proposes that many candidates per round and
        evaluates them together through ``evaluator.evaluate_batch`` (the
        batched candidate lanes — an addition over the reference's
        one-candidate-per-round loop, GameEstimator.scala:364-382)."""
        cls = GaussianProcessSearch if mode == TuningMode.BAYESIAN else RandomSearch
        search = cls(dim, evaluator, search_range, seed=seed)
        for x, v in prior_observations or []:
            search.observe(x, v)
        if batch_size > 1 and hasattr(evaluator, "evaluate_batch"):
            rounds = -(-n // batch_size)  # ceil: at least n evaluations
            best_x, best_v = search.find_batch(
                rounds, batch_size, evaluator.evaluate_batch
            )
        else:
            best_x, best_v = search.find(n)
        return best_x, best_v, search.observations


def get_tuner(name: TunerName) -> HyperparameterTuner:
    return AtlasTuner() if name == TunerName.ATLAS else DummyTuner()
