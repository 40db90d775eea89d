"""GameEstimator ↔ hyperparameter-vector adapter (port of
photon_tpu/estimators/evaluation_function.py).

Parity target: reference ``GameEstimatorEvaluationFunction`` (photon-client
estimators/GameEstimatorEvaluationFunction.scala:40-241): a GAME
optimization configuration is vectorized as, per coordinate sorted by id,
``log(regularization weight)`` — plus the elastic-net ``alpha`` when the
coordinate uses elastic net — and the evaluation of a candidate vector is a
full ``GameEstimator.fit`` on that configuration, returning the primary
validation metric (sign-flipped for maximization metrics so the tuner
always minimizes).

Differences from the reference, by design:
- log10 instead of ln (matches HyperparameterSerialization's LOG transform,
  VectorRescaling.scala:46 — the reference is internally inconsistent here;
  one base is as good as the other as long as pack/unpack agree).
- The adapter retains each candidate's trained ``GameResult`` so the driver
  can persist TUNED models without re-training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from photon_tpu_torch.estimators.config import (
    GameOptimizationConfig,
    RegularizationConfig,
)
from photon_tpu_torch.hyperparameter.search import SearchRange

# Reference defaults (GameEstimatorEvaluationFunction.scala:242-243).
DEFAULT_REG_WEIGHT_RANGE = (1e-4, 1e4)
DEFAULT_REG_ALPHA_RANGE = (0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class _Slot:
    """One tunable scalar: (coordinate id, 'weight'|'alpha')."""

    coordinate_id: str
    kind: str


class GameEstimatorEvaluationFunction:
    """Callable mapping a hyperparameter vector (in transformed range space:
    log10-weight / raw alpha) to the primary validation metric.

    A coordinate contributes tunable dimensions following the reference's
    rule (GameTrainingDriver.scala:662-672): none if unregularized in the
    base config, log-weight if L1/L2, log-weight + alpha if elastic net
    (alpha > 0 in the base config).
    """

    def __init__(
        self,
        estimator,
        base_config: GameOptimizationConfig,
        batch,
        validation_batch,
        evaluation_suite,
        is_opt_max: bool,
        reg_weight_range: Tuple[float, float] = DEFAULT_REG_WEIGHT_RANGE,
        reg_alpha_range: Tuple[float, float] = DEFAULT_REG_ALPHA_RANGE,
    ):
        self.estimator = estimator
        self.base_config = base_config
        self.batch = batch
        self.validation_batch = validation_batch
        self.evaluation_suite = evaluation_suite
        self.direction = -1.0 if is_opt_max else 1.0

        self._slots: List[_Slot] = []
        lowers: List[float] = []
        uppers: List[float] = []
        for cid in sorted(base_config.reg):
            reg = base_config.reg[cid]
            if reg.weight <= 0.0:
                continue  # RegularizationType.NONE: not tuned
            self._slots.append(_Slot(cid, "weight"))
            lowers.append(math.log10(reg_weight_range[0]))
            uppers.append(math.log10(reg_weight_range[1]))
            if reg.alpha > 0.0:  # elastic net: tune the mixing too
                self._slots.append(_Slot(cid, "alpha"))
                lowers.append(reg_alpha_range[0])
                uppers.append(reg_alpha_range[1])
        self.search_range = SearchRange(np.asarray(lowers), np.asarray(uppers))
        self.results: List = []  # GameResult per evaluated candidate

    @property
    def dim(self) -> int:
        return len(self._slots)

    @property
    def names(self) -> List[str]:
        """One name per tunable dimension, e.g. ``global.weight`` (log10
        space), ``perUser.alpha`` — the keys used in observation JSON."""
        return [f"{s.coordinate_id}.{s.kind}" for s in self._slots]

    # --- configurationToVector / vectorToConfiguration ---

    def config_to_vector(self, config: GameOptimizationConfig) -> np.ndarray:
        if set(config.reg) != set(self.base_config.reg):
            raise ValueError(
                "configuration coordinates do not match the base configuration"
            )
        out = []
        for slot in self._slots:
            reg = config.reg[slot.coordinate_id]
            out.append(
                math.log10(reg.weight) if slot.kind == "weight" else reg.alpha
            )
        return np.asarray(out, float)

    def vector_to_config(self, x: np.ndarray) -> GameOptimizationConfig:
        if len(x) != self.dim:
            raise ValueError(f"dimension mismatch: {len(x)} != {self.dim}")
        reg = {cid: r for cid, r in self.base_config.reg.items()}
        for slot, v in zip(self._slots, np.asarray(x, float)):
            old = reg[slot.coordinate_id]
            if slot.kind == "weight":
                reg[slot.coordinate_id] = RegularizationConfig(
                    weight=float(10.0**v), alpha=old.alpha
                )
            else:
                reg[slot.coordinate_id] = RegularizationConfig(
                    weight=old.weight, alpha=float(v)
                )
        return GameOptimizationConfig(reg)

    # --- EvaluationFunction.apply ---

    def __call__(self, x: np.ndarray) -> float:
        config = self.vector_to_config(x)
        results = self.estimator.fit(
            self.batch,
            validation_batch=self.validation_batch,
            evaluation_suite=self.evaluation_suite,
            optimization_configs=[config],
        )
        result = results[0]
        self.results.append(result)
        return self.direction * self._primary_metric(result)

    def evaluate_batch(self, X: np.ndarray) -> List[float]:
        """Evaluate q candidate vectors together. Uses the batched candidate
        lanes (estimators/batched_tuning.py) when the setup is batchable;
        otherwise falls back to q sequential fits. Returns
        signed values in the tuner's minimization convention, matching
        ``__call__``."""
        X = np.asarray(X, float)
        fast = self._batched_evaluator()
        if fast is not None:
            return [self.direction * m for m in fast(X)]
        return [self(x) for x in X]

    def _batched_evaluator(self):
        if not hasattr(self, "_batched"):
            from photon_tpu_torch.estimators.batched_tuning import build_batched_evaluator

            self._batched = build_batched_evaluator(
                self.estimator,
                self.base_config,
                self._slots,
                self.batch,
                self.validation_batch,
                self.evaluation_suite,
            )
        return self._batched

    def _primary_metric(self, result) -> float:
        if result.metrics is None:
            raise ValueError(
                "hyperparameter tuning requires validation evaluations "
                "(reference GameEstimatorEvaluationFunction.scala:141-146)"
            )
        return float(result.metrics[self.evaluation_suite.primary.name])

    # --- convertObservations ---

    def convert_observations(
        self, results: Sequence
    ) -> List[Tuple[np.ndarray, float]]:
        """Prior (explicit-grid) results → (vector, signed value) pairs;
        results without validation metrics are skipped."""
        out = []
        for r in results:
            if r.metrics is None:
                continue
            x = self.config_to_vector(r.config)
            out.append((x, self.direction * self._primary_metric(r)))
        return out
