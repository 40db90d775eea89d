"""Coordinate configuration (port of photon_tpu/estimators/config.py):
per-coordinate data and optimizer settings, and the expansion of the
regularization-weight sets into one optimization configuration per point
of their cross product."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.types import OptimizerType, VarianceComputationType


@dataclasses.dataclass(frozen=True)
class RegularizationConfig:
    """Elastic-net split of a weight: l1 = alpha·weight, l2 = (1−alpha)·weight."""

    weight: float = 0.0
    alpha: float = 0.0

    @property
    def l1(self) -> float:
        return self.alpha * self.weight

    @property
    def l2(self) -> float:
        return (1.0 - self.alpha) * self.weight


@dataclasses.dataclass
class FixedEffectCoordinateConfig:
    coordinate_id: str
    feature_shard: str
    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iter: Optional[int] = None
    tol: Optional[float] = None
    reg_weights: Sequence[float] = (0.0,)
    reg_alpha: float = 0.0
    down_sampling_rate: Optional[float] = None
    compute_variance: object = VarianceComputationType.NONE
    box: Optional[tuple] = None  # (lower, upper) bound vectors

    def optimizer_spec(self) -> OptimizerSpec:
        return OptimizerSpec(self.optimizer, self.max_iter, self.tol, box=self.box)


@dataclasses.dataclass
class RandomEffectCoordinateConfig:
    coordinate_id: str
    re_type: str
    feature_shard: str
    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iter: Optional[int] = None
    tol: Optional[float] = None
    reg_weights: Sequence[float] = (0.0,)
    reg_alpha: float = 0.0
    active_upper_bound: Optional[int] = None
    active_lower_bound: Optional[int] = None
    features_to_samples_ratio: Optional[float] = None
    compute_variance: object = VarianceComputationType.NONE
    # Convergence-gated active-set passes; convergence_tol None defers to
    # the estimator's default.
    active_set: bool = False
    convergence_tol: Optional[float] = None

    def optimizer_spec(self) -> OptimizerSpec:
        return OptimizerSpec(self.optimizer, self.max_iter, self.tol)


@dataclasses.dataclass(frozen=True)
class GameOptimizationConfig:
    """One point of the regularization-weight cross product: coordinate id →
    regularization."""

    reg: Dict[str, RegularizationConfig]

    def describe(self) -> str:
        return ", ".join(f"{k}: λ={v.weight:g} α={v.alpha:g}" for k, v in self.reg.items())


def expand_optimization_configs(configs: Sequence) -> List[GameOptimizationConfig]:
    """Cross product of the per-coordinate weight sets, each sorted strongest
    first, so warm starts move from strong to weak regularization."""
    ids = [c.coordinate_id for c in configs]
    weight_lists = [sorted(c.reg_weights, reverse=True) for c in configs]
    alphas = {c.coordinate_id: c.reg_alpha for c in configs}
    return [
        GameOptimizationConfig({cid: RegularizationConfig(weight=w, alpha=alphas[cid])
                                for cid, w in zip(ids, combo)})
        for combo in itertools.product(*weight_lists)
    ]
