"""Fixed-effect coordinate: one global GLM over the whole batch (port of
photon_tpu/algorithm/fixed_effect.py).

On the card the objective's value and gradient go through the fused kernel
(``GLMObjective(use_fused=True)``, K1) wherever its routing rule allows, as
the ``train_glm`` driver does; on the CPU they are the plain path.
Down-sampling is a weight mask. Variances are computed at the transformed
optimum and taken to model space by the factors², as the reference
coordinate does (unlike the reference's ``train_glm`` driver). The solve
goes through the solve cache (``solve_cache``, else the shared
``default_cache()``), as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_tpu_torch.algorithm.coordinate import Coordinate
from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.ops.variance import coefficient_variances, normalize_variance_type
from photon_tpu_torch.optim.common import OptimizeResult
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.sampling.down_sampler import DownSampler
from photon_tpu_torch.types import TaskType, VarianceComputationType

Tensor = torch.Tensor


@dataclasses.dataclass
class FixedEffectCoordinate(Coordinate):
    coordinate_id: str
    feature_shard: str
    task: TaskType
    objective: GLMObjective
    optimizer_spec: OptimizerSpec = dataclasses.field(default_factory=OptimizerSpec)
    down_sampler: Optional[DownSampler] = None
    compute_variance: object = VarianceComputationType.NONE
    dim: Optional[int] = None  # for zero_model
    solve_cache: Optional[SolveCache] = None
    device: Optional[object] = None  # of zero_model (the batch's)

    def __post_init__(self):
        self.compute_variance = normalize_variance_type(self.compute_variance)

    def train(self, batch: GameBatch, residual_scores: Optional[Tensor] = None,
              initial_model: Optional[FixedEffectModel] = None) -> Tuple[FixedEffectModel, OptimizeResult]:
        lb = batch.labeled_batch(self.feature_shard, residual_scores)
        if self.down_sampler is not None:
            lb = self.down_sampler.apply(lb)
        d = lb.features.shape[1]
        w0 = (initial_model.model.coefficients.means if initial_model is not None
              else torch.zeros(d, dtype=lb.label.dtype, device=lb.label.device))
        objective = self.objective
        if lb.features.is_cuda and not objective.use_fused:
            objective = dataclasses.replace(objective, use_fused=True)
        norm = objective.normalization
        folded = norm is not None and not norm.is_identity
        if folded:
            w0 = norm.model_to_transformed_space(w0)
        cache = self.solve_cache if self.solve_cache is not None else default_cache()
        result = cache.fe_solver(objective, self.optimizer_spec)(w0, lb)
        variances = coefficient_variances(objective, result.w, lb, self.compute_variance)
        w_model = norm.transformed_to_model_space(result.w) if folded else result.w
        if folded and variances is not None and norm.factors is not None:
            variances = variances * norm.factors ** 2
        model = FixedEffectModel(
            GeneralizedLinearModel(Coefficients(w_model, variances), self.task), self.feature_shard)
        return model, result

    def score(self, model: FixedEffectModel, batch: GameBatch) -> Tensor:
        return model.score(batch)

    def zero_model(self) -> FixedEffectModel:
        assert self.dim is not None, "dim required for zero_model"
        device = self.device if self.device is not None else "cpu"
        return FixedEffectModel(GeneralizedLinearModel.zeros(self.dim, self.task, device=device), self.feature_shard)
