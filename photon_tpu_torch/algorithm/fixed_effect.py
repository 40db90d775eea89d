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

With ``mesh`` (parallel/mesh.py) the coordinate trains on this rank's rows
of the batch (every rank holds the whole batch; parallel/distributed.py::
shard_batch), its objective's sums reduced over the mesh's data axes: K1 and
K2 on each rank's rows, then one all-reduce, so every rank takes the same
solve and holds the same model, which scores the whole batch. The solve is
captured under NCCL and runs eagerly under gloo (solve_cache.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_tpu_torch.algorithm.coordinate import Coordinate
from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.obs.trace import span
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
    mesh: Optional[object] = None  # rows-sharded training over its data axes

    def __post_init__(self):
        self.compute_variance = normalize_variance_type(self.compute_variance)
        if self.mesh is not None and self.compute_variance != VarianceComputationType.NONE:
            raise ValueError("a rows-sharded fixed effect does not compute coefficient variances")
        self._local = None  # (whole X, whole label, this rank's batch) of the last pass

    def _rows_sharded(self, lb: LabeledBatch) -> LabeledBatch:
        """This rank's rows of ``lb``; its X and label are the same tensors
        every pass while the batch's are (the solve cache keys them by
        identity), its offsets and weights are this pass's."""
        from photon_tpu_torch.parallel.distributed import local_rows, shard_batch

        last = self._local
        if last is None or last[0] is not lb.features or last[1] is not lb.label:
            local = shard_batch(lb, self.mesh)
            self._local = (lb.features, lb.label, local)
            return local
        local = last[2]
        return LabeledBatch(local.label, local.features, local_rows(lb.offset, local.rows),
                            local_rows(lb.weight, local.rows), local.rows)

    def train(self, batch: GameBatch, residual_scores: Optional[Tensor] = None,
              initial_model: Optional[FixedEffectModel] = None) -> Tuple[FixedEffectModel, OptimizeResult]:
        lb = batch.labeled_batch(self.feature_shard, residual_scores)
        if self.down_sampler is not None:
            lb = self.down_sampler.apply(lb)
        if self.mesh is not None:
            lb = self._rows_sharded(lb)
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
        solve = cache.fe_solver(objective, self.optimizer_spec)
        # Host wall of the dispatch: the solve runs asynchronously on the
        # device, and nothing here waits for it.
        with span("fe_solve"):
            result = solve(w0, lb)
        variances = coefficient_variances(objective, result.w, lb, self.compute_variance)
        w_model = norm.transformed_to_model_space(result.w) if folded else result.w
        if folded and variances is not None and norm.factors is not None:
            variances = variances * norm.factors ** 2
        model = FixedEffectModel(
            GeneralizedLinearModel(Coefficients(w_model, variances), self.task), self.feature_shard)
        return model, result

    def train_from_stream(self, chunks, residual_scores: Optional[Tensor] = None,
                          initial_model: Optional[FixedEffectModel] = None) -> Tuple[FixedEffectModel, OptimizeResult]:
        """Train from a pipelined chunk stream (io/pipeline.py ``BatchChunk``s
        of ``stream_device_batches`` or ``device_chunks_from``): the chunks
        concatenate on the device, the stream's threads are joined, and the
        solve runs exactly as :meth:`train`. Feed unpadded chunks
        (``pad_rows_to=None``): padding rows would enter the objective."""
        from photon_tpu_torch.io.pipeline import materialize_game_batch

        return self.train(materialize_game_batch(chunks), residual_scores, initial_model)

    def score(self, model: FixedEffectModel, batch: GameBatch) -> Tensor:
        return model.score(batch)

    def zero_model(self) -> FixedEffectModel:
        assert self.dim is not None, "dim required for zero_model"
        device = self.device if self.device is not None else "cpu"
        return FixedEffectModel(GeneralizedLinearModel.zeros(self.dim, self.task, device=device), self.feature_shard)
