"""GameEstimator: the fit() orchestrator (port of
photon_tpu/estimators/game_estimator.py).

The random-effect datasets are grouped once per batch on the host (a sparse
shard as its host triples, each block projected onto its own columns) and
their blocks placed on the batch's device; each optimization configuration (a
point of the regularization grid) builds its coordinates and runs
coordinate descent, warm-started from the previous configuration's model.
Every solve dispatches through ``solve_cache`` (algorithm/solve_cache.py);
without one, the shared ``default_cache()``, whose entries (graphs, static
buffers, the pinned fixed-effect features) ``fit`` releases when it returns.
With ``re_device_budget_mb`` every dense random-effect coordinate trains out
of core (algorithm/re_store.py): its blocks move to a host master once, at
its first coordinate, and a budgeted working set is uploaded pass by pass.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from photon_tpu_torch.algorithm.coordinate import Coordinate
from photon_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
from photon_tpu_torch.estimators.config import (
    FixedEffectCoordinateConfig,
    GameOptimizationConfig,
    RandomEffectCoordinateConfig,
    expand_optimization_configs,
)
from photon_tpu_torch.evaluation.suite import EvaluationSuite
from photon_tpu_torch.models.game import GameModel, ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.ops.variance import normalize_variance_type
from photon_tpu_torch.optim.common import HOST_READS
from photon_tpu_torch.sampling.down_sampler import down_sampler_for_task
from photon_tpu_torch.types import TaskType, VarianceComputationType
from photon_tpu_torch.utils.timed import Timed

logger = logging.getLogger(__name__)

CoordinateConfig = Union[FixedEffectCoordinateConfig, RandomEffectCoordinateConfig]


def _existing_entity_mask(prev_model) -> np.ndarray:
    """(E,) bool: the entities the warm-start model has a record for (its
    ``present_entities`` when set; a projected model's entities with a
    block; every row of a dense model)."""
    pm = getattr(prev_model, "present_entities", None)
    if pm is not None:
        return HOST_READS.fetch(pm)[0].astype(bool)
    if isinstance(prev_model, ProjectedRandomEffectModel):
        return HOST_READS.fetch(prev_model.entity_block)[0] >= 0
    if isinstance(prev_model, RandomEffectModel):
        return np.ones((prev_model.num_entities,), bool)
    raise TypeError("warm-start model for a random-effect coordinate must be a RandomEffectModel or "
                    f"ProjectedRandomEffectModel, got {type(prev_model).__name__}")


@dataclasses.dataclass
class GameResult:
    model: GameModel
    config: GameOptimizationConfig
    metrics: Optional[Dict[str, float]]
    tracker: Dict[str, list]
    wall_times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)


class GameEstimator:
    """Trains GAME models over a list of optimization configurations.

    ``intercept_indices`` and ``normalization`` are per feature shard;
    ``num_entities`` per random-effect type. ``solve_cache`` is the cache
    every coordinate dispatches through (None: the shared one, released at
    the end of each ``fit``). With ``mesh`` (parallel/mesh.py; every rank
    calls ``fit`` with the whole batch) the fit is SPMD over the mesh's
    ranks: each fixed effect trains on this rank's rows with its sums
    reduced over the mesh, and each random effect is entity-sharded over the
    ranks (algorithm/sharded_random_effect.py, the byte budget per shard);
    every rank ends with the same model."""

    def __init__(
        self,
        task: TaskType,
        coordinate_configs: Sequence[CoordinateConfig],
        num_iterations: int = 1,
        intercept_indices: Optional[Dict[str, int]] = None,
        normalization: Optional[Dict[str, NormalizationContext]] = None,
        num_entities: Optional[Dict[str, int]] = None,
        locked_coordinates: Sequence[str] = (),
        variance_computation: object = None,
        ignore_threshold_for_new_models: bool = False,
        warm_start_model=None,
        re_active_set: bool = False,
        re_convergence_tol: float = 1e-4,
        re_device_budget_mb: Optional[float] = None,
        re_spill_dir: Optional[str] = None,
        re_spill_member: Optional[str] = None,
        solve_cache: Optional[SolveCache] = None,
        mesh=None,
    ):
        self.task = task
        self.mesh = mesh
        self.coordinate_configs = list(coordinate_configs)
        self.num_iterations = num_iterations
        self.intercept_indices = intercept_indices or {}
        self.normalization = normalization or {}
        self.num_entities = num_entities or {}
        self.locked_coordinates = list(locked_coordinates)
        self.variance_computation = normalize_variance_type(variance_computation)
        self.ignore_threshold_for_new_models = bool(ignore_threshold_for_new_models)
        self.warm_start_model = warm_start_model
        self.re_active_set = bool(re_active_set)
        self.re_convergence_tol = float(re_convergence_tol)
        # Out-of-core residency: the device byte budget of every random-effect
        # coordinate's block data and in-flight coefficients (None: fully
        # resident), the spill directory of the host master and the ring
        # member whose ``host-<k>/`` layout the spill takes.
        self.re_device_budget_bytes = int(re_device_budget_mb * (1 << 20)) if re_device_budget_mb else None
        self.re_spill_dir = re_spill_dir
        self.re_spill_member = re_spill_member
        self.solve_cache = solve_cache
        if self.ignore_threshold_for_new_models and warm_start_model is None:
            raise ValueError("'Ignore threshold for new models' flag set but no initial model provided "
                             "for warm-start")
        self.update_sequence = [c.coordinate_id for c in self.coordinate_configs]

    def _variance_type(self, cfg):
        per = normalize_variance_type(cfg.compute_variance)
        return per if per != VarianceComputationType.NONE else self.variance_computation

    def _objective(self, cfg, reg) -> GLMObjective:
        return GLMObjective(loss=loss_for_task(self.task), l2_weight=reg.l2, l1_weight=reg.l1,
                            intercept_index=self.intercept_indices.get(cfg.feature_shard),
                            normalization=self.normalization.get(cfg.feature_shard))

    def _build_coordinates(self, batch: GameBatch, opt_config: GameOptimizationConfig) -> Dict[str, Coordinate]:
        coords: Dict[str, Coordinate] = {}
        for cfg in self.coordinate_configs:
            objective = self._objective(cfg, opt_config.reg[cfg.coordinate_id])
            if isinstance(cfg, FixedEffectCoordinateConfig):
                rate = cfg.down_sampling_rate
                coords[cfg.coordinate_id] = FixedEffectCoordinate(
                    coordinate_id=cfg.coordinate_id, feature_shard=cfg.feature_shard, task=self.task,
                    objective=objective, optimizer_spec=cfg.optimizer_spec(),
                    down_sampler=down_sampler_for_task(self.task, rate) if rate is not None and rate < 1.0 else None,
                    compute_variance=self._variance_type(cfg),
                    dim=batch.features[cfg.feature_shard].shape[1], device=batch.label.device,
                    solve_cache=self.solve_cache, mesh=self.mesh,
                )
            elif isinstance(cfg, RandomEffectCoordinateConfig) and self.mesh is not None:
                from photon_tpu_torch.algorithm.sharded_random_effect import ShardedRandomEffectCoordinate

                plan, datasets, data_cfg, dim = self._re_datasets[cfg.coordinate_id]
                coords[cfg.coordinate_id] = ShardedRandomEffectCoordinate.from_datasets(
                    cfg.coordinate_id, plan, datasets, dim, data_cfg, self.task, objective, cfg.optimizer_spec(),
                    mesh=self.mesh, device=batch.label.device, solve_cache=self.solve_cache,
                    active_set=bool(cfg.active_set or self.re_active_set),
                    convergence_tol=(cfg.convergence_tol if cfg.convergence_tol is not None
                                     else self.re_convergence_tol),
                    device_budget_bytes=self.re_device_budget_bytes, device_spill_dir=self.re_spill_dir)
            elif isinstance(cfg, RandomEffectCoordinateConfig):
                coords[cfg.coordinate_id] = RandomEffectCoordinate(
                    coordinate_id=cfg.coordinate_id, dataset=self._re_datasets[cfg.coordinate_id],
                    task=self.task, objective=objective, optimizer_spec=cfg.optimizer_spec(),
                    compute_variance=self._variance_type(cfg),
                    active_set=bool(cfg.active_set or self.re_active_set),
                    convergence_tol=(cfg.convergence_tol if cfg.convergence_tol is not None
                                     else self.re_convergence_tol),
                    device_budget_bytes=self.re_device_budget_bytes, device_spill_dir=self.re_spill_dir,
                    device_spill_member=self.re_spill_member, solve_cache=self.solve_cache,
                )
            else:
                raise TypeError(f"unknown coordinate config {type(cfg)}")
        return coords

    def _prepare_datasets(self, batch: GameBatch) -> None:
        """Group the random-effect datasets once per batch."""
        if getattr(self, "_prepared_for", None) is batch:
            return
        self._re_datasets = {}
        re_cfgs = [c for c in self.coordinate_configs if isinstance(c, RandomEffectCoordinateConfig)]
        # The columns the host grouping needs, in one read per batch.
        names = ["label", "weight"] + (["uid"] if batch.uid is not None else [])
        tensors = [batch.label, batch.weight] + ([batch.uid] if batch.uid is not None else [])
        for cfg in re_cfgs:
            feats = batch.features[cfg.feature_shard]
            # A sparse shard comes to the host as its (indices, values): the
            # dataset projects each block onto its columns, never densifying.
            parts = [feats.indices, feats.values] if isinstance(feats, SparseFeatures) else [feats]
            names += [f"ids:{cfg.re_type}"] + [f"x:{cfg.feature_shard}:{i}" for i in range(len(parts))]
            tensors += [batch.entity_ids[cfg.re_type]] + parts
        host = dict(zip(names, HOST_READS.fetch(*tensors))) if re_cfgs else {}
        for cfg in re_cfgs:
            feats = batch.features[cfg.feature_shard]
            x = (host[f"x:{cfg.feature_shard}:0"], host[f"x:{cfg.feature_shard}:1"], feats.dim) \
                if isinstance(feats, SparseFeatures) else host[f"x:{cfg.feature_shard}:0"]
            eids = host[f"ids:{cfg.re_type}"]
            E = self.num_entities.get(cfg.re_type, int(eids.max()) + 1 if eids.size else 0)
            existing = None
            if self.ignore_threshold_for_new_models:
                existing = np.zeros((E,), bool)
                prev_model = self.warm_start_model.get(cfg.coordinate_id)
                if prev_model is not None:
                    src = _existing_entity_mask(prev_model)
                    k = min(E, src.shape[0])
                    existing[:k] = src[:k]
            data_cfg = RandomEffectDataConfig(
                re_type=cfg.re_type, feature_shard=cfg.feature_shard,
                active_upper_bound=cfg.active_upper_bound, active_lower_bound=cfg.active_lower_bound,
                features_to_samples_ratio=cfg.features_to_samples_ratio)
            if self.mesh is not None:
                from photon_tpu_torch.algorithm.sharded_random_effect import owned_shards, shard_datasets
                from photon_tpu_torch.parallel.entity_shard import build_shard_plan

                # Every rank builds the same plan and only its own shards.
                plan = build_shard_plan(E)
                datasets = shard_datasets(plan, owned_shards(plan, self.mesh), eids, x, host["label"],
                                          host["weight"], data_cfg, batch.label.device, uid=host.get("uid"),
                                          existing_model_mask=existing)
                self._re_datasets[cfg.coordinate_id] = (plan, datasets, data_cfg,
                                                        feats.dim if isinstance(feats, SparseFeatures)
                                                        else feats.shape[1])
                continue
            self._re_datasets[cfg.coordinate_id] = build_random_effect_dataset(
                eids, x, host["label"], host["weight"], E, data_cfg,
                uid=host.get("uid"),
                existing_model_mask=existing, device=batch.label.device,
            )
        self._prepared_for = batch

    def fit(
        self,
        batch: GameBatch,
        validation_batch: Optional[GameBatch] = None,
        evaluation_suite: Optional[EvaluationSuite] = None,
        optimization_configs: Optional[Sequence[GameOptimizationConfig]] = None,
        initial_model: Optional[GameModel] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        checkpoint_keep_last: Optional[int] = None,
        emitter=None,
        on_coordinate=None,
    ) -> List[GameResult]:
        """Train one GameModel per optimization configuration, each
        warm-started from the previous one. With ``checkpoint_dir`` config
        i's coordinate descent checkpoints under ``<dir>/cfg_<i>`` and
        resumes from its newest state there (a finished config replays from
        its final checkpoint without recomputation), tagged with the config
        and the update sequence. ``emitter`` gets the optimization-log
        events; ``on_coordinate(pass, id, coordinate, wall_s)`` is passed to
        the coordinate descent."""
        with Timed("game-estimator/prepare-datasets"):
            self._prepare_datasets(batch)
        configs = (list(optimization_configs) if optimization_configs is not None
                   else expand_optimization_configs(self.coordinate_configs))
        validation_fn = better = None
        if evaluation_suite is not None and validation_batch is not None:
            validation_fn = evaluation_suite.validation_fn()
            better = evaluation_suite.primary.better()
        checkpointing = dict(checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                             checkpoint_keep_last=checkpoint_keep_last, emitter=emitter)
        try:
            return self._fit_configs(batch, configs, validation_batch, validation_fn, better, initial_model,
                                     on_coordinate, checkpointing)
        finally:
            if self.solve_cache is None:
                default_cache().release()

    def _fit_configs(self, batch, configs, validation_batch, validation_fn, better, initial_model,
                     on_coordinate, checkpointing) -> List[GameResult]:
        results: List[GameResult] = []
        warm = initial_model
        ckpt_dir = checkpointing.pop("checkpoint_dir")
        for cfg_idx, opt_config in enumerate(configs):
            with Timed(f"game-estimator/train[{opt_config.describe()}]"):
                cd = CoordinateDescent(self._build_coordinates(batch, opt_config), self.update_sequence,
                                       num_iterations=self.num_iterations,
                                       locked_coordinates=self.locked_coordinates)
                cd_result = cd.run(batch, initial_model=warm, validation_batch=validation_batch,
                                   validation_fn=validation_fn,
                                   better=better if better is not None else (lambda a, b: a < b),
                                   checkpoint_dir=None if ckpt_dir is None else f"{ckpt_dir}/cfg_{cfg_idx}",
                                   # The sweep point's fingerprint: resuming against a
                                   # changed grid or sequence fails loudly.
                                   checkpoint_tag=f"{opt_config.describe()}|{','.join(self.update_sequence)}",
                                   on_coordinate=on_coordinate, **checkpointing)
            metrics = cd_result.metric_history[-1] if cd_result.metric_history else None
            results.append(GameResult(model=cd_result.best_model, config=opt_config, metrics=metrics,
                                      tracker=cd_result.tracker, wall_times=cd_result.wall_times))
            warm = cd_result.model
            logger.info("trained config (%s): metrics=%s", opt_config.describe(), metrics)
        return results

    def select_best(self, results: List[GameResult], evaluation_suite: EvaluationSuite) -> GameResult:
        """Best result by the primary validation metric."""
        primary = evaluation_suite.primary
        better = primary.better()
        best = None
        for r in results:
            if r.metrics is None:
                continue
            if best is None or better(r.metrics[primary.name], best.metrics[primary.name]):
                best = r
        return best if best is not None else results[-1]
