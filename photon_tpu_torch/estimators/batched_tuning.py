"""Batched hyperparameter evaluation: q GAME candidates as lanes of one
program (port of photon_tpu/estimators/batched_tuning.py).

The reference trains tuning candidates one full GAME fit at a time, or, in
this fast path, as one vmapped program over per-lane λs. Here a round of q
candidates that differ only in their L2 weights runs the reference's mini
coordinate descent with a lane axis (``CandidateLanes``):
  - the fixed effect is one margin L-BFGS program with q lanes over the
    shared X: each lane its own L2 weight and its own offsets (the
    training offsets plus the lane's random-effect scores), so a pass over
    X serves all q. K1 takes one offset vector, so these passes are the
    plain products (as the λ sweep's are);
  - each random-effect block is one batched Newton program over a (q, E)
    lane grid (margin L-BFGS where the production route is not Newton),
    each lane its candidate's weight: the margins of all q lanes are one
    product with the block's X, and the Newton systems are q launches of K3
    over the one slab (optim/newton.py);
  - normalization folds as in the production coordinates, which the lanes
    take their objectives from; the validation metric is computed per lane
    on the device and read back once a round.
Each program goes through the solve cache (``SolveCache.lane_solver``): on
the card it is captured once, the lanes' λs are device inputs, and a later
round of the same q replays it.

Eligibility (falls back to sequential fits otherwise, with a logged
warning): one fixed-effect + one random-effect coordinate (the GLMix
shape), the fixed effect trained first, pure-L2 tuning dimensions,
unprojected entity blocks, no down-sampling, boxes or Pearson masks, no
locked coordinates, an ungrouped primary metric of the reference's batchable
set, L-BFGS on the fixed effect and L-BFGS or Newton on the random effect.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from photon_tpu_torch.algorithm.random_effect import _block_end, _block_start, _scatter_rows, newton_eligible
from photon_tpu_torch.algorithm.solve_cache import SolveCache
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures, matvec
from photon_tpu_torch.estimators.config import (
    FixedEffectCoordinateConfig,
    GameOptimizationConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.evaluation.evaluators import evaluate
from photon_tpu_torch.models.game import RandomEffectModel
from photon_tpu_torch.optim.common import HOST_READS
from photon_tpu_torch.optim.margin_lbfgs import MarginLBFGS
from photon_tpu_torch.optim.newton import Newton
from photon_tpu_torch.optim.problem import GLMTerms
from photon_tpu_torch.types import OptimizerType

Tensor = torch.Tensor
logger = logging.getLogger(__name__)

# Primary metrics the lanes compute (the reference's jittable set).
_BATCHABLE_METRICS = ("AUC", "AUPR", "RMSE", "LOGISTIC_LOSS", "SQUARED_LOSS", "POISSON_LOSS")


def _decline(reason: str) -> None:
    logger.warning(
        "batched hyperparameter evaluation declined (%s); candidates will "
        "be trained sequentially", reason,
    )
    return None


def build_batched_evaluator(
    estimator,
    base_config: GameOptimizationConfig,
    slots,  # GameEstimatorEvaluationFunction._slots (coordinate_id, kind)
    batch,
    validation_batch,
    evaluation_suite,
) -> Optional[Callable[[np.ndarray], List[float]]]:
    """Return fn(X: (q, dim) candidate vectors) -> list of q primary-metric
    values, or None when the setup is not batchable."""
    cfgs = estimator.coordinate_configs
    if len(cfgs) != 2:
        return _decline(f"{len(cfgs)} coordinates; only the 2-coordinate GLMix shape is batchable")
    fe_cfgs = [c for c in cfgs if isinstance(c, FixedEffectCoordinateConfig)]
    re_cfgs = [c for c in cfgs if isinstance(c, RandomEffectCoordinateConfig)]
    if len(fe_cfgs) != 1 or len(re_cfgs) != 1:
        return _decline("need exactly one fixed + one random effect")
    fe_cfg, re_cfg = fe_cfgs[0], re_cfgs[0]
    if estimator.update_sequence[0] != fe_cfg.coordinate_id:
        return _decline("update sequence does not train the fixed effect first")
    if any(s.kind != "weight" for s in slots):
        return _decline("non-L2-weight tuning dimension")
    if any(base_config.reg[c.coordinate_id].alpha != 0.0 for c in cfgs):
        return _decline("elastic-net alpha != 0")
    if fe_cfg.down_sampling_rate is not None or fe_cfg.box is not None or re_cfg.features_to_samples_ratio is not None:
        return _decline("down-sampling / box constraints / Pearson masks")
    if estimator.locked_coordinates:
        return _decline("locked coordinates")
    primary = evaluation_suite.primary
    if primary.etype.name not in _BATCHABLE_METRICS or primary.group_by is not None:
        return _decline(f"primary metric {primary.name} is not batchable")
    if fe_cfg.optimizer != OptimizerType.LBFGS:
        return _decline("fixed-effect optimizer is not LBFGS")
    if re_cfg.optimizer not in (OptimizerType.LBFGS, OptimizerType.NEWTON):
        return _decline("random-effect optimizer is not LBFGS/NEWTON")
    if estimator.re_device_budget_bytes:
        return _decline("out-of-core random-effect store (the lanes read resident blocks)")
    estimator._prepare_datasets(batch)
    ds = estimator._re_datasets.get(re_cfg.coordinate_id)
    if ds is None or ds.projected:
        return _decline("projected random-effect dataset")
    return CandidateLanes(estimator, base_config, slots, fe_cfg, re_cfg, batch, validation_batch, primary)


class CandidateLanes:
    """``__call__(X)``: the primary validation metric of each of the q
    candidate vectors of X (log10 λ per tuning slot), from the reference's
    mini coordinate descent run with q lanes (module docstring). Keeps one
    solve cache (the estimator's, or one of its own) across rounds, so a
    round of a q seen before replays its programs."""

    def __init__(self, estimator, base_config, slots, fe_cfg, re_cfg, batch, validation_batch, primary):
        coords = estimator._build_coordinates(batch, base_config)
        self.fe, self.re = coords[fe_cfg.coordinate_id], coords[re_cfg.coordinate_id]
        self.num_iterations = estimator.num_iterations
        self.cache = estimator.solve_cache if estimator.solve_cache is not None else SolveCache()
        self.primary = primary
        slot_for = {s.coordinate_id: i for i, s in enumerate(slots)}
        self.fe_slot, self.re_slot = slot_for.get(fe_cfg.coordinate_id), slot_for.get(re_cfg.coordinate_id)
        self.fe_base = base_config.reg[fe_cfg.coordinate_id].l2
        self.re_base = base_config.reg[re_cfg.coordinate_id].l2
        self.batch, self.validation_batch = batch, validation_batch
        self.train_lb = batch.labeled_batch(fe_cfg.feature_shard)
        self.valid_lb = validation_batch.labeled_batch(fe_cfg.feature_shard)
        self.dtype, self.device = batch.offset.dtype, batch.offset.device
        self.E, self.d_re = self.re.dataset.num_entities, self.re.dataset.dim
        norm = self.fe.objective.normalization
        self.fe_norm = norm if norm is not None and not norm.is_identity else None
        self.fe_config = dataclasses.replace(self.fe.optimizer_spec.config(), track_history=False)
        self._fe_solve = self._fe_solver()
        self._block_solves = [self._block_solver(i, b) for i, b in enumerate(self.re.dataset.blocks)]

    # --- the programs -----------------------------------------------------------------

    def _fe_solver(self) -> Callable:
        """The fixed effect's q lanes: margin L-BFGS over the shared X, unfused."""
        lb, obj = self.train_lb, dataclasses.replace(self.fe.objective, use_fused=False)
        xs = lb.features.tensors() if isinstance(lb.features, SparseFeatures) else (lb.features,)

        def make(t):
            terms = dataclasses.replace(GLMTerms.of_batch(obj, lb), offset=t["offset"])
            w_start = torch.empty_like(t["w0"])
            prog = MarginLBFGS(terms, torch.zeros_like(t["lam"]), obj.intercept_index, w_start, self.fe_config)

            def start():
                w_start.copy_(t["w0"])
                prog.l2.copy_(t["lam"])

            return prog, start, lambda: (prog.result().w,)

        name = ("fe", SolveCache._objective_key(obj)) + tuple(("id", id(x)) for x in xs + (lb.label, lb.weight))
        return self.cache.lane_solver(name, make, fixed_effect=True, pins=(obj, lb) + xs)

    def _block_solver(self, i: int, block) -> Callable:
        """Block i's (q, E_b) lanes on its production route (Newton, else
        margin L-BFGS), from model-space warm starts to model-space ends."""
        obj = self.re._block_objectives[i]
        spec, config, kernel = self.re.optimizer_spec, self.re._config, self.re._re_kernel
        newton = newton_eligible(obj, spec, block.dim, has_mask=False)

        def make(t):
            blk = dataclasses.replace(block, **{k: t[k] for k in ("features", "label", "weight", "train_mask")})
            w_start = torch.empty_like(t["w0"])
            lam = torch.zeros(t["w0"].shape[:-1], dtype=self.dtype, device=self.device)
            if newton:
                prog = Newton(obj, LabeledBatch(blk.label, blk.features, t["offsets"], blk.weight), w_start, config,
                              kernel=kernel, l2_lanes=lam)
            else:
                prog = MarginLBFGS(GLMTerms.of_block(obj, blk, t["offsets"]), lam, obj.intercept_index, w_start,
                                   config)

            def start():
                w_start.copy_(_block_start(t["w0"], obj))
                prog.l2.copy_(t["lam"][:, None].expand_as(prog.l2))

            return prog, start, lambda: (_block_end(prog.result().w, t["w0"], blk, obj, None),)

        name = ("block", newton, kernel, SolveCache._objective_key(obj), SolveCache._spec_key(spec),
                SolveCache._config_key(config))
        return self.cache.lane_solver(name, make, fixed_effect=False, pins=(obj,))

    # --- one round ----------------------------------------------------------------------

    def _re_scores(self, coefs: Tensor, batch) -> Tensor:
        """(q, n) random-effect scores, a lane's as its model scores."""
        ds = self.re.dataset
        return torch.stack([RandomEffectModel(c, ds.config.re_type, ds.config.feature_shard, self.re.task).score(batch)
                            for c in coefs])

    def _lams(self, X: np.ndarray, slot: Optional[int], base: float) -> Tensor:
        lam = 10.0 ** X[:, slot] if slot is not None else np.full(X.shape[0], base)
        return torch.as_tensor(lam, dtype=self.dtype, device=self.device)

    def __call__(self, X: np.ndarray) -> List[float]:
        X = np.asarray(X, float)
        q = X.shape[0]
        lam_fe, lam_re = self._lams(X, self.fe_slot, self.fe_base), self._lams(X, self.re_slot, self.re_base)
        lb = self.train_lb
        w = torch.zeros((q, lb.features.shape[1]), dtype=self.dtype, device=self.device)
        coefs = torch.zeros((q, self.E, self.d_re), dtype=self.dtype, device=self.device)
        for _ in range(self.num_iterations):
            offset = lb.offset + self._re_scores(coefs, self.batch)
            w_start = self.fe_norm.model_to_transformed_space(w) if self.fe_norm is not None else w
            (w_t,) = self._fe_solve(dict(w0=w_start, offset=offset, lam=lam_fe))
            w = self.fe_norm.transformed_to_model_space(w_t) if self.fe_norm is not None else w_t
            fe_scores = matvec(lb.features, w) + lb.offset
            # Every block solves from the pass's warm start, as the coordinate's do.
            new = coefs.clone()
            for block, solve in zip(self.re.dataset.blocks, self._block_solves):
                (w_b,) = solve(dict(features=block.features, label=block.label, weight=block.weight,
                                    train_mask=block.train_mask, offsets=block.gather_offsets(fe_scores),
                                    w0=self.re._dense_warm_start(coefs, block, self.d_re), lam=lam_re))
                _scatter_rows(new, block, w_b)
            coefs = new
        v = self.valid_lb
        scores = matvec(v.features, w) + v.offset + self._re_scores(coefs, self.validation_batch)
        p = self.primary
        metrics = torch.stack([evaluate(p.etype, s, v.label, v.weight, p.k) for s in scores])
        return [float(m) for m in HOST_READS.fetch(metrics)[0]]
