"""Random-effect coordinate: thousands of small per-entity GLMs, solved a
block at a time (port of photon_tpu/algorithm/random_effect.py, the dense
and projected in-process paths).

Every entity of a block is solved at once: batched damped Newton for smooth,
unmasked, shift-free problems up to d = 128 (at any width under an explicit
NEWTON spec), with its Newton systems from the K3 kernel on the card; batched
margin-space L-BFGS for the feature-masked (Pearson), shift-normalized and
wider problems, and batched gradient-form L-BFGS where a mask meets shifts
(optim/batched.py). Every lane keeps the reference's iteration count and
reason. Batched OWL-QN (an L1 weight) and TRON (an explicit TRON spec) are
not ported yet, nor the out-of-core store or per-device placement: a
coordinate that would need one raises.

Every block solve goes through the solve cache (``solve_cache``, else the
shared ``default_cache()``): the Newton route as captured CUDA graphs on the
card. The active-set gate is the reference's: from the second pass, only
entities whose coefficients still moved more than ``convergence_tol`` are
solved, repacked onto blocks of the sizes the full pass used (inside
``expect_cached``: no new capture); the masks of all blocks are read back to
the host in one transfer at the pass boundary. Every host read of the module
goes through ``HOST_READS``. The coefficient write-back drops the
shape-bucket padding rows (entity_idx -1) instead of scattering them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.algorithm.coordinate import Coordinate
from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.random_effect import (
    EntityBlock,
    RandomEffectDataset,
    compact_entity_blocks,
    pack_into_sizes,
    pearson_feature_mask,
)
from photon_tpu_torch.models.game import DatumScoringModel, ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.ops.fused_newton import resolve_re_kernel
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.ops.variance import full_hessian_variances, normalize_variance_type
from photon_tpu_torch.optim import batched
from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizerConfig,
    REASON_DIVERGED,
    REASON_FUNCTION_VALUES_CONVERGED,
    REASON_GRADIENT_CONVERGED,
    REASON_MAX_ITERATIONS,
)
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.optim.newton import EAGER_CHUNK, Newton
from photon_tpu_torch.optim.program import run_chunked
from photon_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

Tensor = torch.Tensor

# Widest per-entity dimension the default (LBFGS) spec solves by batched
# Newton; wider goes to margin L-BFGS. An explicit NEWTON spec takes any d.
NEWTON_AUTO_MAX_DIM = 128


@dataclasses.dataclass(frozen=True)
class RandomEffectTrackerStats:
    """Per-entity iteration counts and reasons of a pass, kept on the
    device; the aggregates read them back. ``valid`` masks out padding
    rows."""

    iterations: Tensor
    reasons: Tensor
    valid: Tensor
    # Σ over the solved rows of X passes × active samples (bench.py's visit
    # accounting), a device scalar.
    sample_visits: Optional[Tensor] = None

    @staticmethod
    def empty() -> "RandomEffectTrackerStats":
        z = torch.zeros(0, dtype=torch.int32)
        return RandomEffectTrackerStats(z, z, torch.zeros(0, dtype=torch.bool), torch.zeros((), dtype=torch.long))

    def _counts(self) -> Dict[str, float]:
        """Every aggregate, in one host read."""
        v, r = self.valid, self.reasons
        its = torch.where(v, self.iterations, 0)
        count = lambda m: torch.sum(m & v)  # noqa: E731
        names = ("entities", "converged", "max_iter", "quarantined", "iterations", "max_iterations")
        values = HOST_READS.fetch(
            count(torch.ones_like(v)),
            count((r == REASON_FUNCTION_VALUES_CONVERGED) | (r == REASON_GRADIENT_CONVERGED)),
            count(r == REASON_MAX_ITERATIONS), count(r == REASON_DIVERGED), torch.sum(its.long()),
            torch.max(its) if its.shape[0] else torch.zeros((), dtype=its.dtype, device=its.device))
        return dict(zip(names, (float(x) for x in values)))

    @property
    def num_entities(self) -> int:
        return int(self._counts()["entities"])

    @property
    def num_converged(self) -> int:
        return int(self._counts()["converged"])

    @property
    def num_max_iter(self) -> int:
        return int(self._counts()["max_iter"])

    @property
    def num_quarantined(self) -> int:
        """Entities whose solve diverged and kept their warm start."""
        return int(self._counts()["quarantined"])

    @property
    def mean_iterations(self) -> float:
        c = self._counts()
        return c["iterations"] / max(c["entities"], 1)

    @property
    def max_iterations(self) -> int:
        return int(self._counts()["max_iterations"])

    def summary(self) -> str:
        c = self._counts()
        return (f"entities={int(c['entities'])} converged={int(c['converged'])} "
                f"hit_max_iter={int(c['max_iter'])} quarantined={int(c['quarantined'])} "
                f"iters(mean={c['iterations'] / max(c['entities'], 1):.1f}, max={int(c['max_iterations'])})")


def _has_shifts(objective: GLMObjective) -> bool:
    norm = objective.normalization
    return norm is not None and not norm.is_identity and norm.shifts is not None


def newton_eligible(objective: GLMObjective, spec: OptimizerSpec, block_dim: int, has_mask: bool) -> bool:
    """Batched Newton serves smooth, unmasked, shift-free problems: up to
    NEWTON_AUTO_MAX_DIM under the default spec, at any width under NEWTON."""
    return (objective.l1_weight == 0.0 and not has_mask and not _has_shifts(objective)
            and (spec.optimizer == OptimizerType.NEWTON
                 or (spec.optimizer == OptimizerType.LBFGS and block_dim <= NEWTON_AUTO_MAX_DIM)))


def _block_problem(objective: GLMObjective, features: Tensor, block: EntityBlock,
                   offsets: Tensor) -> batched.BlockGLM:
    norm = objective.normalization
    folded = norm is not None and not norm.is_identity
    return batched.BlockGLM(
        objective.loss, features, block.label, block.weight, offsets, objective.l2_weight,
        objective.intercept_index, norm.factors if folded else None, norm.shifts if folded else None)


def _block_start(w0: Tensor, objective: GLMObjective) -> Tensor:
    """The solver's start: the model-space warm start in transformed space."""
    norm = objective.normalization
    return norm.model_to_transformed_space(w0) if norm is not None and not norm.is_identity else w0


def _block_end(w: Tensor, w0: Tensor, block: EntityBlock, objective: GLMObjective,
               feature_mask: Optional[Tensor]) -> Tensor:
    """The solver's end point in model space; entities under the lower bound
    keep their warm start."""
    norm = objective.normalization
    w_out = w * feature_mask if feature_mask is not None else w
    if norm is not None and not norm.is_identity:
        w_out = norm.transformed_to_model_space(w_out)
    return torch.where(block.train_mask[:, None], w_out, w0)


def block_newton(objective: GLMObjective, block: EntityBlock, offsets: Tensor, w_start: Tensor,
                 config: OptimizerConfig, re_kernel: str) -> Newton:
    """The batched Newton state machine of a block, from the transformed
    start ``w_start``."""
    return Newton(objective, LabeledBatch(block.label, block.features, offsets, block.weight), w_start,
                  config, kernel=re_kernel)


def _solve_block(block: EntityBlock, offsets: Tensor, w0: Tensor, objective: GLMObjective,
                 spec: OptimizerSpec, config: OptimizerConfig,
                 feature_mask: Optional[Tensor] = None, re_kernel: str = "torch"):
    """Solve every entity of a block from the model-space warm start w0
    (E, d), eagerly; returns (w (E, d) in model space, iterations, reasons,
    X passes), each per entity. The solve cache runs the Newton route as a
    captured state machine (``block_newton``) between the same two ends."""
    if objective.l1_weight > 0.0:
        raise NotImplementedError("batched OWL-QN for random effects under L1 is not ported yet")
    w_start = _block_start(w0, objective)
    if newton_eligible(objective, spec, block.dim, feature_mask is not None):
        prog = block_newton(objective, block, offsets, w_start, config, re_kernel)
        run_chunked(prog, EAGER_CHUNK)
        res = prog.result()
    elif spec.optimizer == OptimizerType.TRON:
        raise NotImplementedError("batched TRON for random effects is not ported yet")
    elif feature_mask is not None and _has_shifts(objective):
        # Shift normalization spans the whole w, so masking X's columns would
        # not silence masked coordinates: solve f(w ∘ m) in gradient form.
        full = _block_problem(objective, block.features, block, offsets)

        def vg(w):
            v, g = full.value_and_grad(w * feature_mask)
            return v, g * feature_mask

        res = batched.minimize_lbfgs(vg, w_start, config)
    else:
        X = block.features if feature_mask is None else block.features * feature_mask[:, None, :]
        res = batched.minimize_lbfgs_margin(_block_problem(objective, X, block, offsets), w_start, config)
    return _block_end(res.w, w0, block, objective, feature_mask), res.iterations, res.reason_code, res.x_passes


def _block_variances_of(objective: GLMObjective, block: EntityBlock, offsets: Tensor, w: Tensor,
                        vtype: VarianceComputationType) -> Tensor:
    """Per-entity SIMPLE or FULL variances at model-space w (E, d), over the
    effective (normalized) features, mapped back by the factors²."""
    norm = objective.normalization
    folded = norm is not None and not norm.is_identity
    wv = norm.model_to_transformed_space(w) if folded else w
    P = _block_problem(objective, block.features, block, offsets)
    d2 = block.weight * objective.loss.dzz(P.forward(wv) + offsets, block.label)
    Xe = block.features.to(d2.dtype)
    if folded and norm.factors is not None:
        Xe = Xe * norm.factors
    if folded and norm.shifts is not None:
        Xe = Xe - (norm.shifts if norm.factors is None else norm.shifts * norm.factors)
        if norm.intercept_index is not None:
            Xe[..., norm.intercept_index] = 1.0
    lam = torch.full((block.dim,), objective.l2_weight, dtype=d2.dtype, device=d2.device)
    if objective.intercept_index is not None:
        lam[objective.intercept_index] = 0.0
    if vtype == VarianceComputationType.SIMPLE:
        diag = torch.einsum("bn,bnd->bd", d2, Xe * Xe)
        if objective.l2_weight != 0.0:
            diag = diag + lam
        v = 1.0 / torch.clamp(diag, min=1e-12)
    else:
        H = torch.einsum("bnd,bn,bne->bde", Xe, d2, Xe)
        if objective.l2_weight != 0.0:
            H = H + torch.diag(lam)
        v = full_hessian_variances(H)
    if folded and norm.factors is not None:
        v = v * norm.factors ** 2
    return v


def _scatter_rows(table: Tensor, block: EntityBlock, rows: Tensor) -> None:
    """table[entity_idx] = rows[:, :d] for the block's real rows, in place;
    padding rows (entity_idx -1) are dropped."""
    real = block.entity_idx >= 0
    table.index_copy_(0, block.entity_idx[real].long(), rows[real, :table.shape[1]].to(table.dtype))


@dataclasses.dataclass
class RandomEffectCoordinate(Coordinate):
    """Per-entity GLMs over one random-effect type and feature shard."""

    coordinate_id: str
    dataset: RandomEffectDataset
    task: TaskType
    objective: GLMObjective
    optimizer_spec: OptimizerSpec = dataclasses.field(default_factory=OptimizerSpec)
    compute_variance: object = VarianceComputationType.NONE
    active_set: bool = False
    convergence_tol: float = 1e-4
    # The out-of-core store and per-device placement are not ported yet.
    device_budget_bytes: Optional[int] = None
    device: Optional[object] = None
    # Newton-system routing (ops.fused_newton.RE_KERNELS), resolved against
    # the blocks' device: "auto" is the K3 kernel on the card.
    re_kernel: str = "auto"
    solve_cache: Optional[SolveCache] = None

    def __post_init__(self):
        self.compute_variance = normalize_variance_type(self.compute_variance)
        if self.objective.l1_weight > 0.0:
            raise NotImplementedError(
                f"coordinate {self.coordinate_id}: batched OWL-QN for random effects under L1 "
                "is not ported yet")
        if self.optimizer_spec.optimizer == OptimizerType.TRON:
            raise NotImplementedError(
                f"coordinate {self.coordinate_id}: batched TRON for random effects is not ported yet")
        if self.device_budget_bytes:
            raise NotImplementedError("the out-of-core random-effect store is not ported yet")
        if self.device is not None:
            raise NotImplementedError("per-device placement of random-effect blocks is not ported yet")
        blocks = self.dataset.blocks
        self._device = blocks[0].features.device if blocks else torch.device("cpu")
        # Every block's entity rows and column map, in one host read.
        fetched = HOST_READS.fetch(*[b.entity_idx for b in blocks],
                                   *[b.col_map for b in blocks if b.col_map is not None]) if blocks else []
        self._block_valid_rows = [e >= 0 for e in fetched[:len(blocks)]]
        col_maps = iter(fetched[len(blocks):])
        self._host_col_maps = [None if b.col_map is None else next(col_maps) for b in blocks]
        self._re_kernel = resolve_re_kernel(self.re_kernel, self._device)
        self._config = dataclasses.replace(self.optimizer_spec.config(), track_history=False)
        self._feature_masks: Dict[int, Tensor] = {}
        ratio = self.dataset.config.features_to_samples_ratio
        if ratio is not None:
            for i, block in enumerate(blocks):
                counts = torch.sum(block.weight > 0, dim=1)
                # k_e = ratio × the entity's sample count, in f32 as the reference takes it.
                k_e = torch.clamp(torch.ceil(counts.to(torch.float32) * ratio).to(torch.int32), 1, block.dim)
                self._feature_masks[i] = pearson_feature_mask(block, k_e, always_keep=self._block_intercept(i))
        self._block_objectives = [self._block_objective(i, b) for i, b in enumerate(blocks)]
        self._block_valid_counts = [int(np.sum(v)) for v in self._block_valid_rows]
        self._total_valid_entities = int(sum(self._block_valid_counts))
        self._reset_active_set()

    def _block_intercept(self, i: int) -> Optional[int]:
        """The intercept column in block i's own columns."""
        g, col_map = self.objective.intercept_index, self._host_col_maps[i]
        if g is None or col_map is None:
            return g
        pos = np.flatnonzero(col_map == g)
        return int(pos[0]) if pos.size else None

    def _block_objective(self, i: int, block: EntityBlock) -> GLMObjective:
        """The objective with its intercept and normalization vectors in the
        block's columns (projected, or padded to a bucketed width with
        identity entries)."""
        local = self._block_intercept(i)
        norm = self.objective.normalization
        if norm is not None and not norm.is_identity:
            if block.col_map is not None:
                cm = block.col_map.long()
                norm = NormalizationContext(None if norm.factors is None else norm.factors[cm],
                                            None if norm.shifts is None else norm.shifts[cm], local)
            elif block.dim > self.dataset.dim:
                pad = block.dim - self.dataset.dim
                extend = lambda v, fill: None if v is None else torch.cat(  # noqa: E731
                    [v, torch.full((pad,), fill, dtype=v.dtype, device=v.device)])
                norm = dataclasses.replace(norm, factors=extend(norm.factors, 1.0),
                                           shifts=extend(norm.shifts, 0.0))
            return dataclasses.replace(self.objective, intercept_index=local, normalization=norm)
        if local == self.objective.intercept_index:
            return self.objective
        return dataclasses.replace(self.objective, intercept_index=local)

    # --- active-set gate ---------------------------------------------------

    def _reset_active_set(self) -> None:
        self._cd_pass = 0
        # [(active mask, quarantined mask, src block, src row)] of the last
        # pass; src maps route each mask row back to (block, row).
        self._pending_masks: Optional[list] = None
        self.last_active_set_stats: Optional[dict] = None
        self._fetched_quarantined = 0

    def begin_cd_pass(self, cd_iteration: int) -> None:
        """A descent starting at iteration 0 begins with a full pass."""
        if cd_iteration == 0:
            self._reset_active_set()

    def _fetch_active_masks(self) -> List[np.ndarray]:
        """Read the previous pass's per-entity active and quarantined masks
        of every dispatched block to the host in one transfer (the
        reference's pass-boundary fetch); entities not dispatched stay
        retired."""
        active = [np.zeros((b.num_entities,), bool) for b in self.dataset.blocks]
        pending = self._pending_masks
        fetched = HOST_READS.fetch(*[t for mask_dev, quar_dev, _sb, _sr in pending for t in (mask_dev, quar_dev)])
        quarantined = 0
        for (_m, _q, sb, sr), m, q in zip(pending, fetched[0::2], fetched[1::2]):
            valid = sr >= 0
            m = m & valid
            for b in np.unique(sb[m]):
                active[b][sr[m & (sb == b)]] = True
            quarantined += int(np.sum(q & valid))
        self._fetched_quarantined = quarantined
        return active

    def _compact_feature_mask(self, idxs, sb_local, sr, block_c) -> Optional[Tensor]:
        if not self._feature_masks:
            return None
        real = sb_local >= 0
        parts = [self._feature_masks[idxs[b]][torch.as_tensor(sr[real & (sb_local == b)]).long()]
                 for b in np.unique(sb_local[real])]
        pad = int(np.sum(~real))
        if pad:
            parts.append(torch.ones((pad, block_c.dim), dtype=parts[0].dtype, device=parts[0].device))
        return torch.cat(parts)

    def _identity_entry(self, i: int):
        b = self.dataset.blocks[i]
        valid = self._block_valid_rows[i]
        return (b, self._block_objectives[i], self._feature_masks.get(i),
                np.where(valid, i, -1).astype(np.int32),
                np.where(valid, np.arange(b.num_entities), -1).astype(np.int32))

    def _dense_dispatch_entries(self, keep: List[np.ndarray]) -> list:
        """A gated pass: pool the still-active rows of each same-geometry
        group and repack them onto the entity counts of that group's blocks,
        or dispatch the live blocks whole when repacking saves nothing."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, b in enumerate(self.dataset.blocks):
            groups.setdefault((b.n_max, b.dim), []).append(i)
        entries = []
        for idxs in groups.values():
            keeps = [keep[i] for i in idxs]
            live = [i for i, k in zip(idxs, keeps) if k.any()]
            if not live:
                continue
            members = [self.dataset.blocks[i] for i in idxs]
            allowed = [b.num_entities for b in members]
            total = int(sum(int(k.sum()) for k in keeps))
            if sum(pack_into_sizes(total, allowed)) >= sum(self.dataset.blocks[i].num_entities for i in live):
                entries.extend(self._identity_entry(i) for i in live)
                continue
            obj = self._block_objectives[idxs[0]]
            idx_arr = np.asarray(idxs, np.int32)
            for block_c, sb_local, sr in compact_entity_blocks(members, keeps, allowed):
                sb = np.where(sb_local >= 0, idx_arr[np.maximum(sb_local, 0)], -1).astype(np.int32)
                entries.append((block_c, obj, self._compact_feature_mask(idxs, sb_local, sr, block_c), sb, sr))
        return entries

    def _publish_active_set_stats(self, gated: bool, dispatched_valid: int, dispatched_alloc: int,
                                  num_dispatches: int) -> None:
        if not self.active_set:
            self.last_active_set_stats = None
            return
        total = self._total_valid_entities
        full_alloc = int(sum(b.num_entities for b in self.dataset.blocks))
        self.last_active_set_stats = dict(
            cd_pass=self._cd_pass, gated=gated, entities_total=total,
            entities_active=dispatched_valid, entities_skipped=total - dispatched_valid,
            entities_quarantined=self._fetched_quarantined, dispatched_blocks=num_dispatches,
            dispatched_entity_alloc=dispatched_alloc, full_entity_alloc=full_alloc,
            compaction_ratio=(dispatched_alloc / full_alloc) if full_alloc else 0.0,
        )

    # --- training -----------------------------------------------------------

    def train(self, batch: GameBatch, residual_scores: Optional[Tensor] = None,
              initial_model=None) -> Tuple[DatumScoringModel, RandomEffectTrackerStats]:
        total_offset = batch.offset if residual_scores is None else batch.offset + residual_scores
        if self.dataset.projected:
            return self._train_projected(total_offset, initial_model)
        return self._train_dense(batch, total_offset, initial_model)

    def _cache(self) -> SolveCache:
        return self.solve_cache if self.solve_cache is not None else default_cache()

    def _solver(self, objective: GLMObjective, tol: Optional[float], has_mask: bool):
        return self._cache().block_solver(objective, self.optimizer_spec, self._config, has_mask, convergence_tol=tol,
                                  re_kernel=self._re_kernel)

    def _train_dense(self, batch: GameBatch, total_offset: Tensor,
                     initial_model) -> Tuple[RandomEffectModel, RandomEffectTrackerStats]:
        E, d = self.dataset.num_entities, self.dataset.dim
        dtype = batch.offset.dtype
        if isinstance(initial_model, ProjectedRandomEffectModel):
            initial_model = initial_model.to_dense()
        coefs = (initial_model.coefficients if initial_model is not None
                 else torch.zeros((E, d), dtype=dtype, device=self._device))
        gated = self.active_set and self._pending_masks is not None and initial_model is not None
        if gated:
            entries = self._dense_dispatch_entries(self._fetch_active_masks())
        else:
            entries = [self._identity_entry(i) for i in range(len(self.dataset.blocks))]
        tol = self.convergence_tol if self.active_set else None

        # Every block solves from the pass's warm start; the write-back comes
        # after all of them.
        results, pending = [], []
        cache = self._cache()
        for block, obj, mask, sb, sr in entries:
            offs = block.gather_offsets(total_offset)
            solver = self._solver(obj, tol, mask is not None)
            if gated and cache.max_entries is None:
                # The repacked shapes were all captured in the full first
                # pass: a capture here is a bug. (With a bounded cache the
                # entry may have been evicted, and a rebuild is legitimate.)
                with cache.expect_cached(f"active-set dispatch {tuple(block.features.shape)}"):
                    out = solver(block, offs, self._dense_warm_start(coefs, block, d), mask)
            else:
                out = solver(block, offs, self._dense_warm_start(coefs, block, d), mask)
            w, iters, reasons, passes = out[:4]
            if tol is not None:
                pending.append((*out[4:], sb, sr))
            results.append((block, w, iters, reasons, passes))
        if tol is not None:
            self._pending_masks = pending
        self._publish_active_set_stats(
            gated, dispatched_valid=int(sum(int(np.sum(sb >= 0)) for *_x, sb, _sr in entries)),
            dispatched_alloc=int(sum(e[0].num_entities for e in entries)), num_dispatches=len(entries))
        self._cd_pass += 1

        coefs = coefs.clone()
        for block, w, *_ in results:
            _scatter_rows(coefs, block, w)
        variances = None
        if self.compute_variance != VarianceComputationType.NONE:
            variances = self._block_variances(coefs, total_offset, dtype)
        model = RandomEffectModel(coefs, self.dataset.config.re_type, self.dataset.config.feature_shard,
                                  self.task, variances)
        return model, self._tracker_stats([(b, it, rs, ps) for b, _w, it, rs, ps in results])

    def _dense_warm_start(self, coefs: Tensor, block: EntityBlock, d: int) -> Tensor:
        """(E_b, block.dim) warm start: the entities' rows (padding rows take
        row 0, inert), zero in padded columns."""
        w0 = coefs[torch.clamp(block.entity_idx, min=0).long()]
        if block.dim > d:
            w0 = torch.nn.functional.pad(w0, (0, block.dim - d))
        return w0

    def _train_projected(self, total_offset: Tensor,
                         initial_model) -> Tuple[ProjectedRandomEffectModel, RandomEffectTrackerStats]:
        """Per-block solves in each block's column subspace. The active set
        gates whole blocks here: a block is skipped once all its entities
        have converged, keeping its coefficients."""
        entity_block, entity_row, inv_maps = self.dataset.projection_tables()
        gated = (self.active_set and self._pending_masks is not None
                 and isinstance(initial_model, ProjectedRandomEffectModel))
        keep = self._fetch_active_masks() if gated else None
        tol = self.convergence_tol if self.active_set else None
        parts, pending = [], []
        dispatched_valid = dispatched_alloc = num_dispatches = 0
        block_coefs, block_offs = [], []
        for i, block in enumerate(self.dataset.blocks):
            offs = block.gather_offsets(total_offset)
            block_offs.append(offs)
            if gated and not keep[i].any():
                prev = initial_model.block_coefs[i]
                if tuple(prev.shape) == (block.num_entities, block.dim):
                    block_coefs.append(prev)
                    continue
            w0 = self._initial_block_coefs(block, i, initial_model, total_offset.dtype)
            mask = self._feature_masks.get(i)
            out = self._solver(self._block_objectives[i], tol, mask is not None)(block, offs, w0, mask)
            w_new, iters, reasons, passes = out[:4]
            if tol is not None:
                pending.append((*out[4:], np.full((block.num_entities,), i, np.int32),
                                np.arange(block.num_entities, dtype=np.int32)))
            block_coefs.append(w_new)
            parts.append((block, iters, reasons, passes))
            dispatched_valid += self._block_valid_counts[i]
            dispatched_alloc += block.num_entities
            num_dispatches += 1
        if tol is not None:
            self._pending_masks = pending
        self._publish_active_set_stats(gated, dispatched_valid, dispatched_alloc, num_dispatches)
        self._cd_pass += 1
        block_vars = None
        if self.compute_variance != VarianceComputationType.NONE:
            block_vars = [_block_variances_of(self._block_objectives[i], block, block_offs[i], block_coefs[i],
                                              self.compute_variance)
                          for i, block in enumerate(self.dataset.blocks)]
        model = ProjectedRandomEffectModel(
            block_coefs=block_coefs, col_maps=[b.col_map for b in self.dataset.blocks], inv_maps=inv_maps,
            entity_block=entity_block, entity_row=entity_row, d_full=self.dataset.dim,
            re_type=self.dataset.config.re_type, feature_shard=self.dataset.config.feature_shard,
            task=self.task, block_variances=block_vars)
        return model, self._tracker_stats(parts)

    def _initial_block_coefs(self, block: EntityBlock, block_index: int, initial_model, dtype) -> Tensor:
        """Warm start in block space from either model form."""
        if initial_model is None:
            return torch.zeros((block.num_entities, block.dim), dtype=dtype, device=self._device)
        if isinstance(initial_model, ProjectedRandomEffectModel):
            prev = initial_model.block_coefs[block_index]
            if tuple(prev.shape) == (block.num_entities, block.dim):
                return prev
            initial_model = initial_model.to_dense()
        return block.project_forward(initial_model.coefficients[torch.clamp(block.entity_idx, min=0).long()])

    def _block_variances(self, coefs: Tensor, total_offset: Tensor, dtype) -> Tensor:
        E, d = self.dataset.num_entities, self.dataset.dim
        variances = torch.ones((E, d), dtype=dtype, device=coefs.device)
        for i, block in enumerate(self.dataset.blocks):
            v = _block_variances_of(self._block_objectives[i], block, block.gather_offsets(total_offset),
                                    self._dense_warm_start(coefs, block, d), self.compute_variance)
            _scatter_rows(variances, block, v)
        return variances

    @staticmethod
    def _tracker_stats(parts) -> RandomEffectTrackerStats:
        """From per-block (block, iterations, reasons, X passes); no host
        read."""
        if not parts:
            return RandomEffectTrackerStats.empty()
        return RandomEffectTrackerStats(
            iterations=torch.cat([it.reshape(-1) for _b, it, _r, _p in parts]).to(torch.int32),
            reasons=torch.cat([r.reshape(-1) for _b, _i, r, _p in parts]).to(torch.int32),
            valid=torch.cat([b.entity_idx >= 0 for b, _i, _r, _p in parts]),
            sample_visits=sum(torch.sum(p.long() * torch.sum(b.weight > 0, dim=1)) for b, _i, _r, p in parts),
        )

    def score(self, model, batch: GameBatch) -> Tensor:
        return model.score(batch)

    def zero_model(self):
        if self.dataset.projected:
            entity_block, entity_row, inv_maps = self.dataset.projection_tables()
            return ProjectedRandomEffectModel(
                block_coefs=[torch.zeros((b.num_entities, b.dim), device=self._device)
                             for b in self.dataset.blocks],
                col_maps=[b.col_map for b in self.dataset.blocks], inv_maps=inv_maps,
                entity_block=entity_block, entity_row=entity_row, d_full=self.dataset.dim,
                re_type=self.dataset.config.re_type, feature_shard=self.dataset.config.feature_shard,
                task=self.task)
        return RandomEffectModel(torch.zeros((self.dataset.num_entities, self.dataset.dim),
                                             device=self._device),
                                 self.dataset.config.re_type, self.dataset.config.feature_shard, self.task)
