"""Random-effect coordinate: thousands of small per-entity GLMs, solved a
block at a time (port of photon_tpu/algorithm/random_effect.py, the dense
and projected in-process paths).

Every entity of a block is solved at once, by one solver program with a
lane an entity (optim/program.py), on the reference's routes in the
reference's order: OWL-QN under an L1 weight (L1 or elastic net, the
intercept unpenalized); batched damped Newton for smooth, unmasked,
shift-free problems up to d = 128 (at any width under an explicit NEWTON
spec), with its Newton systems from the K3 kernel on the card; TRON under an
explicit TRON spec (the Pearson mask folded into the Hessian-vector
product); then margin-space L-BFGS for the feature-masked (Pearson),
shift-normalized and wider problems, and gradient-form L-BFGS where a mask
meets shifts. Every lane keeps the reference's iteration count and reason.
With ``device=`` the coordinate's blocks, coefficient table and solves are
committed to that device (the entity-sharded path,
algorithm/sharded_random_effect.py): dense datasets only, no variances, as
in the reference.

With ``device_budget_bytes`` a dense coordinate trains out of core: its
blocks become a host master (optionally memory-mapped under
``device_spill_dir``) and only a byte-budgeted working set lives on the
device (algorithm/re_store.py); blocks are uploaded by a stage thread ahead
of the solves and the results downloaded by another behind them. Every warm
start gathers from the previous pass's host table and results round-trip
losslessly, so the coefficients are bit for bit those of the fully resident
run; the model's coefficient table is the host master.

Every block solve goes through the solve cache (``solve_cache``, else the
shared ``default_cache()``): every route as captured CUDA graphs on the
card. The active-set gate is the reference's: from the second pass, only
entities whose coefficients still moved more than ``convergence_tol`` are
solved, repacked onto blocks of the sizes the full pass used (inside
``expect_cached``: no new capture); the masks of all blocks are read back to
the host in one transfer at the pass boundary, and ``export_active_state`` /
``restore_active_state`` carry them through a checkpoint. Every host read of
the module goes through ``HOST_READS``. The ``solve.re_block`` fault site
poisons a block's offsets at its dispatch (``utils/faults.py``), which the
solve cache's in-graph quarantine then contains. The coefficient write-back drops the
shape-bucket padding rows (entity_idx -1) instead of scattering them.
"""

from __future__ import annotations

import dataclasses
import logging
import time
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
from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizerConfig,
    REASON_DIVERGED,
    REASON_FUNCTION_VALUES_CONVERGED,
    REASON_GRADIENT_CONVERGED,
    REASON_MAX_ITERATIONS,
)
from photon_tpu_torch.optim.factory import OptimizerSpec, l1_mask
from photon_tpu_torch.optim.lbfgs import LBFGS
from photon_tpu_torch.optim.margin_lbfgs import MarginLBFGS
from photon_tpu_torch.optim.newton import Newton
from photon_tpu_torch.optim.owlqn import OWLQN
from photon_tpu_torch.optim.problem import GLMOracle, GLMTerms
from photon_tpu_torch.optim.program import EAGER_CHUNK, Program, run_chunked
from photon_tpu_torch.optim.tron import TRON
from photon_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType
from photon_tpu_torch.utils import faults

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

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


def block_program(objective: GLMObjective, spec: OptimizerSpec, config: OptimizerConfig, block: EntityBlock,
                  offsets: Tensor, w_start: Tensor, feature_mask: Optional[Tensor] = None,
                  re_kernel: str = "torch") -> Program:
    """The solver program of a block on the reference's route (module
    docstring), one lane an entity, from the transformed start ``w_start``
    (E, d); it reads the block's tensors, ``offsets``, ``feature_mask`` and
    ``w_start`` in place."""
    oracle = lambda: GLMOracle(GLMTerms.of_block(objective, block, offsets), objective.l2_weight,  # noqa: E731
                               objective.intercept_index, w_start.dtype, mask=feature_mask)
    if objective.l1_weight > 0.0:
        return OWLQN(oracle(), w_start, objective.l1_weight, config, l1_mask(objective, w_start))
    if newton_eligible(objective, spec, block.dim, feature_mask is not None):
        return Newton(objective, LabeledBatch(block.label, block.features, offsets, block.weight), w_start,
                      config, kernel=re_kernel)
    if spec.optimizer == OptimizerType.TRON:
        return TRON(oracle(), w_start, config, spec.max_cg_iter)
    if feature_mask is not None and _has_shifts(objective):
        # Shift normalization spans the whole w, so masking X's columns would
        # not silence masked coordinates: solve f(w ∘ m) in gradient form.
        return LBFGS(oracle(), w_start, config)
    # Margin-space L-BFGS on X ∘ m: masked coordinates appear only in the
    # separable L2 term and reach the gradient-masked optimum.
    return MarginLBFGS(GLMTerms.of_block(objective, block, offsets, col_mask=feature_mask), objective.l2_weight,
                       objective.intercept_index, w_start, config)


def _solve_block(block: EntityBlock, offsets: Tensor, w0: Tensor, objective: GLMObjective,
                 spec: OptimizerSpec, config: OptimizerConfig,
                 feature_mask: Optional[Tensor] = None, re_kernel: str = "torch"):
    """Solve every entity of a block from the model-space warm start w0
    (E, d), eagerly; returns (w (E, d) in model space, iterations, reasons,
    X passes), each per entity. The solve cache captures the same program
    (``block_program``) between the same two ends."""
    prog = block_program(objective, spec, config, block, offsets, _block_start(w0, objective), feature_mask,
                         re_kernel)
    run_chunked(prog, EAGER_CHUNK)
    res = prog.result()
    return _block_end(res.w, w0, block, objective, feature_mask), res.iterations, res.reason_code, res.x_passes


def _block_variances_of(objective: GLMObjective, block: EntityBlock, offsets: Tensor, w: Tensor,
                        vtype: VarianceComputationType) -> Tensor:
    """Per-entity SIMPLE or FULL variances at model-space w (E, d), over the
    effective (normalized) features, mapped back by the factors²."""
    norm = objective.normalization
    folded = norm is not None and not norm.is_identity
    wv = norm.model_to_transformed_space(w) if folded else w
    terms = GLMTerms.of_block(objective, block, offsets)
    d2 = terms.curvature(terms.forward(wv) + offsets)
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


def _block_to(block: EntityBlock, device) -> EntityBlock:
    return dataclasses.replace(block, **{f.name: getattr(block, f.name).to(device)
                                         for f in dataclasses.fields(block) if getattr(block, f.name) is not None})


def _scatter_rows(table: Tensor, block: EntityBlock, rows: Tensor) -> None:
    """table[..., entity_idx, :] = rows[..., :, :d] for the block's real rows,
    in place; padding rows (entity_idx -1) are dropped."""
    real = block.entity_idx >= 0
    table.index_copy_(-2, block.entity_idx[real].long(), rows[..., real, :table.shape[-1]].to(table.dtype))


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
    # Out-of-core residency: with a byte budget, block data lives in a host
    # master (optionally memory-mapped under ``device_spill_dir``) and only
    # a budgeted working set is on the device, managed by
    # algorithm/re_store.ReDeviceStore. None: fully resident (default).
    device_budget_bytes: Optional[int] = None
    device_spill_dir: Optional[str] = None
    # Host-owned spill layout: with a member id, spill files live under
    # ``<device_spill_dir>/host-<k>/`` (re_store.partition_spill_dir).
    device_spill_member: Optional[str] = None
    # Per-device placement (the entity-sharded path): blocks, coefficients
    # and solves on this device. None: where the blocks were built.
    device: Optional[object] = None
    # Newton-system routing (ops.fused_newton.RE_KERNELS), resolved against
    # the blocks' device: "auto" is the K3 kernel on the card.
    re_kernel: str = "auto"
    solve_cache: Optional[SolveCache] = None

    def __post_init__(self):
        self.compute_variance = normalize_variance_type(self.compute_variance)
        if self.device is not None:
            if self.dataset.projected:
                raise ValueError("per-device placement supports dense RE datasets only (projected blocks route "
                                 "through the default device)")
            if self.compute_variance != VarianceComputationType.NONE:
                raise ValueError("per-device placement does not support coefficient variance computation")
        blocks = self.dataset.blocks
        host_master = bool(blocks) and isinstance(blocks[0].features, np.ndarray)
        if self.device is not None:
            self._device = torch.device(self.device)
        elif host_master:
            self._device = self.dataset.host_master_device
        else:
            self._device = blocks[0].features.device if blocks else torch.device("cpu")
        if self.device is not None and not host_master and not self.device_budget_bytes:
            # Commit every block to the owning device before derived state
            # (Pearson masks follow the blocks).
            self.dataset.blocks = blocks = [_block_to(b, self._device) for b in blocks]
        self._store = None
        self.last_residency_stats: Optional[dict] = None
        if self.device_budget_bytes:
            if self.dataset.projected:
                logger.warning("coordinate %s: out-of-core residency supports dense RE datasets only (projected "
                               "blocks keep content-defined col_map widths); training fully resident",
                               self.coordinate_id)
            elif self.dataset.config.features_to_samples_ratio is not None:
                raise ValueError("out-of-core residency is incompatible with features_to_samples_ratio (Pearson "
                                 "masks pin every block on device at construction)")
            elif self.compute_variance != VarianceComputationType.NONE:
                raise ValueError("out-of-core residency does not support coefficient variance computation (the "
                                 "variance pass re-reads every block outside the residency budget)")
            else:
                from photon_tpu_torch.algorithm.re_store import ReDeviceStore

                self._store = ReDeviceStore(blocks, self.device_budget_bytes, self.coordinate_id,
                                            self.device_spill_dir, device=self._device,
                                            spill_member=self.device_spill_member)
                # From here on the dataset's blocks ARE the host master: the
                # device holds them only through the store's uploads.
                self.dataset.blocks = blocks = self._store.blocks
                self.dataset.host_master_device = self._device
        if self._store is None and host_master:
            raise ValueError(f"coordinate {self.coordinate_id}: the dataset's blocks are a host master; it trains "
                             "only with a device budget")
        # Every block's entity rows and column map (device tensors in one
        # host read).
        values = [b.entity_idx for b in blocks] + [b.col_map for b in blocks if b.col_map is not None]
        on_device = [v for v in values if isinstance(v, Tensor)]
        got = iter(HOST_READS.fetch(*on_device)) if on_device else iter(())
        fetched = [next(got) if isinstance(v, Tensor) else np.asarray(v) for v in values]
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
        # Set by a restore: this process's cache has not seen the full pass
        # whose block shapes the first gated pass repacks onto.
        self._gate_restored = False

    def begin_cd_pass(self, cd_iteration: int) -> None:
        """A descent starting at iteration 0 begins with a full pass. With an
        out-of-core store, this is also the residency epoch boundary
        (per-pass eviction accounting; resident blocks stay warm)."""
        if cd_iteration == 0:
            self._reset_active_set()
        if self._store is not None:
            self._store.begin_pass(cd_iteration)

    def export_active_state(self) -> Optional[dict]:
        """Checkpointable snapshot of the active-set gate: the pass counter
        and the resolved per-block keep masks (host bool arrays), or None
        when there is no gate state (active set off, or no pass yet)."""
        if not self.active_set or self._pending_masks is None:
            return None
        keep = self._fetch_active_masks(count_quarantined=False)
        return dict(cd_pass=int(self._cd_pass), keep=[np.asarray(k) for k in keep])

    def restore_active_state(self, state: Optional[dict]) -> None:
        """Inverse of :meth:`export_active_state`: the keep masks become
        identity-mapped pending entries, so the first resumed pass is gated
        exactly as the interrupted run's would have been."""
        self._reset_active_set()
        if not self.active_set or state is None:
            return
        self._cd_pass = int(state["cd_pass"])
        pending = []
        for i, k in enumerate(state["keep"]):
            k = (k.cpu().numpy() if isinstance(k, Tensor) else np.asarray(k)).astype(bool)
            valid = self._block_valid_rows[i]
            sb = np.where(valid, i, -1).astype(np.int32)
            sr = np.where(valid, np.arange(k.shape[0], dtype=np.int32), -1).astype(np.int32)
            pending.append((torch.as_tensor(k, device=self._device),
                            torch.zeros(k.shape, dtype=torch.bool, device=self._device), sb, sr))
        self._pending_masks = pending
        self._gate_restored = True

    def _fetch_active_masks(self, count_quarantined: bool = True) -> List[np.ndarray]:
        """Read the previous pass's per-entity active and quarantined masks
        of every dispatched block to the host in one transfer (the
        reference's pass-boundary fetch); entities not dispatched stay
        retired."""
        active = [np.zeros((b.num_entities,), bool) for b in self.dataset.blocks]
        pending = self._pending_masks
        # The out-of-core pass downloaded its masks already (host arrays).
        masks = [t for mask_dev, quar_dev, _sb, _sr in pending for t in (mask_dev, quar_dev)]
        on_device = [t for t in masks if isinstance(t, Tensor)]
        got = iter(HOST_READS.fetch(*on_device)) if on_device else iter(())
        fetched = [next(got) if isinstance(t, Tensor) else t for t in masks]
        quarantined = 0
        for (_m, _q, sb, sr), m, q in zip(pending, fetched[0::2], fetched[1::2]):
            valid = sr >= 0
            m = m & valid
            for b in np.unique(sb[m]):
                active[b][sr[m & (sb == b)]] = True
            quarantined += int(np.sum(q & valid))
        if count_quarantined:
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
        if self.device is not None:
            # Every block gather stays on the owning device.
            total_offset = total_offset.to(self._device)
        if self.dataset.projected:
            return self._train_projected(total_offset, initial_model)
        if self._store is not None:
            return self._train_dense_ooc(batch, total_offset, initial_model)
        return self._train_dense(batch, total_offset, initial_model)

    def _cache(self) -> SolveCache:
        return self.solve_cache if self.solve_cache is not None else default_cache()

    def _solver(self, objective: GLMObjective, tol: Optional[float], has_mask: bool):
        # The cache's block buffers, sized for this coordinate's largest
        # block before its first solve (no later block grows them).
        self._cache().reserve_block_inputs(self.dataset.blocks, self._device, has_mask)
        return self._cache().block_solver(objective, self.optimizer_spec, self._config, has_mask, convergence_tol=tol,
                                  re_kernel=self._re_kernel)

    def _train_dense(self, batch: GameBatch, total_offset: Tensor,
                     initial_model) -> Tuple[RandomEffectModel, RandomEffectTrackerStats]:
        E, d = self.dataset.num_entities, self.dataset.dim
        dtype = batch.offset.dtype
        if isinstance(initial_model, ProjectedRandomEffectModel):
            initial_model = initial_model.to_dense()
        # A warm start whose table is a host master moves to the blocks' device.
        coefs = (initial_model.coefficients.to(self._device) if initial_model is not None
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
            offs = faults.poison("solve.re_block", block.gather_offsets(total_offset))
            solver = self._solver(obj, tol, mask is not None)
            if gated and cache.max_entries is None and not self._gate_restored:
                # The repacked shapes were all captured in the full first
                # pass: a capture here is a bug. (With a bounded cache the
                # entry may have been evicted, and after a restore the full
                # pass ran in another process: a build is legitimate.)
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
        self._gate_restored = False

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
        """(..., E_b, block.dim) warm start: the entities' rows of coefs (...,
        E, d) (padding rows take row 0, inert), zero in padded columns."""
        w0 = coefs[..., torch.clamp(block.entity_idx, min=0).long(), :]
        if block.dim > d:
            w0 = torch.nn.functional.pad(w0, (0, block.dim - d))
        return w0

    def _train_dense_ooc(self, batch: GameBatch, total_offset: Tensor,
                         initial_model) -> Tuple[RandomEffectModel, RandomEffectTrackerStats]:
        """Out-of-core dense pass: host master coefficients and block data,
        the device working set under the store's byte budget, an h2d upload
        stage ahead of the dispatch loop and a d2h download worker behind
        it, both bounded.

        Bit for bit the resident pass (:meth:`_train_dense`):

        * every warm start gathers from ``coefs_prev``, the previous pass's
          table frozen at the pass start, as the resident pass's do (its
          write-back comes after every solve);
        * an uploaded block is a copy of the resident path's block (same
          arrays, same geometry), so it runs the same cached program;
        * results come back as copies and land in disjoint rows of
          ``coefs_out``, so the order of downloads cannot change a value.

        The host master keeps the batch's dtype (the reference casts it to
        float32), so a float64 run is bitwise the float64 resident run. The
        model's coefficients are the host table (a CPU tensor); scoring
        copies it to the batch's device."""
        from photon_tpu_torch.algorithm.re_store import block_data_bytes
        from photon_tpu_torch.io.pipeline import DEFAULT_QUEUE_DEPTH, RetryPolicy, StageWorker, _run_staged
        from photon_tpu_torch.utils.timed import PipelineStats, record_pipeline

        store = self._store
        E, d = self.dataset.num_entities, self.dataset.dim
        if isinstance(initial_model, ProjectedRandomEffectModel):
            initial_model = initial_model.to_dense()
        if initial_model is None:
            coefs_prev = np.zeros((E, d), torch.empty(0, dtype=batch.offset.dtype).numpy().dtype)
        elif initial_model.coefficients.device.type == "cpu":
            coefs_prev = initial_model.coefficients.numpy()
        else:
            (coefs_prev,) = HOST_READS.fetch(initial_model.coefficients)
        coefs_out = coefs_prev.copy()
        gated = self.active_set and self._pending_masks is not None and initial_model is not None
        store.begin_pass(self._cd_pass)
        if gated:
            keep = self._fetch_active_masks()
            # The residency policy IS the active set: blocks whose entities
            # all converged are evicted at the pass boundary.
            store.retire([i for i, k in enumerate(keep) if self._block_valid_counts[i] and not k.any()])
            entries = self._dense_dispatch_entries(keep)
        else:
            entries = [self._identity_entry(i) for i in range(len(self.dataset.blocks))]
        tol = self.convergence_tol if self.active_set else None

        # Residency keys: original blocks cache across passes under their
        # index; compacted blocks are transient (their geometry follows the
        # pass's active set) and released once their results are down.
        block_ids = {id(b): i for i, b in enumerate(self.dataset.blocks)}
        plan = [(block_ids.get(id(entry[0]), ("compact", self._cd_pass, j)), entry)
                for j, entry in enumerate(entries)]

        def upload(item):
            key, (block, obj, mask, sb, sr) = item
            eidx = np.asarray(block.entity_idx)
            w0 = coefs_prev[np.maximum(eidx, 0)]
            if block.dim > d:
                w0 = np.pad(w0, ((0, 0), (0, block.dim - d)))
            cacheable = isinstance(key, int)
            dev_block, w0_dev = store.acquire(key, block, w0, cacheable)
            return (block_data_bytes(block), key, cacheable, block, dev_block, obj, mask, sb, sr, eidx, w0_dev)

        results_host: list = []
        pending_host: list = []

        def download(item):
            key, cacheable, block, sb, sr, eidx, out, done = item
            host = store.download(out, done)
            w, iters, reasons, passes = host[:4]
            valid = eidx >= 0
            coefs_out[eidx[valid]] = w[valid, :d]
            counts = np.sum(np.asarray(block.weight) > 0, axis=1)
            results_host.append((eidx, iters, reasons, passes, counts))
            if tol is not None:
                pending_host.append((host[4], host[5], sb, sr))
            store.mark_solve_done()
            store.release(key, cacheable)

        label = f"re_store/{self.coordinate_id}"
        stats = PipelineStats(overlapped=True)
        record_pipeline(label, stats)
        solve_stage = stats.stage("solve")
        worker = StageWorker("d2h", download, stats.stage("d2h"), depth=DEFAULT_QUEUE_DEPTH,
                             nbytes_of=lambda item, _res: int(item[6][0].numel() * item[6][0].element_size()))
        # No skip budget: a block dropped from the plan would leave its
        # entities unsolved.
        gen = _run_staged(lambda: iter(plan), lambda item: 0, [("h2d", upload, lambda out: out[0])], stats,
                          depth=DEFAULT_QUEUE_DEPTH, overlap=True, source_name="plan", retry=RetryPolicy())
        cache = self._cache()
        t0_wall = time.perf_counter()
        try:
            for (_nb, key, cacheable, block, dev_block, obj, mask, sb, sr, eidx, w0_dev) in gen:
                store.handover(key, dev_block, w0_dev)
                t0 = time.perf_counter()
                offs = faults.poison("solve.re_block", dev_block.gather_offsets(total_offset))
                solver = self._solver(obj, tol, mask is not None)
                store.mark_solve_start()
                if gated and cache.max_entries is None and not self._gate_restored:
                    with cache.expect_cached(f"out-of-core dispatch {tuple(dev_block.features.shape)}"):
                        out = solver(dev_block, offs, w0_dev, mask)
                else:
                    out = solver(dev_block, offs, w0_dev, mask)
                done = store.solve_event()
                solve_stage.add_busy(time.perf_counter() - t0, 0)
                worker.submit((key, cacheable, block, sb, sr, eidx, out, done))
                del dev_block, w0_dev, offs, out
            worker.close()
        except BaseException:
            store.abort_pass()
            worker.abort()
            raise
        finally:
            gen.close()
            stats.wall_s = time.perf_counter() - t0_wall
            store.end_pass()

        if tol is not None:
            self._pending_masks = pending_host
        self._publish_active_set_stats(
            gated, dispatched_valid=int(sum(int(np.sum(sb >= 0)) for *_x, sb, _sr in entries)),
            dispatched_alloc=int(sum(e[0].num_entities for e in entries)), num_dispatches=len(entries))
        self._cd_pass += 1
        self._gate_restored = False
        self.last_residency_stats = dict(store.stats(), pipeline=stats.summary())

        model = RandomEffectModel(torch.from_numpy(coefs_out), self.dataset.config.re_type,
                                  self.dataset.config.feature_shard, self.task, None)
        if not results_host:
            return model, RandomEffectTrackerStats.empty()
        cat = lambda i: np.concatenate([np.ravel(r[i]) for r in results_host])  # noqa: E731
        return model, RandomEffectTrackerStats(
            iterations=torch.from_numpy(cat(1).astype(np.int32)),
            reasons=torch.from_numpy(cat(2).astype(np.int32)),
            valid=torch.from_numpy(cat(0) >= 0),
            sample_visits=torch.tensor(int(np.sum(cat(3).astype(np.int64) * cat(4))), dtype=torch.long))

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
            offs = faults.poison("solve.re_block", block.gather_offsets(total_offset))
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
