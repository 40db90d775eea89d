"""Entity-sharded random-effect coordinate: one GAME coordinate over the
ranks of a mesh (port of photon_tpu/algorithm/sharded_random_effect.py).

The coefficient store is sharded by ENTITY with the serving ring's
assignment (parallel/entity_shard.py): a FIXED number S of shards (default
8) whatever the number of ranks. Each shard is a full
:class:`~photon_tpu_torch.algorithm.random_effect.RandomEffectCoordinate`
over only its entities' samples, with its blocks, warm starts and solves on
one device; solve caching, the drop-mode write-back, the active-set gate
and out-of-core residency (one ``ReDeviceStore`` a shard, with a budget and
a spill member of its own) run unchanged inside it.

The reference is one controller placing shard s on device (s·n)//S. The
port is SPMD: rank r builds and trains the shards s with
``plan.device_of(s, world) == r``, on its own device, one at a time (the
wall of each is that device's busy time for its own work). The merge of a
pass is the one exchange: the per-shard tables are all-gathered (NCCL:
device tensors; gloo: host tensors) and scattered into the host table as
``merge_shard_coefficients`` builds it, which every rank then holds and
scores with. Shards own disjoint entities, so the merge is exact.

Bit-parity by construction: every world size builds the same per-shard
datasets and runs the same programs on the same block geometry; only the
rank that runs a shard changes. So 1, 2, 4 and 8 ranks give the same
coefficients bit for bit. A rank's shards share one solve cache, keyed by
device (algorithm/solve_cache.py), so after the first full pass no shard
captures again.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from photon_tpu_torch.algorithm.coordinate import Coordinate
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate, RandomEffectTrackerStats
from photon_tpu_torch.algorithm.solve_cache import SolveCache
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, RandomEffectDataset, build_random_effect_dataset
from photon_tpu_torch.models.game import RandomEffectModel
from photon_tpu_torch.obs.trace import span
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.parallel.entity_shard import (
    DEFAULT_N_SHARDS,
    EntityShardPlan,
    build_shard_plan,
    merge_shard_coefficients,
)
from photon_tpu_torch.parallel.mesh import Mesh, dp_axes
from photon_tpu_torch.parallel.mesh import owned_shards as mesh_owned_shards
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank_of(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(this rank's index, count) along the entity (data) axes."""
    if mesh is None:
        return 0, 1
    return mesh.index(*dp_axes(mesh)), mesh.size(*dp_axes(mesh))


def owned_shards(plan: EntityShardPlan, mesh: Optional[Mesh]) -> List[int]:
    """The shards this rank trains: ``plan.device_of(s, ranks) == rank``."""
    return mesh_owned_shards(plan.n_shards, mesh)


def _all_gather_objects(obj, mesh: Optional[Mesh]) -> list:
    """Every rank's ``obj`` (one item without a group). Ranks along the
    feature axis hold the same shards and give equal items."""
    if mesh is None or not _grouped():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def shard_datasets(plan: EntityShardPlan, shards: Sequence[int], entity_ids: np.ndarray, features, label: np.ndarray,
                   weight: np.ndarray, config: RandomEffectDataConfig, device, uid: Optional[np.ndarray] = None,
                   existing_model_mask: Optional[np.ndarray] = None) -> Dict[int, RandomEffectDataset]:
    """The datasets of ``shards``, each built from the SAME flat arrays with
    the samples of other shards' entities masked to -1 (the builder drops
    them), so ``sample_index`` keeps addressing the whole batch's rows;
    entity indices are local to the shard (ascending global order)."""
    per_shard = plan.shard_sample_entities(np.asarray(entity_ids))
    out = {}
    for s in shards:
        existing = None if existing_model_mask is None else np.asarray(existing_model_mask)[plan.entities_of(s)]
        out[s] = build_random_effect_dataset(per_shard[s], features, label, weight, int(plan.counts[s]), config,
                                             uid=uid, existing_model_mask=existing, device=device)
    return out


class ShardedRandomEffectCoordinate(Coordinate):
    """This rank's shards behind the single-coordinate protocol.

    Build with :meth:`build` (the per-shard datasets too) or
    :meth:`from_datasets`. ``train`` returns the merged model (a host
    table, every entity's coefficients from its shard), identical on every
    rank; warm starts stay per shard on the device across passes (the merged
    model passed back as ``initial_model`` is re-sliced only when it is not
    this coordinate's own last output). ``last_shard_walls`` holds this
    rank's shards' walls of the last pass (dispatch and sync), by shard.
    ``train``, ``device_busy_seconds`` and ``residency_stats`` make
    collectives: every rank calls them together.
    """

    def __init__(self, coordinate_id: str, plan: EntityShardPlan, shards: Dict[int, RandomEffectCoordinate],
                 mesh: Optional[Mesh], device, re_type: str, feature_shard: str, task: TaskType, dim: int):
        self.coordinate_id = coordinate_id
        self.plan = plan
        self.shards = dict(shards)
        self.mesh = mesh
        self.device = torch.device(device)
        self.re_type, self.feature_shard, self.task = re_type, feature_shard, task
        self.dim = int(dim)
        self.num_entities = plan.num_entities
        self._shard_models: Dict[int, RandomEffectModel] = {}
        self._last_merged: Optional[RandomEffectModel] = None
        self.last_shard_walls: Dict[int, float] = {}
        self.last_active_set_stats: Optional[dict] = None
        self.last_shard_samples: Dict[int, int] = {s: c.dataset.num_active_samples for s, c in self.shards.items()}

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, coordinate_id: str, entity_ids: np.ndarray, features, label: np.ndarray, weight: np.ndarray,
              num_entities: int, config: RandomEffectDataConfig, task: TaskType, objective: GLMObjective,
              optimizer_spec: Optional[OptimizerSpec] = None, plan: Optional[EntityShardPlan] = None,
              n_shards: int = DEFAULT_N_SHARDS, seed: int = 0, entity_index=None, mesh: Optional[Mesh] = None,
              device=None, solve_cache: Optional[SolveCache] = None, active_set: bool = False,
              convergence_tol: float = 1e-4, device_budget_bytes: Optional[int] = None,
              device_spill_dir: Optional[str] = None, re_kernel: str = "auto",
              uid: Optional[np.ndarray] = None) -> "ShardedRandomEffectCoordinate":
        """Shard the flat sample arrays (host arrays, the same on every rank)
        by entity owner and build this rank's shards on ``device`` (default:
        the mesh's). ``device_budget_bytes`` (out-of-core residency) is PER
        SHARD; shard s spills under ``<device_spill_dir>/host-<s>/``."""
        if plan is None:
            plan = build_shard_plan(num_entities, n_shards=n_shards, seed=seed, entity_index=entity_index)
        device = device if device is not None else (mesh.device if mesh is not None else "cuda")
        datasets = shard_datasets(plan, owned_shards(plan, mesh), entity_ids, features, label, weight, config, device,
                                  uid=uid)
        dim = features[2] if isinstance(features, tuple) else np.asarray(features).shape[1]
        return cls.from_datasets(coordinate_id, plan, datasets, int(dim), config, task, objective, optimizer_spec,
                                 mesh, device, solve_cache, active_set, convergence_tol, device_budget_bytes,
                                 device_spill_dir, re_kernel)

    @classmethod
    def from_datasets(cls, coordinate_id: str, plan: EntityShardPlan, datasets: Dict[int, RandomEffectDataset],
                      dim: int, config: RandomEffectDataConfig, task: TaskType, objective: GLMObjective,
                      optimizer_spec: Optional[OptimizerSpec] = None, mesh: Optional[Mesh] = None, device=None,
                      solve_cache: Optional[SolveCache] = None, active_set: bool = False,
                      convergence_tol: float = 1e-4, device_budget_bytes: Optional[int] = None,
                      device_spill_dir: Optional[str] = None,
                      re_kernel: str = "auto") -> "ShardedRandomEffectCoordinate":
        """This rank's shard coordinates over ``datasets`` (``shard_datasets``).
        ``device_budget_bytes``: every shard's budget, or a function of
        (shard, dataset) giving each its own."""
        device = device if device is not None else (mesh.device if mesh is not None else "cuda")
        spec = optimizer_spec or OptimizerSpec()
        budget = (device_budget_bytes if callable(device_budget_bytes)
                  else lambda _s, _ds: device_budget_bytes)
        shards = {s: RandomEffectCoordinate(
            coordinate_id=f"{coordinate_id}/shard{s}", dataset=ds, task=task, objective=objective,
            optimizer_spec=spec, solve_cache=solve_cache, active_set=active_set, convergence_tol=convergence_tol,
            device_budget_bytes=budget(s, ds), device_spill_dir=device_spill_dir,
            device_spill_member=s if device_spill_dir is not None else None, re_kernel=re_kernel, device=device)
            for s, ds in sorted(datasets.items())}
        return cls(coordinate_id, plan, shards, mesh, device, config.re_type, config.feature_shard, task, dim)

    # -- coordinate protocol -----------------------------------------------

    def begin_cd_pass(self, cd_iteration: int) -> None:
        for c in self.shards.values():
            c.begin_cd_pass(cd_iteration)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, batch: GameBatch, residual_scores: Optional[Tensor] = None,
              initial_model: Optional[Any] = None) -> Tuple[RandomEffectModel, RandomEffectTrackerStats]:
        inits = self._shard_initials(initial_model)
        walls: Dict[int, float] = {}
        models: Dict[int, RandomEffectModel] = {}
        stats: Dict[int, RandomEffectTrackerStats] = {}
        with span("re_sharded_train"):
            for s, coord in self.shards.items():
                # One shard at a time, synced at its end: its wall is this
                # device's busy time for it, and the order never varies.
                t0 = time.perf_counter()
                models[s], stats[s] = coord.train(batch, residual_scores, inits.get(s))
                self._sync()
                walls[s] = time.perf_counter() - t0
        self._shard_models, self.last_shard_walls = models, walls
        with span("re_sharded_merge"):
            merged = RandomEffectModel(torch.from_numpy(self._merge(models)), self.re_type, self.feature_shard,
                                       self.task)
        self._last_merged = merged
        return merged, self._merge_stats(stats)

    def _merge(self, models: Dict[int, RandomEffectModel]) -> np.ndarray:
        """The pass's exchange: every shard's table, all-gathered, scattered
        into the host table (merge_shard_coefficients)."""
        tables = {s: m.coefficients[: int(self.plan.counts[s]), : self.dim] for s, m in models.items()}
        dtype = next(iter(tables.values())).dtype if tables else torch.float32
        r, n = _rank_of(self.mesh)
        per_rank = [[s for s in range(self.plan.n_shards) if self.plan.device_of(s, n) == k] for k in range(n)]
        counts = [int(sum(self.plan.counts[s] for s in ss)) for ss in per_rank]
        if self.mesh is None or not _grouped():
            gathered = [torch.cat([tables[s] for s in per_rank[0]]) if per_rank[0] else None]
        else:
            # NCCL gathers device tensors; gloo host tensors.
            where = self.device if self.mesh.backend == "nccl" else torch.device("cpu")
            mine = torch.zeros((max(counts), self.dim), dtype=dtype, device=where)
            if per_rank[r]:
                mine[:counts[r]] = torch.cat([tables[s].to(where) for s in per_rank[r]])
            gathered = self.mesh.all_gather(mine, dp_axes(self.mesh)[-1]) if len(dp_axes(self.mesh)) == 1 \
                else self._gather_dp(mine)
        shard_coefs: List[np.ndarray] = [np.zeros((0, self.dim))] * self.plan.n_shards
        for k, ss in enumerate(per_rank):
            host = gathered[k].cpu().numpy() if ss else None
            at = 0
            for s in ss:
                c = int(self.plan.counts[s])
                shard_coefs[s] = host[at:at + c]
                at += c
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        return merge_shard_coefficients(self.plan, shard_coefs, self.dim, np_dtype)

    def _gather_dp(self, t: Tensor) -> List[Tensor]:
        """All-gather over the (slice, data) axes of a multi-slice mesh, in
        data-rank order: within each slice, then the slices' stacks."""
        mesh = self.mesh
        inner = torch.stack(mesh.all_gather(t, dp_axes(mesh)[-1]))
        outer = mesh.all_gather(inner, dp_axes(mesh)[0])
        return [row for block in outer for row in block]

    def _shard_initials(self, initial_model: Optional[Any]) -> Dict[int, Optional[RandomEffectModel]]:
        """Warm starts per shard: this coordinate's own last output reuses
        the per-shard models (no re-slicing, no upload); another dense model
        is sliced through the plan onto each shard's local entities."""
        if initial_model is None:
            return {}
        if initial_model is self._last_merged:
            return dict(self._shard_models)
        coefs = initial_model.coefficients
        coefs = coefs.cpu() if isinstance(coefs, Tensor) else torch.as_tensor(np.asarray(coefs))
        return {s: RandomEffectModel(coefs[torch.as_tensor(self.plan.entities_of(s)).long(), : self.dim]
                                     .contiguous().to(self.device), self.re_type, self.feature_shard, self.task)
                for s in self.shards}

    def _merge_stats(self, stats: Dict[int, RandomEffectTrackerStats]) -> RandomEffectTrackerStats:
        """Every shard's tracker rows, in shard order on every rank, and the
        active-set counts summed over the shards."""
        mine = {s: (st.iterations.cpu().numpy(), st.reasons.cpu().numpy(), st.valid.cpu().numpy(),
                    int(st.sample_visits) if st.sample_visits is not None else 0,
                    self.shards[s].last_active_set_stats) for s, st in stats.items()}
        allstats: Dict[int, tuple] = {}
        for part in _all_gather_objects(mine, self.mesh):
            allstats.update(part)
        order = sorted(allstats)
        act = [allstats[s][4] for s in order if allstats[s][4] is not None]
        if act:
            keys = ("entities_total", "entities_active", "entities_skipped", "entities_quarantined",
                    "dispatched_blocks", "dispatched_entity_alloc", "full_entity_alloc")
            agg = {k: int(sum(a[k] for a in act)) for k in keys}
            agg.update(cd_pass=act[0]["cd_pass"], gated=any(a["gated"] for a in act),
                       compaction_ratio=agg["dispatched_entity_alloc"] / max(agg["full_entity_alloc"], 1))
            self.last_active_set_stats = agg
        if not order:
            return RandomEffectTrackerStats.empty()
        cat = lambda i, dt: torch.from_numpy(np.concatenate([np.ravel(allstats[s][i]) for s in order]).astype(dt))  # noqa: E731
        return RandomEffectTrackerStats(iterations=cat(0, np.int32), reasons=cat(1, np.int32), valid=cat(2, bool),
                                        sample_visits=torch.tensor(sum(allstats[s][3] for s in order)))

    def score(self, model, batch: GameBatch) -> Tensor:
        return model.score(batch)

    def zero_model(self) -> RandomEffectModel:
        return RandomEffectModel(torch.zeros((self.num_entities, self.dim)), self.re_type, self.feature_shard,
                                 self.task)

    # -- diagnostics -------------------------------------------------------

    def device_busy_seconds(self, n_devices: Optional[int] = None) -> List[float]:
        """The last pass's busy seconds per rank (every rank's shard walls,
        gathered, folded through the shard → rank map of ``n_devices``
        ranks, default the mesh's)."""
        walls: Dict[int, float] = {}
        for part in _all_gather_objects(self.last_shard_walls, self.mesh):
            walls.update(part)
        n = n_devices if n_devices is not None else _rank_of(self.mesh)[1]
        busy = [0.0] * n
        for s, w in walls.items():
            busy[self.plan.device_of(s, n)] += w
        return busy

    def residency_stats(self) -> List[Optional[dict]]:
        """Every shard's out-of-core store statistics (None: resident), by
        shard, gathered from every rank."""
        out: Dict[int, Optional[dict]] = {}
        for part in _all_gather_objects({s: c.last_residency_stats for s, c in self.shards.items()}, self.mesh):
            out.update(part)
        return [out.get(s) for s in range(self.plan.n_shards)]
