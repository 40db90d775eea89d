"""Hot/cold entity coefficient store for online GAME scoring (port of
photon_tpu/serve/store.py).

Per-entity coefficient rows live COLD on the host (the master copy,
``load_resolved_game_model(to_device=False)``) and HOT in device tables
under a byte budget, with LRU demotion. Request entity ids resolve to hot
table SLOTS; a miss gathers its rows from the host master into a pinned
staging buffer and uploads them with one ``index_copy_`` a table. The device
tables are allocated once, when the store is built, and an upload changes
their VALUES only: a CUDA graph the engine captured over them at warm-up
reads every later promotion, and nothing is allocated on the miss path (the
staging buffers are allocated at ``warm_uploads``).

Coordinates sharing a random-effect type share ONE slot assignment (they
are indexed by the same entity id column), so the LRU is per type with one
device table per coordinate (data/residency.py ``SlotLru``, shared with the
out-of-core training store). A type whose full table fits the budget is
PINNED: full residency, entity ids pass through as slots, no miss path.
Unknown and cold entities resolve to -1 and score 0, the batch path's
cold-start semantics.

Projected (subspace) random effects are cached at block granularity: each
block keeps a hot row pool, and the device entity→(block, row) maps are
rewritten as entities promote and demote (a demoted entity's entry goes to
-1; every entity of a batch is promoted before the scorer runs, so a stale
row is never read).

``device_shards=S`` splits every dense hot table into S contiguous entity
segments by the consistent-hash plan the sharded trainer uses
(parallel/entity_shard.py). The segments lie on the store's one device (the
reference's single-device case); across processes, sharding is the fleet's.

The store is single-writer: the engine serializes ``resolve`` and uploads
under its batch lock. Its counts (hits, misses, demotions, uploads, foreign
entities) go to the metrics registry under the reference's names, and
``stats()`` carries them too.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.residency import SlotLru
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel, GameModel, ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.serve.routing import HashRing
from photon_tpu_torch.utils import faults, resources

logger = logging.getLogger(__name__)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class StorePartition:
    """Entity-shard ownership for ONE fleet replica: the store serves only
    the entities the consistent-hash ring assigns ``replica_id``; a foreign
    entity resolves to -1 and scores fixed-effect only.
    ``compact_host=True`` also keeps only the owned rows in the host master.
    ``re_types=None`` shards every budget-managed type. Pinned types are
    never sharded."""

    replica_id: str
    ring: HashRing
    re_types: Optional[tuple] = None
    compact_host: bool = True

    def applies_to(self, re_type: str) -> bool:
        return self.re_types is None or re_type in self.re_types

    def owns(self, key) -> bool:
        return self.ring.owner(str(key)) == self.replica_id


def _owned_mask(partition: StorePartition, entity_index, num_entities: int) -> np.ndarray:
    """(E,) bool: the entities this replica owns, hashing the string the
    router hashes (the raw id through the entity index, else the decimal
    index)."""
    owned = np.zeros(num_entities, bool)
    for i in range(num_entities):
        owned[i] = partition.owns(entity_index.entity_id(i) if entity_index is not None else i)
    return owned


# The store's counts and the registry counters they publish.
_COUNTERS = {
    "hits": "serve_store_hits_total",
    "misses": "serve_store_misses_total",
    "demotions": "serve_store_demotions_total",
    "foreign": "serve_store_foreign_total",
    "handoff_rows": "serve_store_handoff_rows_total",
    "handoff_promoted": "serve_store_handoff_promoted_total",
    "oom_retries": "serve_store_oom_evictions_total",
    "delta_clones": "serve_store_delta_clones_total",
}


def _bump(counts, name: str, re_type: Optional[str] = None, n: int = 1) -> None:
    """Add ``n`` to a store count and to its registry counter."""
    if re_type is None:
        counts[name] += n
        registry().counter(_COUNTERS[name]).inc(n)
    else:
        counts[name, re_type] += n
        registry().counter(_COUNTERS[name], re_type=re_type).inc(n)


def _oom_contained(re_type: str, fn, counts):
    """Run a device upload with OOM containment: release cached device
    memory and retry once; a second OOM becomes a
    :class:`~photon_tpu_torch.utils.resources.DeviceMemoryError`. ``fn``
    must be idempotent."""
    try:
        return fn()
    except Exception as exc:
        if not resources.is_device_oom(exc):
            raise
        _bump(counts, "oom_retries", re_type)
        logger.warning("serve store: device OOM uploading %s rows; releasing cached memory and retrying once: %s",
                       re_type, exc)
        resources._release_device_memory()
        try:
            return fn()
        except Exception as exc2:
            if not resources.is_device_oom(exc2):
                raise
            raise resources.DeviceMemoryError(
                f"serve store: device OOM uploading {re_type} rows even after releasing cached memory. Shrink "
                "--hot-bytes-mb or the max batch size, or add device memory.") from exc2


class _Staging:
    """Pinned host rows and device buffers of one upload target, sized at
    ``warm_uploads`` for the most rows one resolve can move."""

    def __init__(self, rows: int, dim: int, dtype, device: torch.device):
        pin = device.type == "cuda"
        self.host = torch.empty((rows, dim), dtype=dtype, pin_memory=pin)
        self.host_idx = torch.empty((rows,), dtype=torch.int64, pin_memory=pin)
        self.dev = torch.empty((rows, dim), dtype=dtype, device=device)
        self.dev_idx = torch.empty((rows,), dtype=torch.int64, device=device)

    def upload(self, table: torch.Tensor, idx: np.ndarray, rows: np.ndarray) -> None:
        """``table[idx] = rows``: the rows into pinned memory, copied to
        the device buffers, then one ``index_copy_``."""
        m = int(idx.shape[0])
        if m > self.host.shape[0]:
            raise RuntimeError(f"serve store: {m} rows in one upload, staging sized for {self.host.shape[0]}")
        self.host[:m].view(-1, self.host.shape[1]).numpy()[:] = rows.reshape(m, -1)
        self.host_idx[:m].numpy()[:] = idx
        self.dev[:m].copy_(self.host[:m], non_blocking=True)
        self.dev_idx[:m].copy_(self.host_idx[:m], non_blocking=True)
        table.index_copy_(0, self.dev_idx[:m], self.dev[:m].view((m,) + tuple(table.shape[1:])))
        if table.device.type == "cuda":
            # The pinned rows are rewritten by the next upload.
            torch.cuda.current_stream(table.device).synchronize()


@dataclasses.dataclass
class _ReGroup:
    """The random-effect coordinates of one RE type: one slot LRU, one
    device table per coordinate."""

    re_type: str
    coord_ids: List[str]
    host_coefs: Dict[str, np.ndarray]  # cid -> (E, d) float32 master copy
    num_entities: int
    capacity: int  # hot rows (== num_entities when pinned)
    pinned: bool
    tables: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    lru: Optional[SlotLru] = None
    # Fleet partition: ownership of each dense entity (None: unsharded) and
    # each entity's compacted host row (-1: absent).
    owned: Optional[np.ndarray] = None
    compact_of: Optional[np.ndarray] = None
    # Device shards: S contiguous segments of ``shard_cap`` rows; pinned
    # groups address the table through ``perm`` (entity -> shard-grouped
    # slot), unpinned ones run one SlotLru a segment.
    shard_plan: Optional[object] = None
    shard_cap: Optional[int] = None
    perm: Optional[np.ndarray] = None
    shard_lrus: Optional[List[SlotLru]] = None
    staging: Dict[str, _Staging] = dataclasses.field(default_factory=dict)

    @property
    def row_bytes(self) -> int:
        return sum(4 * c.shape[1] for c in self.host_coefs.values())

    def _lru_for(self, entity: int) -> SlotLru:
        if self.shard_lrus is not None:
            return self.shard_lrus[int(self.shard_plan.shard_of[entity])]
        return self.lru

    def slot_get(self, entity: int) -> Optional[int]:
        return self._lru_for(entity).get(entity)

    def slot_peek(self, entity: int) -> Optional[int]:
        return self._lru_for(entity).peek(entity)

    def slot_claim(self, entity: int, protected) -> int:
        return self._lru_for(entity).claim(entity, protected)

    def resident_count(self) -> int:
        if self.pinned:
            return self.num_entities
        if self.shard_lrus is not None:
            return sum(len(lru) for lru in self.shard_lrus)
        return len(self.lru)


@dataclasses.dataclass
class _ProjCoord:
    """One projected coordinate's hot state: per-block hot tables and the
    device entity→(block, row) maps the scorer gathers through."""

    cid: str
    sub: ProjectedRandomEffectModel  # host master
    host_blocks: List[np.ndarray]  # [(E_b, d_b) float32]
    entity_block: np.ndarray  # (E,) host master map
    entity_row: np.ndarray  # (E,)
    capacities: List[int]  # hot rows a block
    lrus: List[Optional[SlotLru]]  # entity -> hot row, a block
    tables: List[torch.Tensor]  # device [(H_b, d_b)]
    dev_entity_block: torch.Tensor  # device (E,) int32; -1 = cold (scores 0)
    dev_entity_row: torch.Tensor  # device (E,) int32
    col_maps: List[torch.Tensor]
    inv_maps: List[torch.Tensor]
    demoted: List[int] = dataclasses.field(default_factory=list)
    staging: List[_Staging] = dataclasses.field(default_factory=list)
    map_staging: Optional[List[_Staging]] = None  # entity_block's and entity_row's

    @property
    def hot_bytes(self) -> int:
        return sum(4 * h * b.shape[1] for h, b in zip(self.capacities, self.host_blocks))


@dataclasses.dataclass
class _ProjGroup:
    """Projected coordinates of one RE type. ``resolve`` returns entity
    indices (the per-coordinate device maps translate them), so each
    coordinate promotes into its own block tables."""

    re_type: str
    num_entities: int
    coords: List[_ProjCoord]
    pinned: bool  # every coordinate fully resident: no promotion path
    owned: Optional[np.ndarray] = None  # fleet partition mask (no compaction)


class HotColdEntityStore:
    """Entity-model residency manager and scoring-model factory.

    ``hot_bytes`` bounds the device bytes of CACHED random-effect tables
    (split across RE types in proportion to their full size), floored at
    ``min_hot_rows`` rows a type (the engine passes its max batch size, so
    one batch's unique entities always fit at once). Tables live on
    ``device``.
    """

    def __init__(self, model: GameModel, entity_indexes: Optional[Dict] = None, hot_bytes: int = 64 << 20,
                 min_hot_rows: int = 64, partition: Optional[StorePartition] = None,
                 device_shards: Optional[int] = None, device="cuda"):
        self.device = torch.device(device)
        self._entity_indexes = dict(entity_indexes or {})
        self._partition = partition
        self._device_shards = int(device_shards) if device_shards else None
        self._groups: Dict[str, _ReGroup] = {}
        self._proj_groups: Dict[str, _ProjGroup] = {}
        self._re_subs: Dict[str, RandomEffectModel] = {}
        self.counts: "collections.Counter" = collections.Counter()
        self.upload_rows = 0
        self.upload_bytes = 0
        self.upload_s = 0.0
        base: Dict[str, object] = {}
        by_type: Dict[str, List] = {}
        proj_by_type: Dict[str, List] = {}
        for cid, sub in model.models.items():
            if isinstance(sub, RandomEffectModel):
                by_type.setdefault(sub.re_type, []).append((cid, sub))
            elif isinstance(sub, ProjectedRandomEffectModel):
                proj_by_type.setdefault(sub.re_type, []).append((cid, sub))
            else:
                base[cid] = self._fixed_on_device(sub)
        # One budget across dense and projected types, split in proportion
        # to each type's full table size.
        budget_total = sum(
            sum(4 * s.coefficients.shape[1] for _, s in subs) * max(subs[0][1].coefficients.shape[0], 1)
            for subs in by_type.values()
        ) + sum(sum(self._proj_full_bytes(s) for _, s in subs) for subs in proj_by_type.values())
        reg = registry()
        for re_type, subs in by_type.items():
            group = self._groups[re_type] = self._build_group(re_type, subs, hot_bytes, budget_total, min_hot_rows)
            for cid, s in subs:
                self._re_subs[cid] = s
            reg.gauge("serve_store_hot_rows", re_type=re_type).set(group.capacity)
            reg.gauge("serve_store_hot_bytes", re_type=re_type).set(group.capacity * group.row_bytes)
            reg.gauge("serve_store_pinned", re_type=re_type).set(int(group.pinned))
        for re_type, subs in proj_by_type.items():
            group = self._build_proj_group(re_type, subs, hot_bytes, budget_total, min_hot_rows)
            # Projected types shard by predicate only (foreign -> -1); their
            # host masters stay whole.
            if partition is not None and partition.applies_to(re_type) and not group.pinned:
                group.owned = _owned_mask(partition, self._entity_indexes.get(re_type), group.num_entities)
            self._proj_groups[re_type] = group
            reg.gauge("serve_store_hot_rows", re_type=re_type).set(sum(sum(c.capacities) for c in group.coords))
            reg.gauge("serve_store_hot_bytes", re_type=re_type).set(sum(c.hot_bytes for c in group.coords))
            reg.gauge("serve_store_pinned", re_type=re_type).set(int(group.pinned))
        self._base = base
        self._order = list(model.models)  # the scores' sum runs in the model's coordinate order

    def _fixed_on_device(self, sub: FixedEffectModel) -> FixedEffectModel:
        c = sub.model.coefficients
        to = lambda t: None if t is None else torch.as_tensor(_np(t), device=self.device)  # noqa: E731
        return FixedEffectModel(GeneralizedLinearModel(Coefficients(to(c.means), to(c.variances)), sub.model.task),
                                sub.feature_shard)

    def _build_group(self, re_type, subs, hot_bytes, budget_total, min_hot_rows) -> _ReGroup:
        host = {cid: np.ascontiguousarray(_np(s.coefficients), dtype=np.float32) for cid, s in subs}
        E = {c.shape[0] for c in host.values()}
        if len(E) != 1:
            raise ValueError(f"RE type {re_type!r}: coordinates disagree on entity count {sorted(E)}")
        E = E.pop()
        row_bytes = sum(4 * c.shape[1] for c in host.values())
        share = int(hot_bytes * row_bytes * max(E, 1) / budget_total) if budget_total else hot_bytes
        cap = max(int(min_hot_rows), share // max(row_bytes, 1))
        pinned = cap >= E
        cap = min(cap, E) if pinned else cap
        owned = compact_of = None
        # A partition applies to budget-managed types only: a pinned table
        # is resident everywhere anyway.
        if self._partition is not None and self._partition.applies_to(re_type) and not pinned:
            owned = _owned_mask(self._partition, self._entity_indexes.get(re_type), E)
            owned_count = int(owned.sum())
            cap = max(int(min_hot_rows), min(cap, max(owned_count, 1)))
            if self._partition.compact_host:
                sel = np.flatnonzero(owned)
                compact_of = np.full(E, -1, np.int32)
                compact_of[sel] = np.arange(sel.size, dtype=np.int32)
                host = {cid: np.ascontiguousarray(host[cid][sel]) for cid in host}
            self.counts["owned_entities", re_type] = owned_count
            registry().gauge("serve_store_owned_entities", re_type=re_type).set(owned_count)
        shard_plan = shard_cap = perm = shard_lrus = None
        if self._device_shards:
            from photon_tpu_torch.parallel.entity_shard import build_shard_plan

            shard_plan = build_shard_plan(E, self._device_shards, entity_index=self._entity_indexes.get(re_type))
            S = shard_plan.n_shards
            if pinned:
                # Segment s holds shard s's entities at their local rows,
                # padded to the largest shard.
                shard_cap = max(int(shard_plan.counts.max()), 1)
                cap = S * shard_cap
                perm = (shard_plan.shard_of.astype(np.int64) * shard_cap + shard_plan.local_of).astype(np.int32)
            else:
                # A segment holds min_hot_rows at least: one batch's entities
                # may all hash to one shard.
                shard_cap = max(int(min_hot_rows), cap // S)
                cap = S * shard_cap
                shard_lrus = [SlotLru(shard_cap, on_demote=self._demote_counter(re_type), base=s * shard_cap)
                              for s in range(S)]
        group = _ReGroup(re_type=re_type, coord_ids=[cid for cid, _ in subs], host_coefs=host, num_entities=E,
                         capacity=max(cap, 1), pinned=pinned, owned=owned, compact_of=compact_of,
                         shard_plan=shard_plan, shard_cap=shard_cap, perm=perm, shard_lrus=shard_lrus)
        for cid in group.coord_ids:
            if pinned and perm is None:
                group.tables[cid] = torch.as_tensor(host[cid]).to(self.device)
            else:
                t = np.zeros((group.capacity, host[cid].shape[1]), np.float32)
                if pinned:
                    t[perm] = host[cid]
                group.tables[cid] = torch.as_tensor(t).to(self.device)
        if not pinned and shard_lrus is None:
            group.lru = SlotLru(group.capacity, on_demote=self._demote_counter(re_type))
        return group

    @staticmethod
    def _proj_full_bytes(sub: ProjectedRandomEffectModel) -> int:
        return sum(4 * int(b.shape[0]) * int(b.shape[1]) for b in sub.block_coefs)

    def _demote_counter(self, re_type: str):
        def on_demote(_victim, _slot):
            _bump(self.counts, "demotions", re_type)

        return on_demote

    def _build_proj_group(self, re_type, subs, hot_bytes, budget_total, min_hot_rows) -> _ProjGroup:
        """Per-block hot/cold state of projected coordinates: a coordinate's
        share splits across its blocks in proportion to their size, floored
        at ``min_hot_rows`` rows a block (one batch's entities may all land
        in one block)."""
        coords: List[_ProjCoord] = []
        num_entities = 0
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        for cid, sub in subs:
            host_blocks = [np.ascontiguousarray(_np(b), dtype=np.float32) for b in sub.block_coefs]
            entity_block = _np(sub.entity_block).astype(np.int32)
            entity_row = _np(sub.entity_row).astype(np.int32)
            E = int(entity_block.shape[0])
            num_entities = max(num_entities, E)
            full_bytes = sum(4 * b.shape[0] * b.shape[1] for b in host_blocks)
            share = int(hot_bytes * full_bytes / budget_total) if budget_total else hot_bytes
            capacities: List[int] = []
            for b in host_blocks:
                b_share = int(share * 4 * b.shape[0] * max(b.shape[1], 1) / full_bytes) if full_bytes else share
                cap = max(int(min_hot_rows), b_share // max(4 * b.shape[1], 1))
                capacities.append(max(min(cap, b.shape[0]), 1))
            pinned = all(c >= b.shape[0] for c, b in zip(capacities, host_blocks))
            demoted: List[int] = []
            if pinned:
                capacities = [b.shape[0] for b in host_blocks]
                tables = [dev(b) for b in host_blocks]
                lrus: List[Optional[SlotLru]] = [None] * len(host_blocks)
                dev_block, dev_row = dev(entity_block), dev(entity_row)
            else:
                tables = [dev(np.zeros((c, b.shape[1]), np.float32)) for c, b in zip(capacities, host_blocks)]
                demote = self._proj_demoter(re_type, demoted)
                lrus = [SlotLru(c, on_demote=demote) for c in capacities]
                # Everything starts cold: map entries are -1 until promoted.
                dev_block, dev_row = dev(np.full((E,), -1, np.int32)), dev(np.zeros((E,), np.int32))
            coords.append(_ProjCoord(cid=cid, sub=sub, host_blocks=host_blocks, entity_block=entity_block,
                                     entity_row=entity_row, capacities=capacities, lrus=lrus, tables=tables,
                                     dev_entity_block=dev_block, dev_entity_row=dev_row,
                                     col_maps=[dev(_np(c)) for c in sub.col_maps],
                                     inv_maps=[dev(_np(i)) for i in sub.inv_maps], demoted=demoted))
        return _ProjGroup(re_type=re_type, num_entities=num_entities, coords=coords,
                          pinned=all(self._coord_pinned(c) for c in coords))

    def _proj_demoter(self, re_type: str, demoted: List[int]):
        counter = self._demote_counter(re_type)

        def on_demote(victim, slot):
            demoted.append(int(victim))
            counter(victim, slot)

        return on_demote

    @staticmethod
    def _coord_pinned(coord: _ProjCoord) -> bool:
        return all(lru is None for lru in coord.lrus)

    # -- residency ---------------------------------------------------------

    @property
    def device_shards(self) -> Optional[int]:
        """Hot-table shard count (None: one table a coordinate)."""
        return self._device_shards

    def shard_snapshot(self, re_type: str) -> Optional[dict]:
        """The entity→shard assignment of ``re_type``, comparable with the
        training side's ``EntityShardPlan.snapshot()``."""
        group = self._groups.get(re_type)
        if group is None or group.shard_plan is None:
            return None
        return group.shard_plan.snapshot()

    @property
    def re_types(self) -> List[str]:
        """RE types under hot/cold management."""
        return list(self._groups)

    @property
    def entity_re_types(self) -> List[str]:
        """Every RE type a batch carries entity ids for."""
        return list(self._groups) + [t for t in self._proj_groups if t not in self._groups]

    def group(self, re_type: str) -> Optional[_ReGroup]:
        return self._groups.get(re_type)

    def proj_group(self, re_type: str) -> Optional[_ProjGroup]:
        return self._proj_groups.get(re_type)

    def _intern(self, re_type: str, key, num_entities: int) -> int:
        """Request entity key → dense [0, E) index; -1 when unknown."""
        if isinstance(key, str):
            eidx = self._entity_indexes.get(re_type)
            i = eidx.lookup(key) if eidx is not None else -1
        else:
            i = int(key)
        return i if 0 <= i < num_entities else -1

    def resolve(self, re_type: str, keys: Sequence) -> np.ndarray:
        """Entity keys (interned ints or raw string ids) → hot-table slots
        (dense groups) or entity indices (projected groups), promoting
        misses from the host master; -1 (cold start) scores 0."""
        faults.check("serve.store_resolve", label=re_type)
        group = self._groups.get(re_type)
        if group is None:
            proj = self._proj_groups.get(re_type)
            if proj is None:
                return np.full(len(keys), -1, np.int32)
            ids = np.fromiter((self._intern(re_type, k, proj.num_entities) for k in keys), dtype=np.int32,
                              count=len(keys))
            if proj.owned is not None:
                ids = self._mask_foreign(re_type, proj.owned, None, ids)
            if not proj.pinned:
                self._promote_projected(proj, ids)
            return ids
        ids = np.fromiter((self._intern(re_type, k, group.num_entities) for k in keys), dtype=np.int64,
                          count=len(keys))
        if group.owned is not None or group.compact_of is not None:
            ids = self._mask_foreign(re_type, group.owned, group.compact_of, ids)
        if group.pinned:
            ids = ids.astype(np.int32)
            if group.perm is None:
                return ids
            out = np.full(len(ids), -1, np.int32)
            pos = ids >= 0
            out[pos] = group.perm[ids[pos]]
            return out
        slots = np.empty(len(ids), np.int32)
        in_use = set()
        misses: List[int] = []
        hits = 0
        for j, e in enumerate(ids):
            e = int(e)
            if e < 0:
                slots[j] = -1
                continue
            slot = group.slot_get(e)
            if slot is not None:
                if e not in in_use:
                    hits += 1
            else:
                slot = self._claim_slot(group, e, in_use)
                misses.append(e)
            in_use.add(e)
            slots[j] = slot
        if hits:
            _bump(self.counts, "hits", re_type, hits)
        if misses:
            _bump(self.counts, "misses", re_type, len(misses))
            _oom_contained(re_type, lambda: self._upload(group, misses), self.counts)
        return slots

    def _mask_foreign(self, re_type: str, owned: Optional[np.ndarray], compact_of: Optional[np.ndarray],
                      ids: np.ndarray) -> np.ndarray:
        """Foreign entities (not owned, or owned without a host row after a
        rebalance onto a compacted master) → -1, counted a type."""
        pos = np.flatnonzero(ids >= 0)
        if pos.size == 0:
            return ids
        idx = ids[pos].astype(np.int64)
        servable = owned[idx] if owned is not None else np.ones(idx.size, bool)
        if compact_of is not None:
            servable = servable & (compact_of[idx] >= 0)
        foreign = int(pos.size - servable.sum())
        if foreign:
            _bump(self.counts, "foreign", re_type, foreign)
            ids = ids.copy()
            ids[pos[~servable]] = -1
        return ids

    def set_partition(self, partition: Optional[StorePartition]) -> None:
        """Swap the ownership predicate live; compacted host rows are not
        re-fetched (a newly owned entity absent from the compacted master
        stays fixed-effect only until a reload rebuilds the store)."""
        self._partition = partition
        for re_type, group in self._groups.items():
            if group.pinned:
                continue
            if partition is not None and partition.applies_to(re_type):
                group.owned = _owned_mask(partition, self._entity_indexes.get(re_type), group.num_entities)
            else:
                group.owned = None
        for re_type, proj in self._proj_groups.items():
            if partition is not None and partition.applies_to(re_type) and not proj.pinned:
                proj.owned = _owned_mask(partition, self._entity_indexes.get(re_type), proj.num_entities)
            else:
                proj.owned = None

    def partition_stats(self) -> Optional[dict]:
        """Shard ownership summary for ``/healthz``."""
        part = self._partition
        if part is None:
            return None
        types = {}
        for re_type, group in self._groups.items():
            if group.owned is None and group.compact_of is None:
                continue
            types[re_type] = dict(owned=int(group.owned.sum()) if group.owned is not None else None,
                                  entities=group.num_entities, compacted=group.compact_of is not None,
                                  host_rows=int(next(iter(group.host_coefs.values())).shape[0])
                                  if group.host_coefs else 0)
        for re_type, proj in self._proj_groups.items():
            if proj.owned is not None:
                types[re_type] = dict(owned=int(proj.owned.sum()), entities=proj.num_entities, compacted=False,
                                      projected=True)
        return dict(replica_id=part.replica_id, ring_version=part.ring.version, ring_members=len(part.ring),
                    compact_host=part.compact_host, re_types=types)

    # -- warm shard handoff ------------------------------------------------

    def shard_export(self, target_snapshot: dict, target_member: Optional[str] = None,
                     include_cold: bool = True) -> dict:
        """What a new owner needs before the ring flips: for each sharded
        dense group, the entities served here whose owner changes under
        ``target_snapshot`` (only those moving to ``target_member`` when
        given), their host rows (raw float32, base64: exact) and whether
        each is hot here. ``include_cold=False`` keeps the hot ones only."""
        part = self._partition
        out = dict(fromReplica=part.replica_id if part is not None else None,
                   targetVersion=int(target_snapshot.get("version", 0)), groups=[])
        if part is None:
            return out
        target = HashRing.from_snapshot(target_snapshot)
        for re_type, group in self._groups.items():
            if group.pinned or not part.applies_to(re_type):
                continue
            eidx = self._entity_indexes.get(re_type)
            keys: List[object] = []
            hot: List[bool] = []
            dense: List[int] = []
            for i in range(group.num_entities):
                if group.owned is not None and not group.owned[i]:
                    continue
                if group.compact_of is not None and group.compact_of[i] < 0:
                    continue  # no host row here: nothing to hand off
                key = eidx.entity_id(i) if eidx is not None else i
                new_owner = target.owner(key)
                if new_owner == part.replica_id or (target_member is not None and new_owner != target_member):
                    continue
                is_hot = group.slot_peek(i) is not None
                if not include_cold and not is_hot:
                    continue
                keys.append(key)
                hot.append(bool(is_hot))
                dense.append(i)
            if not keys:
                continue
            idx = np.asarray(dense, np.int64)
            src = group.compact_of[idx].astype(np.int64) if group.compact_of is not None else idx
            coords = {}
            for cid in group.coord_ids:
                rows = np.ascontiguousarray(group.host_coefs[cid][src], dtype=np.float32)
                coords[cid] = dict(dim=int(rows.shape[1]), rows=base64.b64encode(rows.tobytes()).decode("ascii"))
            out["groups"].append(dict(reType=re_type, keys=keys, hot=hot, coords=coords))
        return out

    def shard_import(self, payload: dict, upload_chunk: int = 64) -> dict:
        """Install a peer's :meth:`shard_export` payload: append the host rows
        this (compacted) master lacks and pre-promote the peer's hot set, in
        uploads of at most ``upload_chunk`` rows (the warmed staging
        size)."""
        stats = dict(rowsAdded=0, rowsKnown=0, unknownKeys=0, promoted=0)
        for rec in payload.get("groups") or []:
            re_type = rec.get("reType")
            group = self._groups.get(re_type)
            if group is None or group.pinned:
                continue
            keys = rec.get("keys") or []
            hot_flags = list(rec.get("hot") or [False] * len(keys))
            ids = np.fromiter((self._intern(re_type, k, group.num_entities) for k in keys), dtype=np.int64,
                              count=len(keys))
            known = ids >= 0
            stats["unknownKeys"] += int((~known).sum())
            decoded: Optional[Dict[str, np.ndarray]] = {}
            for cid in group.coord_ids:
                c = (rec.get("coords") or {}).get(cid)
                if c is None:
                    decoded = None
                    break
                arr = np.frombuffer(base64.b64decode(c["rows"]), np.float32).reshape(-1, int(c["dim"]))
                if arr.shape[0] != len(keys):
                    decoded = None
                    break
                decoded[cid] = arr
            if decoded is None:
                continue
            kn = np.flatnonzero(known)
            if group.compact_of is not None and kn.size:
                missing = kn[group.compact_of[ids[kn]] < 0]
                if missing.size:
                    base_rows = int(next(iter(group.host_coefs.values())).shape[0]) if group.host_coefs else 0
                    for cid in group.coord_ids:
                        group.host_coefs[cid] = np.ascontiguousarray(
                            np.vstack([group.host_coefs[cid], decoded[cid][missing]]))
                    group.compact_of[ids[missing]] = base_rows + np.arange(missing.size, dtype=np.int32)
                    stats["rowsAdded"] += int(missing.size)
                    _bump(self.counts, "handoff_rows", re_type, int(missing.size))
                stats["rowsKnown"] += int(kn.size - missing.size)
            else:
                stats["rowsKnown"] += int(kn.size)
            promote = [int(e) for e, h in zip(ids, hot_flags) if h and e >= 0 and group.slot_peek(int(e)) is None]
            if group.compact_of is not None:
                promote = [e for e in promote if group.compact_of[e] >= 0]
            promote = promote[: group.capacity]
            chunk_n = max(1, int(upload_chunk))
            for start in range(0, len(promote), chunk_n):
                chunk = promote[start:start + chunk_n]
                for e in chunk:
                    group.slot_claim(e, ())
                _oom_contained(re_type, lambda c=list(chunk): self._upload(group, c), self.counts)
            if promote:
                stats["promoted"] += len(promote)
                _bump(self.counts, "handoff_promoted", re_type, len(promote))
        return stats

    def _claim_slot(self, group: _ReGroup, entity: int, in_use: set) -> int:
        # Demotes the least recently used entity NOT in the current batch;
        # capacity >= max batch size guarantees a victim.
        try:
            return group.slot_claim(entity, in_use)
        except RuntimeError:
            what = (f"shard segment capacity {group.shard_cap}" if group.shard_lrus is not None
                    else f"capacity {group.capacity}")
            raise RuntimeError(f"hot store for {group.re_type!r} exhausted: batch has more unique entities than "
                               f"{what}") from None

    def _staging_for(self, stagings: dict, key, rows: int, dim: int) -> _Staging:
        st = stagings.get(key)
        if st is None or st.host.shape[0] < rows:
            st = stagings[key] = _Staging(rows, dim, torch.float32, self.device)
        return st

    def _upload(self, group: _ReGroup, entities: List[int]) -> None:
        """One ``index_copy_`` a coordinate of the missed rows."""
        faults.check("serve.store_upload", label=group.re_type)
        t0 = time.perf_counter()
        idx = np.asarray([group.slot_peek(e) for e in entities], np.int64)
        ent = np.asarray(entities, np.int64)
        if group.compact_of is not None:
            ent = group.compact_of[ent].astype(np.int64)  # only servable entities get here
        for cid in group.coord_ids:
            host = group.host_coefs[cid]
            st = self._staging_for(group.staging, cid, len(entities), host.shape[1])
            st.upload(group.tables[cid], idx, host[ent])
            self.upload_bytes += len(entities) * host.shape[1] * 4
        self.upload_rows += len(entities)
        self.upload_s += time.perf_counter() - t0

    def _promote_projected(self, proj: _ProjGroup, ids: np.ndarray) -> None:
        """Promote this batch's entities into each projected coordinate's
        block tables and rewrite the device maps (demotion victims to -1) in
        the same pass, before the scorer runs."""
        batch_ids = [int(e) for e in ids if e >= 0]
        for coord in proj.coords:
            if self._coord_pinned(coord):
                continue
            # Injected ``oom`` rules take the contained path a real one would.
            _oom_contained(proj.re_type, lambda: faults.check("serve.store_upload", label=proj.re_type),
                           self.counts)
            in_use_by_block: Dict[int, set] = {}
            for e in batch_ids:
                b = int(coord.entity_block[e])
                if b >= 0:
                    in_use_by_block.setdefault(b, set()).add(e)
            misses: List[int] = []
            rows_of: Dict[int, int] = {}
            hits = 0
            seen = set()
            for e in batch_ids:
                if e in seen:
                    continue
                seen.add(e)
                b = int(coord.entity_block[e])
                if b < 0:
                    continue  # no model in this coordinate
                if coord.lrus[b].get(e) is not None:
                    hits += 1
                    continue
                rows_of[e] = self._claim_proj_slot(proj, coord, b, e, in_use_by_block[b])
                misses.append(e)
            if hits:
                _bump(self.counts, "hits", proj.re_type, hits)
            if not misses and not coord.demoted:
                continue
            if misses:
                _bump(self.counts, "misses", proj.re_type, len(misses))
                _oom_contained(proj.re_type, lambda: self._upload_projected_rows(coord, misses, rows_of),
                               self.counts)
            _oom_contained(proj.re_type, lambda: self._rewrite_proj_maps(coord, misses, rows_of), self.counts)

    def _claim_proj_slot(self, proj: _ProjGroup, coord: _ProjCoord, block: int, entity: int, in_use: set) -> int:
        try:
            return coord.lrus[block].claim(entity, in_use)
        except RuntimeError:
            raise RuntimeError(f"hot store for {proj.re_type!r} exhausted: batch has more unique entities in block "
                               f"{block} than capacity {coord.capacities[block]}") from None

    def _upload_projected_rows(self, coord: _ProjCoord, misses: List[int], rows_of: Dict[int, int]) -> None:
        by_block: Dict[int, List[int]] = {}
        for e in misses:
            by_block.setdefault(int(coord.entity_block[e]), []).append(e)
        for b, ents in by_block.items():
            host = coord.host_blocks[b]
            st = coord.staging[b] if b < len(coord.staging) and coord.staging[b].host.shape[0] >= len(ents) \
                else _Staging(len(ents), host.shape[1], torch.float32, self.device)
            st.upload(coord.tables[b], np.asarray([rows_of[e] for e in ents], np.int64),
                      host[coord.entity_row[np.asarray(ents, np.int64)]])
            self.upload_rows += len(ents)
            self.upload_bytes += len(ents) * host.shape[1] * 4

    def _rewrite_proj_maps(self, coord: _ProjCoord, misses: List[int], rows_of: Dict[int, int]) -> None:
        """Promoted entities point at their hot rows, demotion victims go
        cold (-1). The victims list is drained in place (the LRU's demote
        callback holds it), after the maps are written."""
        victims = list(coord.demoted)
        idx = np.asarray(victims + misses, np.int64)
        if idx.size:
            blocks = np.asarray([-1] * len(victims) + [int(coord.entity_block[e]) for e in misses], np.int32)
            rows = np.asarray([0] * len(victims) + [rows_of[e] for e in misses], np.int32)
            if coord.map_staging is None or coord.map_staging[0].host.shape[0] < idx.size:
                coord.map_staging = [_Staging(idx.size, 1, torch.int32, self.device) for _ in range(2)]
            coord.map_staging[0].upload(coord.dev_entity_block, idx, blocks)
            coord.map_staging[1].upload(coord.dev_entity_row, idx, rows)
        coord.demoted.clear()

    def warm_uploads(self, max_batch: int) -> None:
        """Allocate every staging buffer a resolve of up to ``max_batch``
        entities can use, so the miss path allocates nothing under a
        request (a projected map rewrite moves a miss and a victim entry per
        promoted entity: 2 × max_batch)."""
        for group in self._groups.values():
            if group.pinned:
                continue
            rows = min(int(max_batch), group.capacity)
            for cid in group.coord_ids:
                self._staging_for(group.staging, cid, rows, group.host_coefs[cid].shape[1])
        for proj in self._proj_groups.values():
            for coord in proj.coords:
                if self._coord_pinned(coord):
                    continue
                coord.staging = [_Staging(min(int(max_batch), c), b.shape[1], torch.float32, self.device)
                                 for c, b in zip(coord.capacities, coord.host_blocks)]
                coord.map_staging = [_Staging(2 * int(max_batch), 1, torch.int32, self.device) for _ in range(2)]

    # -- delta overlay -----------------------------------------------------

    def clone_with_delta(self, re_rows: Dict[str, tuple], fixed: Optional[Dict[str, np.ndarray]] = None
                         ) -> "HotColdEntityStore":
        """A NEW store serving base ⊕ delta: per-entity rows (``re_rows``:
        cid → (idx, rows), the shape ``io/model_io.py::read_delta_rows``
        gives) overlay copies of the touched host masters, fixed-effect
        means (``fixed``) replace the base's. Untouched groups, the entity
        indexes and projected groups are shared with the base store (the
        engine serializes every resolve under one lock). A touched pinned
        table is copied and its rows written (the base's tables are never
        written); a touched unpinned group starts cold on new tables.

        Raises ValueError when the delta cannot apply in place (unknown or
        projected coordinate, width mismatch, an entity outside the base's
        entity space); the caller then loads the resolved model whole."""
        re_rows = re_rows or {}
        fixed = fixed or {}
        proj_cids = {c.cid for proj in self._proj_groups.values() for c in proj.coords}
        group_of = {cid: g for g in self._groups.values() for cid in g.coord_ids}
        for cid, (idx, rows) in re_rows.items():
            if cid in proj_cids:
                raise ValueError(f"delta touches projected coordinate {cid!r}; in-place apply supports dense random "
                                 "effects only")
            group = group_of.get(cid)
            if group is None:
                raise ValueError(f"delta coordinate {cid!r} is not a random-effect coordinate of the base model")
            idx, rows = np.asarray(idx), np.asarray(rows, np.float32)
            host = group.host_coefs[cid]
            if rows.ndim != 2 or rows.shape[1] != host.shape[1]:
                raise ValueError(f"delta rows for {cid!r} have width {rows.shape[1] if rows.ndim == 2 else rows.shape}"
                                 f", base table has {host.shape[1]}")
            if int(idx.shape[0]) != int(rows.shape[0]):
                raise ValueError(f"delta for {cid!r}: {idx.shape[0]} indices vs {rows.shape[0]} rows")
            if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= group.num_entities):
                raise ValueError(f"delta for {cid!r} addresses entities outside the base entity space "
                                 f"[0, {group.num_entities}) — the delta grew the entity set")
        for cid, means in fixed.items():
            sub = self._base.get(cid)
            if not isinstance(sub, FixedEffectModel):
                raise ValueError(f"delta fixed effect {cid!r} is not a fixed-effect coordinate of the base model")
            if np.asarray(means).shape != tuple(sub.model.coefficients.means.shape):
                raise ValueError(f"delta fixed effect {cid!r} has shape {np.asarray(means).shape}, base has "
                                 f"{tuple(sub.model.coefficients.means.shape)}")
        new = object.__new__(HotColdEntityStore)
        new.__dict__.update(self.__dict__)
        new.counts = collections.Counter()
        new.upload_rows = new.upload_bytes = 0
        new.upload_s = 0.0
        base = dict(self._base)
        for cid, means in fixed.items():
            sub = base[cid]
            m = torch.as_tensor(np.asarray(means, np.float32), device=self.device)
            base[cid] = FixedEffectModel(GeneralizedLinearModel(Coefficients(m, sub.model.coefficients.variances),
                                                                sub.model.task), sub.feature_shard)
        new._base = base
        groups: Dict[str, _ReGroup] = {}
        for re_type, group in self._groups.items():
            touched = {cid: re_rows[cid] for cid in group.coord_ids if cid in re_rows}
            if not touched:
                groups[re_type] = group
                continue
            host2: Dict[str, np.ndarray] = {}
            for cid in group.coord_ids:
                host2[cid] = group.host_coefs[cid]
                if cid in touched:
                    idx, rows = np.asarray(touched[cid][0], np.int64), np.asarray(touched[cid][1], np.float32)
                    if group.compact_of is not None:
                        # Rows this replica does not hold are another's.
                        cidx = group.compact_of[idx].astype(np.int64)
                        idx, rows = cidx[cidx >= 0], rows[cidx >= 0]
                    h = group.host_coefs[cid].copy()
                    h[idx] = rows
                    host2[cid] = h
            g2 = dataclasses.replace(group, host_coefs=host2, tables={}, lru=None, shard_lrus=None, staging={})
            if group.pinned:
                for cid in group.coord_ids:
                    if cid not in touched:
                        g2.tables[cid] = group.tables[cid]
                        continue
                    idx, rows = np.asarray(touched[cid][0], np.int64), np.asarray(touched[cid][1], np.float32)
                    t = group.tables[cid].clone()
                    slots = group.perm[idx].astype(np.int64) if group.perm is not None else idx
                    if slots.size:
                        _oom_contained(re_type, lambda t=t, s=slots, r=rows: _Staging(
                            s.size, r.shape[1], torch.float32, self.device).upload(t, s, r), self.counts)
                    g2.tables[cid] = t
            else:
                g2.tables = {cid: torch.zeros_like(group.tables[cid]) for cid in group.coord_ids}
                if group.shard_lrus is not None:
                    g2.shard_lrus = [SlotLru(group.shard_cap, on_demote=new._demote_counter(re_type),
                                             base=s * group.shard_cap) for s in range(group.shard_plan.n_shards)]
                else:
                    g2.lru = SlotLru(g2.capacity, on_demote=new._demote_counter(re_type))
            groups[re_type] = g2
        new._groups = groups
        _bump(self.counts, "delta_clones")
        return new

    # -- scoring model -----------------------------------------------------

    def scoring_model(self) -> GameModel:
        """The model the scorer runs: device submodels with every cached
        random-effect table swapped in (slot-indexed), in the served model's
        coordinate order (the order its scores are summed in, as the batch
        path sums them). Its tensors are the same objects call to call:
        uploads write them in place."""
        models = dict(self._base)
        for group in self._groups.values():
            for cid in group.coord_ids:
                models[cid] = dataclasses.replace(self._re_subs[cid], coefficients=group.tables[cid], variances=None,
                                                  present_entities=None)
        for proj in self._proj_groups.values():
            for coord in proj.coords:
                sub = coord.sub
                models[coord.cid] = ProjectedRandomEffectModel(
                    block_coefs=list(coord.tables), col_maps=list(coord.col_maps), inv_maps=list(coord.inv_maps),
                    entity_block=coord.dev_entity_block, entity_row=coord.dev_entity_row, d_full=sub.d_full,
                    re_type=sub.re_type, feature_shard=sub.feature_shard, task=sub.task)
        return GameModel({cid: models[cid] for cid in self._order})

    def stats(self) -> Dict[str, dict]:
        out = {}
        per_type = lambda name, rt: int(self.counts.get((name, rt), 0))  # noqa: E731
        for re_type, group in self._groups.items():
            out[re_type] = dict(entities=group.num_entities, hot_capacity=group.capacity,
                                hot_resident=group.resident_count(), pinned=group.pinned,
                                hot_bytes=group.capacity * group.row_bytes)
            if group.owned is not None:
                out[re_type]["owned_entities"] = int(group.owned.sum())
                out[re_type]["compacted_host"] = group.compact_of is not None
            if group.shard_plan is not None:
                out[re_type]["device_shards"] = group.shard_plan.n_shards
                out[re_type]["shard_rows"] = group.shard_cap
        for re_type, proj in self._proj_groups.items():
            out[re_type] = dict(
                entities=proj.num_entities, hot_capacity=sum(sum(c.capacities) for c in proj.coords),
                hot_resident=sum(sum(c.capacities) if self._coord_pinned(c)
                                 else sum(len(lru) for lru in c.lrus if lru is not None) for c in proj.coords),
                pinned=proj.pinned, hot_bytes=sum(c.hot_bytes for c in proj.coords), projected=True)
        for re_type, rec in out.items():
            for name in ("hits", "misses", "demotions", "foreign"):
                rec[name] = per_type(name, re_type)
        return out

    def upload_stats(self) -> Dict[str, float]:
        """Rows and bytes uploaded by the miss path and the seconds it took
        (host gather, pinned copy and the device copies, synchronized)."""
        return dict(rows=self.upload_rows, bytes=self.upload_bytes, seconds=self.upload_s)
