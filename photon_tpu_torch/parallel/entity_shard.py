"""Copy of photon_tpu/parallel/entity_shard.py (framework-free; the port does not import it).

Entity→device-shard assignment shared by training and serving.

The multi-device GAME program shards the random-effect coefficient store by
ENTITY: each entity's block solves run on exactly one device, and the
serving hot store keeps that entity's rows on the same shard. Both sides
must agree on the assignment or a trained entity would be looked up on the
wrong serving shard — so the assignment is derived from ONE source of
truth: the consistent-hash ring already proven for fleet replica ownership
(serve/routing.py, its disjoint-ownership scheme). Ring members are
the synthetic shard names ``"shard:0" … "shard:S-1"`` and the hashed key is
the SAME string the fleet router and ``serve/store._owned_mask`` hash — the
raw entity id when an EntityIndex exists, else the decimal dense index.

Device-count independence: the plan is built for a FIXED shard count
(default 8, the virtual-mesh width) regardless of how many devices are
present; shard ``s`` then maps onto device ``(s*n_devices)//S``
(contiguous blocks, matching sharded-table row chunking). Every device
count therefore sees the identical per-shard datasets and block geometry —
only placement changes — which is what makes multi-device training
bit-identical to the single-device run (same programs, same reduction
orders, different devices). Scaling the mesh never re-buckets a block.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from photon_tpu_torch.serve.routing import HashRing

DEFAULT_N_SHARDS = 8


def shard_members(n_shards: int) -> Tuple[str, ...]:
    """Canonical ring member names for device shards."""
    return tuple(f"shard:{k}" for k in range(int(n_shards)))


def shard_of_member(member: str) -> int:
    return int(member.split(":", 1)[1])


@dataclasses.dataclass(frozen=True)
class EntityShardPlan:
    """Frozen entity→shard assignment for one RE type.

    shard_of:  (E,) int32 — owning shard of each dense entity index.
    local_of:  (E,) int32 — entity's row in its shard's LOCAL index space
               (entities of a shard are numbered in ascending global order).
    counts:    (S,) int64 — entities per shard.
    """

    n_shards: int
    seed: int
    ring_version: int
    shard_of: np.ndarray
    local_of: np.ndarray
    counts: np.ndarray

    @property
    def num_entities(self) -> int:
        return int(self.shard_of.shape[0])

    def entities_of(self, shard: int) -> np.ndarray:
        """Global entity indices owned by ``shard``, ascending (the local
        index space: position j here is local entity j)."""
        return np.flatnonzero(self.shard_of == shard)

    def device_of(self, shard: int, n_devices: int) -> int:
        """Shard → device under an n-device mesh: contiguous blocks of
        S/n shards per device. Matches how a shard-grouped hot table
        sharded ``NamedSharding(mesh, P('data'))`` chunks its rows over
        the mesh, so a trained shard and its serving rows land on the
        SAME device. Every device count reuses the same fixed-S plan —
        only this mapping changes."""
        return (int(shard) * int(n_devices)) // self.n_shards

    def shard_sample_entities(self, entity_ids: np.ndarray) -> List[np.ndarray]:
        """Per-shard localized sample entity ids: for shard s, a (n,) int32
        array holding each sample's LOCAL entity index when the sample's
        entity belongs to s, else -1 (the dataset builder drops negative
        ids, so building per-shard datasets from these is a pure filter —
        sample_index keeps pointing at the GLOBAL flat batch rows)."""
        entity_ids = np.asarray(entity_ids)
        valid = entity_ids >= 0
        safe = np.where(valid, entity_ids, 0)
        owner = self.shard_of[safe]
        local = self.local_of[safe]
        return [
            np.where(valid & (owner == s), local, -1).astype(np.int32)
            for s in range(self.n_shards)
        ]

    def snapshot(self) -> dict:
        """Comparable identity of the assignment (tests assert the serving
        store derives the same one)."""
        return dict(
            n_shards=self.n_shards,
            seed=self.seed,
            ring_version=self.ring_version,
            shard_of=self.shard_of.tolist(),
        )


def build_shard_plan(
    num_entities: int,
    n_shards: int = DEFAULT_N_SHARDS,
    seed: int = 0,
    entity_index=None,
    vnodes: int = 64,
    ring: Optional[HashRing] = None,
) -> EntityShardPlan:
    """Assign dense entity indices to device shards via the consistent-hash
    ring. Hashes the SAME per-entity string ``serve/store._owned_mask``
    hashes (raw entity id through ``entity_index`` when present, else the
    decimal index), so training and serving agree by construction."""
    if ring is None:
        ring = HashRing(shard_members(n_shards), vnodes=vnodes, seed=seed)
    shard_of = np.empty((num_entities,), np.int32)
    for i in range(num_entities):
        key = entity_index.entity_id(i) if entity_index is not None else i
        shard_of[i] = shard_of_member(ring.owner(str(key)))
    local_of = np.full((num_entities,), -1, np.int32)
    counts = np.zeros((n_shards,), np.int64)
    for s in range(n_shards):
        ents = np.flatnonzero(shard_of == s)
        local_of[ents] = np.arange(ents.size, dtype=np.int32)
        counts[s] = ents.size
    return EntityShardPlan(
        n_shards=int(n_shards),
        seed=int(seed),
        ring_version=int(ring.version),
        shard_of=shard_of,
        local_of=local_of,
        counts=counts,
    )


def merge_shard_coefficients(
    plan: EntityShardPlan,
    shard_coefs: Sequence[np.ndarray],
    dim: int,
    dtype=np.float32,
) -> np.ndarray:
    """Scatter per-shard (E_s, d) coefficient tables into one global (E, d)
    host table — the coordinate path's score/residual merge. Shards own
    DISJOINT entity sets, so the merge is exact (no summation, no order
    dependence)."""
    out = np.zeros((plan.num_entities, dim), dtype)
    for s, w in enumerate(shard_coefs):
        ents = plan.entities_of(s)
        if ents.size:
            out[ents] = np.asarray(w)[: ents.size, :dim]
    return out
