"""Random-effect dataset: ragged per-entity data → fixed-shape blocks (port
of the dense path of photon_tpu/data/random_effect.py).

Grouping is host numpy code, run once at ingest; the blocks' tensors are
then placed on ``device``. A block holds features (E, n_max, d),
label/weight (E, n_max) with weight-0 padding samples, sample_index (row in
the flat batch, -1 on padding) and train_mask. Shape-bucket padding rows
carry entity_idx -1 and train_mask False. Subspace projection, sparse
input, block merging, compaction and Pearson selection are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def bucket_dim(x: int) -> int:
    """Round a block dimension up to the grid {1, 2, 3, 4, 6, 8, 12, 16, ...}
    (powers of two and 1.5×)."""
    x = int(x)
    if x <= 2:
        return max(x, 1)
    p = 1 << (x - 1).bit_length()
    if 3 * (p // 4) >= x:
        return 3 * (p // 4)
    return p


def _byteswap64(x: np.ndarray) -> np.ndarray:
    """Deterministic reservoir-sampling key on the sample uid."""
    x = x.astype(np.uint64)
    x = ((x & np.uint64(0x00000000FFFFFFFF)) << np.uint64(32)) | (x >> np.uint64(32))
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | (
        (x >> np.uint64(16)) & np.uint64(0x0000FFFF0000FFFF)
    )
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | (
        (x >> np.uint64(8)) & np.uint64(0x00FF00FF00FF00FF)
    )
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class RandomEffectDataConfig:
    re_type: str
    feature_shard: str
    active_upper_bound: Optional[int] = None
    active_lower_bound: Optional[int] = None
    n_buckets: int = 4
    shape_bucketing: bool = True


@dataclasses.dataclass(frozen=True)
class EntityBlock:
    entity_idx: Tensor    # (E,) entity of each row; -1 on padding rows
    features: Tensor      # (E, n_max, d)
    label: Tensor         # (E, n_max)
    weight: Tensor        # (E, n_max), 0 on padding samples
    sample_index: Tensor  # (E, n_max) row in the flat batch, -1 on padding
    train_mask: Tensor    # (E,) bool

    def gather_offsets(self, offsets: Tensor) -> Tensor:
        """(E, n_max) per-sample offsets from the flat (n,) array."""
        safe = torch.clamp(self.sample_index, min=0).long()
        return torch.where(self.sample_index >= 0, offsets[safe], 0.0).to(offsets.dtype)


@dataclasses.dataclass
class RandomEffectDataset:
    config: RandomEffectDataConfig
    blocks: List[EntityBlock]
    num_entities: int
    dim: int


def build_random_effect_dataset(
    entity_ids: np.ndarray,
    features: np.ndarray,
    label: np.ndarray,
    weight: np.ndarray,
    num_entities: int,
    config: RandomEffectDataConfig,
    uid: Optional[np.ndarray] = None,
    existing_model_mask: Optional[np.ndarray] = None,
    device="cuda",
) -> RandomEffectDataset:
    """Group dense per-sample rows into entity blocks on ``device``."""
    features = np.asarray(features)
    entity_ids = np.asarray(entity_ids)
    label, weight = np.asarray(label), np.asarray(weight)
    n, d = features.shape
    uid = np.arange(n, dtype=np.int64) if uid is None else np.asarray(uid).astype(np.int64)

    order = np.argsort(entity_ids, kind="stable")
    uniq, starts = np.unique(entity_ids[order], return_index=True)
    groups = np.split(order, starts[1:])
    entities = [(int(e), rows) for e, rows in zip(uniq, groups) if e >= 0]
    if not entities:
        return RandomEffectDataset(config, [], num_entities, d)

    ub = config.active_upper_bound
    if ub is not None:
        entities = [
            (e, rows[np.argsort(_byteswap64(uid[rows]), kind="stable")[:ub]] if len(rows) > ub else rows)
            for e, rows in entities
        ]
    lb = config.active_lower_bound or 0

    counts = np.array([len(rows) for _, rows in entities])
    n_buckets = max(1, min(config.n_buckets, len(np.unique(counts))))
    qs = np.quantile(counts, np.linspace(0, 1, n_buckets + 1)[1:], method="higher")
    qs = np.unique(qs.astype(np.int64))

    blocks: List[EntityBlock] = []
    assigned = np.digitize(counts, qs, right=True)
    for b, n_max in enumerate(qs):
        sel = np.flatnonzero(assigned == b)
        if sel.size == 0:
            continue
        n_max = int(max(n_max, 1))
        E = E_alloc = sel.size
        d_block = d
        if config.shape_bucketing:
            n_max, E_alloc, d_block = bucket_dim(n_max), bucket_dim(E), bucket_dim(d)

        feat = np.zeros((E_alloc, n_max, d_block), dtype=features.dtype)
        lab = np.zeros((E_alloc, n_max), dtype=label.dtype)
        wt = np.zeros((E_alloc, n_max), dtype=weight.dtype)
        sidx = np.full((E_alloc, n_max), -1, dtype=np.int32)
        eidx = np.full((E_alloc,), -1, dtype=np.int32)
        tmask = np.zeros((E_alloc,), dtype=bool)
        for j, gi in enumerate(sel):
            eid, rows = entities[gi]
            m = len(rows)
            feat[j, :m, :d] = features[rows]
            lab[j, :m] = label[rows]
            wt[j, :m] = weight[rows]
            sidx[j, :m] = rows
            eidx[j] = eid
            tmask[j] = m >= lb or (
                existing_model_mask is not None and not bool(existing_model_mask[eid])
            )
        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        blocks.append(EntityBlock(as_t(eidx), as_t(feat), as_t(lab), as_t(wt), as_t(sidx), as_t(tmask)))
    return RandomEffectDataset(config, blocks, num_entities, d)
