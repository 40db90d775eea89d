"""Random-effect dataset: ragged per-entity data → fixed-shape blocks (port
of photon_tpu/data/random_effect.py).

Grouping is host numpy code, run once at ingest; the blocks' tensors are
then placed on ``device``. A block holds features (E, n_max, d),
label/weight (E, n_max) with weight-0 padding samples, sample_index (row in
the flat batch, -1 on padding) and train_mask. Shape-bucket padding rows
carry entity_idx -1 and train_mask False.

Also here: per-block subspace projection of dense input (``col_map``), the
merge of same-geometry blocks, the active-set repack (``pack_into_sizes``,
``compact_entity_blocks``) and the Pearson feature mask. Sparse shard input
is not ported yet. The reference's pad-waste telemetry has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
    features_to_samples_ratio: Optional[float] = None  # Pearson selection cap
    n_buckets: int = 4
    shape_bucketing: bool = True
    # Per-block subspace projection (a block's features are the union of its
    # entities' nonzero columns, ``col_map`` back to the shard). None and
    # False: off (dense input); sparse input is not ported yet.
    subspace_projection: Optional[bool] = None
    merge_same_geometry: bool = False


@dataclasses.dataclass(frozen=True)
class EntityBlock:
    entity_idx: Tensor    # (E,) entity of each row; -1 on padding rows
    features: Tensor      # (E, n_max, d)
    label: Tensor         # (E, n_max)
    weight: Tensor        # (E, n_max), 0 on padding samples
    sample_index: Tensor  # (E, n_max) row in the flat batch, -1 on padding
    train_mask: Tensor    # (E,) bool
    col_map: Optional[Tensor] = None  # (d,) shard column of each block column

    @property
    def num_entities(self) -> int:
        return self.features.shape[0]

    @property
    def n_max(self) -> int:
        return self.features.shape[1]

    @property
    def dim(self) -> int:
        return self.features.shape[2]

    def project_backward(self, w_block: Tensor, d_full: int) -> Tensor:
        """Block-space coefficients (E, dim) → shard space (E, d_full)."""
        if self.col_map is None:
            return w_block
        out = torch.zeros((w_block.shape[0], d_full), dtype=w_block.dtype, device=w_block.device)
        out[:, self.col_map.long()] = w_block
        return out

    def project_forward(self, w_global: Tensor) -> Tensor:
        """Shard-space coefficients (E, d_full) → block space (E, dim)."""
        if self.col_map is None:
            return w_global
        return w_global[:, self.col_map.long()]

    def gather_offsets(self, offsets: Tensor) -> Tensor:
        """(E, n_max) per-sample offsets from the flat (n,) array."""
        safe = torch.clamp(self.sample_index, min=0).long()
        return torch.where(self.sample_index >= 0, offsets[safe], 0.0).to(offsets.dtype)


@dataclasses.dataclass
class RandomEffectDataset:
    config: RandomEffectDataConfig
    blocks: List[EntityBlock]
    num_entities: int
    dim: int  # the shard's width; a projected block's own may be narrower

    @property
    def num_active_samples(self) -> int:
        return int(sum(int(torch.sum(b.weight > 0)) for b in self.blocks))

    @property
    def projected(self) -> bool:
        return any(b.col_map is not None for b in self.blocks)

    def projection_tables(self):
        """(entity_block, entity_row, inv_maps) for ProjectedRandomEffectModel:
        entity e's model is row entity_row[e] of block entity_block[e] (-1: no
        data); inv_maps[b] maps shard columns to block columns (-1: absent)."""
        entity_block = np.full((self.num_entities,), -1, np.int32)
        entity_row = np.zeros((self.num_entities,), np.int32)
        inv_maps = []
        device = self.blocks[0].features.device if self.blocks else "cpu"
        for b, block in enumerate(self.blocks):
            eidx = block.entity_idx.cpu().numpy()
            real = eidx >= 0
            entity_block[eidx[real]] = b
            entity_row[eidx[real]] = np.arange(eidx.size, dtype=np.int32)[real]
            if block.col_map is not None:
                inv = np.full((self.dim,), -1, np.int32)
                inv[block.col_map.cpu().numpy()] = np.arange(block.dim, dtype=np.int32)
            else:
                inv = np.arange(self.dim, dtype=np.int32)
            inv_maps.append(torch.as_tensor(inv, device=device))
        return (torch.as_tensor(entity_block, device=device),
                torch.as_tensor(entity_row, device=device), inv_maps)


def build_random_effect_dataset(
    entity_ids: np.ndarray,
    features,
    label: np.ndarray,
    weight: np.ndarray,
    num_entities: int,
    config: RandomEffectDataConfig,
    uid: Optional[np.ndarray] = None,
    existing_model_mask: Optional[np.ndarray] = None,
    device="cuda",
) -> RandomEffectDataset:
    """Group dense per-sample rows into entity blocks on ``device``.

    Samples of an entity beyond ``active_upper_bound`` are dropped by
    deterministic reservoir sampling on the uid; entities under
    ``active_lower_bound`` samples keep their model (train_mask False) unless
    ``existing_model_mask`` says they have none."""
    if isinstance(features, tuple):
        raise NotImplementedError("sparse random-effect shard input is not ported yet")
    features = np.asarray(features)
    entity_ids = np.asarray(entity_ids)
    label, weight = np.asarray(label), np.asarray(weight)
    n, d = features.shape
    project = bool(config.subspace_projection)
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
        col_map = None
        if project:
            block_rows = np.concatenate([entities[gi][1] for gi in sel])
            col_map = np.flatnonzero(np.any(features[block_rows] != 0, axis=0)).astype(np.int64)
            if col_map.size == 0:
                col_map = np.zeros((1,), np.int64)  # an all-zero block
        d_block = int(col_map.size) if project else d
        if config.shape_bucketing:
            n_max, E_alloc = bucket_dim(n_max), bucket_dim(E)
            if not project:
                d_block = bucket_dim(d_block)

        feat = np.zeros((E_alloc, n_max, d_block), dtype=features.dtype)
        lab = np.zeros((E_alloc, n_max), dtype=label.dtype)
        wt = np.zeros((E_alloc, n_max), dtype=weight.dtype)
        sidx = np.full((E_alloc, n_max), -1, dtype=np.int32)
        eidx = np.full((E_alloc,), -1, dtype=np.int32)
        tmask = np.zeros((E_alloc,), dtype=bool)
        for j, gi in enumerate(sel):
            eid, rows = entities[gi]
            m = len(rows)
            if project:
                feat[j, :m] = features[rows][:, col_map]
            else:
                feat[j, :m, :d] = features[rows]
            lab[j, :m] = label[rows]
            wt[j, :m] = weight[rows]
            sidx[j, :m] = rows
            eidx[j] = eid
            tmask[j] = m >= lb or (
                existing_model_mask is not None and not bool(existing_model_mask[eid])
            )
        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        blocks.append(EntityBlock(as_t(eidx), as_t(feat), as_t(lab), as_t(wt), as_t(sidx), as_t(tmask),
                                  None if col_map is None else as_t(col_map.astype(np.int32))))
    dataset = RandomEffectDataset(config, blocks, num_entities, d)
    if config.merge_same_geometry:
        dataset = merge_same_geometry_blocks(dataset)
    return dataset


def _host(t: Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _pad_rows(field: str, block: EntityBlock, pad: int) -> Tensor:
    """``pad`` inert rows of a block field: zeros, or -1 for the indices."""
    like = getattr(block, field)
    shape = (pad,) + tuple(like.shape[1:])
    fill = -1 if field in ("entity_idx", "sample_index") else 0
    return torch.full(shape, fill, dtype=like.dtype, device=like.device)


_ROW_FIELDS = ("entity_idx", "features", "label", "weight", "sample_index", "train_mask")


def merge_same_geometry_blocks(dataset: RandomEffectDataset) -> RandomEffectDataset:
    """Concatenate the dense blocks of one (n_max, dim) along the entity axis,
    one block per geometry (entity count re-bucketed under shape
    bucketing); projected blocks pass through."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, b in enumerate(dataset.blocks):
        if b.col_map is None:
            groups.setdefault((b.n_max, b.dim), []).append(i)
    merged: List[EntityBlock] = []
    consumed = set()
    for i, b in enumerate(dataset.blocks):
        if i in consumed:
            continue
        idxs = groups.get((b.n_max, b.dim)) if b.col_map is None else None
        if not idxs or len(idxs) == 1:
            merged.append(b)
            continue
        consumed.update(idxs)
        parts = [dataset.blocks[j] for j in idxs]
        E = sum(p.num_entities for p in parts)
        pad = (bucket_dim(E) if dataset.config.shape_bucketing else E) - E
        device = b.features.device
        fields = [
            torch.as_tensor(np.concatenate([_host(getattr(p, f)) for p in parts]
                                           + ([_pad_rows(f, b, pad)] if pad else [])), device=device)
            for f in _ROW_FIELDS
        ]
        merged.append(EntityBlock(*fields))
    return dataclasses.replace(dataset, blocks=merged)


def pack_into_sizes(total: int, allowed_sizes: Sequence[int]) -> List[int]:
    """Block sizes for ``total`` active rows drawn only from ``allowed_sizes``:
    the smallest allowed size that holds the remainder, else the largest,
    repeatedly."""
    sizes = sorted({int(s) for s in allowed_sizes})
    if not sizes:
        raise ValueError("pack_into_sizes needs at least one allowed size")
    plan: List[int] = []
    remaining = int(total)
    while remaining > 0:
        plan.append(next((s for s in sizes if s >= remaining), sizes[-1]))
        remaining -= plan[-1]
    return plan


def compact_entity_blocks(
    blocks: Sequence[EntityBlock],
    keep: Sequence[np.ndarray],
    allowed_sizes: Optional[Sequence[int]] = None,
) -> List[Tuple[EntityBlock, np.ndarray, np.ndarray]]:
    """Repack the kept rows of same-geometry dense blocks into blocks of the
    allowed sizes. Returns ``[(block, src_block, src_row), ...]``: for each
    row of a repacked block the (source block, row) it came from, (-1, -1) on
    its padding rows. The gather runs on the sources' device (nothing is read
    back)."""
    if not blocks:
        return []
    geom = {(b.n_max, b.dim, b.col_map is None) for b in blocks}
    if len(geom) != 1 or not next(iter(geom))[2]:
        raise ValueError(f"compact_entity_blocks needs same-geometry dense blocks, got {geom}")
    src_block = np.concatenate([np.full(int(np.sum(k)), i, np.int32) for i, k in enumerate(keep)])
    src_row = np.concatenate([np.flatnonzero(np.asarray(k)).astype(np.int32) for k in keep])
    if src_block.size == 0:
        return []
    if allowed_sizes is None:
        allowed_sizes = [b.num_entities for b in blocks]
    device = blocks[0].features.device
    out = []
    start = 0
    for size in pack_into_sizes(src_block.size, allowed_sizes):
        sb, sr = src_block[start:start + size], src_row[start:start + size]
        start += sb.size
        pad = size - sb.size
        rows = {b: torch.as_tensor(sr[sb == b], device=device).long() for b in np.unique(sb)}
        fields = []
        for f in _ROW_FIELDS:
            # Sources are in (block, row) order, so per-block gathers
            # concatenated in block order keep the row order.
            parts = [getattr(blocks[b], f)[r] for b, r in rows.items()]
            if pad:
                parts.append(_pad_rows(f, blocks[0], pad))
            fields.append(torch.cat(parts))
        fill = np.full((pad,), -1, np.int32)
        out.append((EntityBlock(*fields), np.concatenate([sb, fill]), np.concatenate([sr, fill])))
    return out


def pearson_feature_mask(block: EntityBlock, max_features: Tensor,
                         always_keep: Optional[int] = None) -> Tensor:
    """(E, d) 0/1 mask keeping each entity's ``max_features[e]`` features
    most correlated with its label (weighted Pearson); zero-variance columns
    score 0 and ``always_keep`` (the intercept) is always kept."""
    w = block.weight
    tot = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
    X, y = block.features, block.label
    mx = torch.sum(w[..., None] * X, dim=1) / tot
    my = torch.sum(w * y, dim=1, keepdim=True) / tot
    dx = X - mx[:, None, :]
    dy = (y - my)[..., None]
    cov = torch.sum(w[..., None] * dx * dy, dim=1)
    vx = torch.sum(w[..., None] * dx * dx, dim=1)
    vy = torch.sum(w[..., None] * dy * dy, dim=1)
    corr = torch.abs(cov / torch.sqrt(torch.clamp(vx * vy, min=1e-24)))
    corr = torch.where(vx < 1e-12, 0.0, corr)
    # Rank per entity (0 = most correlated), ties by column as a stable sort.
    order = torch.argsort(-corr, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    k_e = torch.as_tensor(max_features, device=X.device).reshape(-1, 1)
    mask = (ranks < k_e).to(X.dtype)
    if always_keep is not None:
        mask[:, always_keep] = 1.0
    return mask
