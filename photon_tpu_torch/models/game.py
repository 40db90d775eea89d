"""GAME model: fixed-effect and random-effect submodels (port of
photon_tpu/models/game.py).

A GameModel maps coordinate ids to submodels and scores a GameBatch as the
sum of their scores. A RandomEffectModel is one dense (E, d) coefficient
matrix; a sample scores the row of its entity (0 for entity -1). Where the
matrix is a host master (the out-of-core path's model) and the batch lies on
the card, scoring copies the whole matrix to the batch's device, once a call
(``TABLE_COPIES`` counts the copies and their bytes), and scores there. A
ProjectedRandomEffectModel keeps each block's coefficients in the block's
column subspace. Every score is a per-row product and sum, as
``Coefficients.compute_score`` takes it, never a matrix product, so scores
do not depend on the batch size. A sparse shard scores by gathering each
entry's coefficient (through the block's inverse map when projected).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class TableCopies:
    """Copies of a random-effect coefficient table to a batch on another
    device, made by scoring."""

    copies: int = 0
    bytes: int = 0


TABLE_COPIES = TableCopies()


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global GLM over one feature shard."""

    model: GeneralizedLinearModel
    feature_shard: str

    def score(self, batch: GameBatch) -> Tensor:
        """Raw per-sample scores x·w (no offset)."""
        return self.model.compute_score(batch.features[self.feature_shard])


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity GLMs as one (E, d_shard) coefficient matrix."""

    coefficients: Tensor
    re_type: str
    feature_shard: str
    task: TaskType
    variances: Optional[Tensor] = None
    # (E,) bool: entities with a persisted model record (set by a loader).
    present_entities: Optional[Tensor] = None

    @property
    def num_entities(self) -> int:
        return self.coefficients.shape[0]

    def score(self, batch: GameBatch) -> Tensor:
        idx = batch.entity_ids[self.re_type]
        valid = idx >= 0
        table = self.coefficients
        if table.device != idx.device:
            table = table.to(idx.device)
            TABLE_COPIES.copies += 1
            TABLE_COPIES.bytes += table.numel() * table.element_size()
        w = table[torch.clamp(idx, min=0).long()]
        feats = batch.features[self.feature_shard]
        if isinstance(feats, SparseFeatures):
            scores = torch.sum(feats.values * torch.take_along_dim(w, feats.indices.long(), dim=1), dim=-1)
        else:
            scores = torch.sum(feats * w, dim=-1)
        return torch.where(valid, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))


@dataclasses.dataclass(frozen=True)
class ProjectedRandomEffectModel:
    """Per-entity GLMs kept in per-block column subspaces: block b's
    coefficients (E_b, d_b) over shard columns col_maps[b]; entity e's model
    is row entity_row[e] of block entity_block[e] (-1: none, scores 0);
    inv_maps[b] maps shard columns to block columns (-1: absent)."""

    block_coefs: list
    col_maps: list
    inv_maps: list
    entity_block: Tensor
    entity_row: Tensor
    d_full: int
    re_type: str
    feature_shard: str
    task: TaskType
    block_variances: Optional[list] = None

    @property
    def num_entities(self) -> int:
        return self.entity_block.shape[0]

    def score(self, batch: GameBatch) -> Tensor:
        idx = batch.entity_ids[self.re_type]
        valid = idx >= 0
        safe = torch.clamp(idx, min=0).long()
        blk, row = self.entity_block[safe], self.entity_row[safe].long()
        feats = batch.features[self.feature_shard]
        total = torch.zeros(idx.shape[0], dtype=torch.float32, device=idx.device)
        for b, (coefs, inv) in enumerate(zip(self.block_coefs, self.inv_maps)):
            in_b = valid & (blk == b)
            w = coefs[torch.where(in_b, row, 0)]
            if isinstance(feats, SparseFeatures):
                # Each entry's column in the block's subspace; a column the
                # block never saw (-1) has coefficient 0.
                loc = inv[feats.indices.long()].long()
                got = torch.take_along_dim(w, torch.clamp(loc, min=0), dim=1)
                s = torch.sum(torch.where(loc >= 0, feats.values * got, 0.0), dim=-1)
            else:
                s = torch.sum(feats[:, self.col_maps[b].long()].to(w.dtype) * w, dim=-1)
            total = total + torch.where(in_b, s, 0.0)
        return total

    def _scatter(self, parts, fill: float) -> Tensor:
        E = self.num_entities
        dtype = parts[0].dtype if parts else torch.float32
        out = torch.full((E, self.d_full), fill, dtype=dtype, device=self.entity_block.device)
        for b, (wb, cmap) in enumerate(zip(parts, self.col_maps)):
            ents = torch.nonzero(self.entity_block == b)[:, 0]
            out[ents[:, None], cmap.long()[None, :]] = wb[self.entity_row[ents].long()].to(dtype)
        return out

    def to_dense(self) -> RandomEffectModel:
        """The shard-space (E, d_full) model."""
        variances = None if self.block_variances is None else self._scatter(self.block_variances, 1.0)
        return RandomEffectModel(self._scatter(self.block_coefs, 0.0), self.re_type,
                                 self.feature_shard, self.task, variances)


DatumScoringModel = Union[FixedEffectModel, RandomEffectModel, ProjectedRandomEffectModel]


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Coordinate id → submodel; total score = Σ submodel scores."""

    models: Dict[str, DatumScoringModel]

    def score(self, batch: GameBatch) -> Tensor:
        total = torch.zeros((batch.n,), dtype=batch.offset.dtype, device=batch.offset.device)
        for model in self.models.values():
            total = total + model.score(batch)
        return total

    def score_with_offset(self, batch: GameBatch) -> Tensor:
        return self.score(batch) + batch.offset

    def get(self, coordinate_id: str) -> Optional[DatumScoringModel]:
        return self.models.get(coordinate_id)

    def updated(self, coordinate_id: str, model: DatumScoringModel) -> "GameModel":
        return self.updated_many({coordinate_id: model})

    def updated_many(self, replacements: Dict[str, DatumScoringModel]) -> "GameModel":
        new = dict(self.models)
        new.update(replacements)
        return GameModel(new)

    def feature_shard_dims(self) -> Dict[str, int]:
        """Feature width per shard, from the submodels."""
        dims: Dict[str, int] = {}
        for sub in self.models.values():
            if isinstance(sub, FixedEffectModel):
                d = int(sub.model.coefficients.dim)
            elif isinstance(sub, RandomEffectModel):
                d = int(sub.coefficients.shape[1])
            else:
                d = int(sub.d_full)
            prev = dims.setdefault(sub.feature_shard, d)
            if prev != d:
                raise ValueError(f"shard {sub.feature_shard!r} has inconsistent dims {prev} vs {d} "
                                 "across coordinates")
        return dims
