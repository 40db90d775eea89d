"""GAME data container (port of photon_tpu/data/game_data.py::GameBatch).

One struct of tensors for all samples: label, offset, weight, a feature
matrix per feature shard and a dense int32 entity index per random-effect
type (-1 for an entity unseen at training time). Only the projection to a
single-shard ``LabeledBatch`` is used by this slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from photon_tpu_torch.data.batch import Features, LabeledBatch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GameBatch:
    label: Tensor
    offset: Tensor
    weight: Tensor
    features: Dict[str, Features]  # feature-shard name -> (n, d_shard), dense or sparse
    entity_ids: Dict[str, Tensor]  # RE type name -> (n,) int32
    uid: Optional[Tensor] = None

    @property
    def n(self) -> int:
        return self.label.shape[0]

    def labeled_batch(self, shard: str, extra_offset: Optional[Tensor] = None) -> LabeledBatch:
        """Project to a single-shard LabeledBatch."""
        offset = self.offset if extra_offset is None else self.offset + extra_offset
        return LabeledBatch(self.label, self.features[shard], offset, self.weight)
