"""GAME model, fixed-effect part (port of photon_tpu/models/game.py).

A GameModel maps coordinate ids to submodels and scores a GameBatch as the
sum of their scores. Only FixedEffectModel is ported; the random-effect
models come with the GAME slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.models.glm import GeneralizedLinearModel

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global GLM over one feature shard."""

    model: GeneralizedLinearModel
    feature_shard: str

    def score(self, batch: GameBatch) -> Tensor:
        """Raw per-sample scores x·w (no offset)."""
        return self.model.compute_score(batch.features[self.feature_shard])


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Coordinate id → submodel; total score = Σ submodel scores."""

    models: Dict[str, FixedEffectModel]

    def score(self, batch: GameBatch) -> Tensor:
        total = torch.zeros((batch.n,), dtype=batch.offset.dtype, device=batch.offset.device)
        for model in self.models.values():
            total = total + model.score(batch)
        return total
