"""Coordinate protocol: one block of the GAME coordinate-descent problem
(port of photon_tpu/algorithm/coordinate.py). Residuals are a flat (n,)
score tensor aligned with the GameBatch's samples."""

from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

import torch

from photon_tpu_torch.data.game_data import GameBatch

Tensor = torch.Tensor


class Coordinate(abc.ABC):
    """One coordinate: its view of the data and its optimization problem."""

    coordinate_id: str

    @abc.abstractmethod
    def train(self, batch: GameBatch, residual_scores: Optional[Tensor] = None,
              initial_model: Optional[Any] = None) -> Tuple[Any, Any]:
        """Train against the residuals of the other coordinates; returns
        (model, diagnostics)."""

    @abc.abstractmethod
    def score(self, model: Any, batch: GameBatch) -> Tensor:
        """Per-sample raw scores of this coordinate's model (no offsets)."""

    @abc.abstractmethod
    def zero_model(self) -> Any:
        """The all-zeros model."""


class ModelCoordinate(Coordinate):
    """Score-only coordinate for a locked (not retrained) block."""

    def __init__(self, coordinate_id: str, inner: Coordinate, model: Any):
        self.coordinate_id = coordinate_id
        self._inner = inner
        self._model = model

    def train(self, batch, residual_scores=None, initial_model=None):
        return self._model, None

    def score(self, model, batch):
        return self._inner.score(self._model if model is None else model, batch)

    def zero_model(self):
        return self._model
