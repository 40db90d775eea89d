"""GameTransformer: batch scoring with a trained GameModel (port of
photon_tpu/estimators/game_transformer.py). PyTorch runs eagerly, so there
is no compiled scorer: ``warm_up`` scores each row-count bucket once and
counts the buckets it had not scored before, and ``trace_count`` counts the
distinct row counts scored (the reference's traces, one a shape)."""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.padding import pad_game_batch
from photon_tpu_torch.evaluation.suite import EvaluationSuite
from photon_tpu_torch.models.game import GameModel

Tensor = torch.Tensor
logger = logging.getLogger(__name__)


class GameTransformer:
    def __init__(self, model: GameModel, evaluation_suite: Optional[EvaluationSuite] = None):
        self.model = model
        self.evaluation_suite = evaluation_suite
        self.last_metrics: Optional[Dict[str, float]] = None
        self._buckets = set()

    def transform(self, batch: GameBatch, model: Optional[GameModel] = None) -> Tensor:
        """Per-sample total scores (model + offsets); with a suite, also
        evaluates them into ``last_metrics``."""
        scores = (self.model if model is None else model).score_with_offset(batch)
        self._buckets.add(batch.n)
        if self.evaluation_suite is not None:
            self.last_metrics = self.evaluation_suite.evaluate_scores(scores, batch)
            logger.info("scoring evaluation: %s", self.last_metrics)
        return scores

    @property
    def trace_count(self) -> int:
        return len(self._buckets)

    def warm_up(self, template: GameBatch, row_buckets) -> int:
        """Score ``template`` padded to every bucket size (weight-0 rows,
        entity -1); returns how many sizes were new."""
        new = 0
        for n in sorted(set(int(b) for b in row_buckets)):
            self.model.score_with_offset(pad_game_batch(template, n))
            new += n not in self._buckets
            self._buckets.add(n)
        return new
