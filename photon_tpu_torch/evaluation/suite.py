"""EvaluationSuite: evaluators sharing one validation batch (port of
photon_tpu/evaluation/suite.py). Specs are plain metric names or the
grouped ``AUC:idColumn`` / ``PRECISION@k:idColumn``."""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional

import torch

from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.evaluation.evaluators import (
    EvaluatorType,
    evaluate,
    grouped_auc,
    grouped_precision_at_k,
    metric_is_better,
)
from photon_tpu_torch.models.game import GameModel
from photon_tpu_torch.optim.common import HOST_READS

Tensor = torch.Tensor

_MULTI_RE = re.compile(r"^(AUC|PRECISION@(\d+)):(\w+)$")


@dataclasses.dataclass(frozen=True)
class EvaluatorSpec:
    """One evaluator: plain (AUC, RMSE, ...) or grouped (AUC:entityType)."""

    name: str
    etype: EvaluatorType
    group_by: Optional[str] = None
    k: int = 10

    @staticmethod
    def parse(spec: str) -> "EvaluatorSpec":
        m = _MULTI_RE.match(spec.strip())
        if m:
            if m.group(1) == "AUC":
                return EvaluatorSpec(spec, EvaluatorType.AUC, group_by=m.group(3))
            return EvaluatorSpec(spec, EvaluatorType.PRECISION_AT_K, group_by=m.group(3), k=int(m.group(2)))
        name = spec.strip().upper()
        if name.startswith("PRECISION@"):
            return EvaluatorSpec(spec, EvaluatorType.PRECISION_AT_K, k=int(name.split("@")[1]))
        return EvaluatorSpec(spec, EvaluatorType[name])

    def better(self) -> Callable[[float, float], bool]:
        return metric_is_better(self.etype)


class EvaluationSuite:
    """Evaluates a GameModel (or raw scores) on a validation batch."""

    def __init__(self, specs: List[EvaluatorSpec], num_entities: Optional[Dict[str, int]] = None):
        if not specs:
            raise ValueError("EvaluationSuite needs at least one evaluator")
        self.specs = specs
        self.num_entities = num_entities or {}

    @property
    def primary(self) -> EvaluatorSpec:
        return self.specs[0]

    def evaluate_scores(self, scores: Tensor, batch: GameBatch) -> Dict[str, float]:
        """Every metric, read to the host together (``HOST_READS``)."""
        out: Dict[str, object] = {}
        for spec in self.specs:
            if spec.group_by is not None:
                gids = batch.entity_ids[spec.group_by]
                n_groups = self.num_entities.get(spec.group_by)
                if n_groups is None:
                    n_groups = int(HOST_READS.fetch(torch.max(gids))[0]) + 1
                if spec.etype == EvaluatorType.AUC:
                    v = grouped_auc(scores, batch.label, gids, n_groups, batch.weight)
                else:
                    v = grouped_precision_at_k(scores, batch.label, gids, n_groups, spec.k)
            else:
                v = evaluate(spec.etype, scores, batch.label, batch.weight, spec.k)
            out[spec.name] = v
        on_device = [k for k, v in out.items() if isinstance(v, torch.Tensor)]
        for k, v in zip(on_device, HOST_READS.fetch(*(out[k] for k in on_device)) if on_device else []):
            out[k] = v
        return {k: float(v) for k, v in out.items()}

    def evaluate_model(self, model: GameModel, batch: GameBatch) -> Dict[str, float]:
        return self.evaluate_scores(model.score_with_offset(batch), batch)

    def validation_fn(self) -> Callable[[GameModel, GameBatch], Dict[str, float]]:
        return self.evaluate_model
