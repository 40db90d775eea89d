"""Block coordinate descent over named coordinates, the GAME outer loop
(port of photon_tpu/algorithm/coordinate_descent.py).

Each coordinate trains against the running residual, the sum of the other
coordinates' scores (total − its own), and the total is updated
incrementally; locked coordinates are scored from a pretrained model and
never retrained; with validation data the best model by the primary metric
is kept. The trackers are read back (through ``HOST_READS``) only for the
logged summary. The reference's spans, metrics registry and trace export,
its checkpointing and its event emitter are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from photon_tpu_torch.algorithm.coordinate import Coordinate
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.models.game import GameModel

Tensor = torch.Tensor
logger = logging.getLogger(__name__)


def _sync(t: Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    best_model: GameModel
    best_metric: Optional[float]
    metric_history: List[Dict[str, float]]
    tracker: Dict[str, list]
    # Host wall seconds per (coordinate, CD pass).
    wall_times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        lines: List[str] = []
        for cid, diags in self.tracker.items():
            walls = self.wall_times.get(cid, [])
            for p, diag in enumerate(diags):
                wall = f"{walls[p]:.3f}s" if p < len(walls) else "n/a"
                lines.append(f"-- coordinate {cid!r}, CD pass {p} (wall {wall})")
                body = diag.summary() if hasattr(diag, "summary") else repr(diag)
                lines.extend("   " + ln for ln in body.splitlines())
        return "\n".join(lines)


class CoordinateDescent:
    """Runs the update sequence for ``num_iterations`` passes."""

    def __init__(self, coordinates: Dict[str, Coordinate], update_sequence: Sequence[str],
                 num_iterations: int = 1, locked_coordinates: Sequence[str] = ()):
        missing = [c for c in update_sequence if c not in coordinates]
        if missing:
            raise ValueError(f"update sequence references unknown coordinates: {missing}")
        dup = [c for c in update_sequence if update_sequence.count(c) > 1]
        if dup:
            raise ValueError(f"duplicate coordinates in update sequence: {sorted(set(dup))}")
        if not update_sequence:
            raise ValueError("empty update sequence")
        self.coordinates = coordinates
        self.update_sequence = list(update_sequence)
        self.num_iterations = num_iterations
        self.locked = set(locked_coordinates)

    def run(
        self,
        batch: GameBatch,
        initial_model: Optional[GameModel] = None,
        validation_batch: Optional[GameBatch] = None,
        validation_fn: Optional[Callable[[GameModel, GameBatch], Dict[str, float]]] = None,
        better: Callable[[float, float], bool] = lambda new, old: new < old,
        checkpoint_dir: Optional[str] = None,
        emitter=None,
        on_coordinate: Optional[Callable[[int, str, Coordinate, float], None]] = None,
    ) -> CoordinateDescentResult:
        """Descend; with validation data, keep the best model seen by the
        primary metric (``better(new, old)``). The card is synchronized
        around each coordinate's update, so ``wall_times`` cover its device
        work. ``on_coordinate(pass, id, coordinate, wall_s)`` is called after
        each update."""
        if checkpoint_dir is not None:
            raise NotImplementedError("coordinate-descent checkpointing is not ported yet")
        if emitter is not None:
            raise NotImplementedError("optimization-log events are not ported yet")
        n = batch.n
        dtype, device = batch.offset.dtype, batch.offset.device
        models: Dict[str, object] = {}
        scores: Dict[str, Tensor] = {}
        for cid in self.update_sequence:
            coord = self.coordinates[cid]
            if initial_model is not None and initial_model.get(cid) is not None:
                models[cid] = initial_model.get(cid)
            else:
                if cid in self.locked:
                    raise ValueError(f"locked coordinate {cid} needs a pretrained model")
                models[cid] = None
            scores[cid] = (coord.score(models[cid], batch) if models[cid] is not None
                           else torch.zeros((n,), dtype=dtype, device=device))
        total_scores = torch.zeros((n,), dtype=dtype, device=device)
        for s in scores.values():
            total_scores = total_scores + s

        tracker: Dict[str, list] = {cid: [] for cid in self.update_sequence}
        wall_times: Dict[str, List[float]] = {cid: [] for cid in self.update_sequence}
        metric_history: List[Dict[str, float]] = []
        best_metric: Optional[float] = None
        has_validation = validation_fn is not None and validation_batch is not None
        best_model = GameModel(dict(models)) if (
            has_validation and all(m is not None for m in models.values())) else None
        single = len(self.update_sequence) == 1 and self.num_iterations == 1

        for it in range(self.num_iterations):
            for cid in self.update_sequence:
                if cid in self.locked:
                    continue
                coord = self.coordinates[cid]
                begin_pass = getattr(coord, "begin_cd_pass", None)
                if begin_pass is not None:
                    begin_pass(it)
                _sync(total_scores)
                t0 = time.perf_counter()
                residual = None if single else total_scores - scores[cid]
                model, diag = coord.train(batch, residual, models[cid])
                new_scores = coord.score(model, batch)
                _sync(new_scores)
                wall = time.perf_counter() - t0
                total_scores = total_scores - scores[cid] + new_scores
                scores[cid] = new_scores
                models[cid] = model
                tracker[cid].append(diag)
                wall_times[cid].append(wall)
                logger.info("CD iter %d coordinate %s trained in %.2fs", it, cid, wall)
                if on_coordinate is not None:
                    on_coordinate(it, cid, coord, wall)

            if has_validation:
                game_model = GameModel(dict(models))
                metrics = validation_fn(game_model, validation_batch)
                metric_history.append(metrics)
                primary = next(iter(metrics.values()))
                if best_metric is None or better(primary, best_metric):
                    best_metric = primary
                    best_model = game_model
                logger.info("CD iter %d validation: %s", it, metrics)

        final = GameModel(dict(models))
        result = CoordinateDescentResult(
            model=final, best_model=final if best_model is None else best_model, best_metric=best_metric,
            metric_history=metric_history, tracker=tracker, wall_times=wall_times)
        if logger.isEnabledFor(logging.INFO):  # the summary reads the trackers back
            summary = result.summary()
            if summary:
                logger.info("optimization summary:\n%s", summary)
        return result
