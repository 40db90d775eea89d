"""Block coordinate descent over named coordinates, the GAME outer loop
(port of photon_tpu/algorithm/coordinate_descent.py).

Each coordinate trains against the running residual, the sum of the other
coordinates' scores (total − its own), and the total is updated
incrementally; locked coordinates are scored from a pretrained model and
never retrained; with validation data the best model by the primary metric
is kept. The trackers are read back (through ``HOST_READS``) only for the
logged summary. Checkpoint and resume, optimization-log events, the
cooperative shutdown and the host-memory check at each pass boundary, the
spans (``cd/iter{it}/{cid}`` with ``solve`` and ``score``), the metrics and
the trace export under an installed OTLP exporter are the reference's.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

import torch

from photon_tpu_torch.algorithm.coordinate import Coordinate
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.models.game import GameModel
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.obs.trace import span
from photon_tpu_torch.utils import resources
from photon_tpu_torch.utils.checkpoint import LegacyCheckpointError, load_checkpoint, save_checkpoint
from photon_tpu_torch.utils.events import optimization_log_event
from photon_tpu_torch.utils.shutdown import GracefulShutdown, shutdown_requested

Tensor = torch.Tensor
logger = logging.getLogger(__name__)


def _sync(t: Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextmanager
def _export_trace():
    """With an OTLP exporter installed (``--otlp-endpoint``), run the body
    under a minted trace context, so its spans are traced and reach the
    collector through the tracer's sink; the trace is finished against the
    flight recorder so its open-trace table never holds training passes.
    Without an exporter this is a no-op."""
    from photon_tpu_torch.obs.export import active_exporter

    if active_exporter() is None:
        yield
        return
    from photon_tpu_torch.obs.trace import flight_recorder, mint_context, tracer

    ctx = mint_context()
    t0 = time.monotonic()
    try:
        with tracer().attach_context(ctx):
            yield
    finally:
        flight_recorder().finish(ctx.trace_id, time.monotonic() - t0)


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
        checkpoint_every: int = 1,
        checkpoint_tag: Optional[str] = None,
        checkpoint_keep_last: Optional[int] = None,
        emitter=None,
        profile: bool = True,
        on_coordinate: Optional[Callable[[int, str, Coordinate, float], None]] = None,
    ) -> CoordinateDescentResult:
        """Descend; with validation data, keep the best model seen by the
        primary metric (``better(new, old)``). With ``profile`` the card is
        synchronized around each coordinate's update, so ``wall_times`` cover
        its device work, and the optimization-log events of ``emitter``
        carry each solve's summary (a host read); without it the loop makes
        no host sync of its own. ``on_coordinate(pass, id, coordinate,
        wall_s)`` is called after each update.

        With ``checkpoint_dir`` the whole descent state (models, scores,
        total, metric history, best metric and model, trackers, wall times,
        each coordinate's active-set state) is saved every
        ``checkpoint_every`` passes, under ``checkpoint_tag`` (default: the
        update sequence), and a run resumes from the newest readable step
        there; a legacy checkpoint restarts from pass 0, a checkpoint of
        another tag raises. ``checkpoint_keep_last`` caps the step files
        kept. A save that still fails with ENOSPC after the writer's prune
        and retry is logged and training goes on. At each pass boundary a
        received SIGTERM/SIGINT (``utils/shutdown.py``) saves a final
        checkpoint and raises ``GracefulShutdown``, and hard host memory
        pressure saves one and raises ``HostMemoryPressureError``."""
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

        tag = checkpoint_tag or ",".join(self.update_sequence)
        start_it = 0
        if checkpoint_dir is not None:
            if checkpoint_every < 1:
                raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
            state = step = None
            try:
                # Resume-robust: a torn newest step is skipped and the run
                # resumes one pass earlier.
                state, step = load_checkpoint(checkpoint_dir, device=device)
            except FileNotFoundError:
                pass
            except LegacyCheckpointError as exc:
                logger.warning("ignoring unreadable legacy checkpoint at %s (%s); restarting training from step 0",
                               checkpoint_dir, exc)
            if state is not None:
                if state.get("tag") != tag:
                    raise ValueError(
                        f"checkpoint at {checkpoint_dir} was written for a different configuration (saved tag "
                        f"{state.get('tag')!r} != current {tag!r}); clear the directory or point checkpoint_dir "
                        "elsewhere")
                with span("cd/resume_restore"):
                    models, scores, total_scores = state["models"], state["scores"], state["total_scores"]
                    metric_history, best_metric = state["metric_history"], state["best_metric"]
                    best_model, tracker = state["best_model"], state["tracker"]
                    wall_times = state.get("wall_times", {cid: [] for cid in self.update_sequence})
                    # The active-set gate state, so the first resumed pass is
                    # gated as the uninterrupted run's would be.
                    active_state = state.get("active_state") or {}
                    for cid, coord in self.coordinates.items():
                        restore = getattr(coord, "restore_active_state", None)
                        if restore is not None:
                            restore(active_state.get(cid))
                start_it = step + 1
                registry().counter("cd_resumes_total").inc()
                logger.info("resuming coordinate descent from checkpoint step %d", step)

        def save(it: int) -> None:
            with span("cd/checkpoint_save"):
                active_state = {cid: coord.export_active_state() for cid, coord in self.coordinates.items()
                                if getattr(coord, "export_active_state", None) is not None}
                try:
                    save_checkpoint(checkpoint_dir, dict(
                        models=models, scores=scores, total_scores=total_scores, metric_history=metric_history,
                        best_metric=best_metric, best_model=best_model, tracker=tracker, wall_times=wall_times,
                        active_state=active_state, tag=tag), it, keep_last=checkpoint_keep_last)
                except OSError as exc:
                    # The writer already pruned and retried: a disk that stays
                    # full costs intermediate durability, not the run.
                    if not resources.is_enospc(exc):
                        raise
                    registry().counter("checkpoint_write_failures_total").inc()
                    logger.warning("checkpoint save at pass %d failed even after pruning (disk full under %s); "
                                   "continuing WITHOUT a checkpoint this pass: %s", it, checkpoint_dir, exc)

        single = len(self.update_sequence) == 1 and self.num_iterations == 1
        for it in range(start_it, self.num_iterations):
            for cid in self.update_sequence:
                if cid in self.locked:
                    continue
                coord = self.coordinates[cid]
                begin_pass = getattr(coord, "begin_cd_pass", None)
                if begin_pass is not None:
                    begin_pass(it)
                if profile:
                    _sync(total_scores)
                t0 = time.perf_counter()
                residual = None if single else total_scores - scores[cid]
                with _export_trace(), span(f"cd/iter{it}/{cid}"):
                    with span("solve"):
                        model, diag = coord.train(batch, residual, models[cid])
                    with span("score"):
                        new_scores = coord.score(model, batch)
                        if profile:
                            _sync(new_scores)
                wall = time.perf_counter() - t0
                total_scores = total_scores - scores[cid] + new_scores
                scores[cid] = new_scores
                models[cid] = model
                tracker[cid].append(diag)
                wall_times[cid].append(wall)
                registry().counter("cd_coordinate_updates_total", coordinate=cid).inc()
                logger.info("CD iter %d coordinate %s trained in %.2fs", it, cid, wall)
                if emitter is not None:
                    # The summary reads the solve's history back: only when
                    # profiling. The active-set counts are host ints the
                    # coordinate already holds.
                    emitter.emit(optimization_log_event(
                        coordinate=cid, cd_iteration=it, wall_s=wall,
                        summary=diag.summary() if profile and hasattr(diag, "summary") else None,
                        active_set=getattr(coord, "last_active_set_stats", None),
                        residency=getattr(coord, "last_residency_stats", None)))
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

            registry().counter("cd_iterations_total").inc()
            saved = checkpoint_dir is not None and (it + 1) % checkpoint_every == 0
            if saved:
                save(it)
            # The pass boundary is the safe stop: every coordinate's state is
            # consistent and, with a checkpoint dir, durable.
            signum = shutdown_requested()
            if signum is not None:
                if checkpoint_dir is not None and not saved:
                    save(it)
                logger.warning("coordinate descent stopping after pass %d on signal %d", it, signum)
                raise GracefulShutdown(signum)
            try:
                resources.check_memory(f"coordinate_descent pass {it}")
            except resources.HostMemoryPressureError:
                if checkpoint_dir is not None and not saved:
                    save(it)
                raise

        final = GameModel(dict(models))
        result = CoordinateDescentResult(
            model=final, best_model=final if best_model is None else best_model, best_metric=best_metric,
            metric_history=metric_history, tracker=tracker, wall_times=wall_times)
        if logger.isEnabledFor(logging.INFO):  # the summary reads the trackers back
            summary = result.summary()
            if summary:
                logger.info("optimization summary:\n%s", summary)
        return result
