"""Copy of photon_tpu/utils/timed.py (framework-free; the port does not import it).

Phase timing + ingest-pipeline stage telemetry.

Parity target: reference ``Timed`` block timer (photon-lib util/Timed.scala,
used around every driver phase, e.g. estimators/GameEstimator.scala:341-364).

``StageStats``/``PipelineStats`` extend the same idea to the staged ingest
pipeline (io/pipeline.py): each host stage (decode / assemble / h2d) records
busy wall, time blocked on its input queue, time blocked on backpressure,
items and bytes through, and queue-depth samples — the numbers
``bench.py --pipeline-ab`` turns into per-stage occupancy columns and that
driver summaries surface next to the phase timers.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

logger = logging.getLogger("photon_tpu_torch")


class Timed:
    """Context-manager timer that logs and records wall time per phase.

    ``records`` is process-global (driver summaries read it after the run),
    so it is guarded by a lock (phases can finish on pipeline worker
    threads) and cleared by ``reset()`` at driver entry — without the
    reset, a second driver invocation in the same process reported the
    previous run's stale phases in its summary. Each finished phase also
    lands as a trace span (obs/trace), so the run report sees every
    ``Timed`` block without callers changing anything.
    """

    records: Dict[str, float] = {}
    _records_lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0

    @classmethod
    def records_lock(cls) -> threading.Lock:
        """Lock guarding ``records`` — hold it to snapshot consistently."""
        return cls._records_lock

    @classmethod
    def reset(cls) -> None:
        """New run: drop phase records (and the per-label pipeline
        telemetry that follows the same process-global pattern)."""
        with cls._records_lock:
            cls.records.clear()
        _pipeline_records.clear()

    def __enter__(self) -> "Timed":
        self._span = None
        try:
            from photon_tpu_torch.obs.trace import tracer

            self._span = tracer().span(self.name)
            self._span.__enter__()
        except Exception:  # telemetry must never break the timed body
            self._span = None
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.monotonic() - self._t0
        if self._span is not None:
            self._span.__exit__(None, None, None)
        with Timed._records_lock:
            Timed.records[self.name] = self.elapsed
        logger.info("[timed] %s: %.3fs", self.name, self.elapsed)


@contextmanager
def timed(name: str) -> Iterator[None]:
    with Timed(name):
        yield


@dataclasses.dataclass
class StageStats:
    """Counters for ONE pipeline stage (decode / assemble / h2d / compute).

    busy_s:     wall spent doing the stage's work.
    wait_in_s:  wall blocked on the upstream queue (starved).
    wait_out_s: wall blocked putting downstream (backpressure).
    items/bytes: chunks and host bytes through the stage.
    depth_*:    output-queue depth sampled after each put — the direct
                backpressure observable (avg near the bound = downstream
                is the bottleneck; near 0 = this stage is).
    """

    name: str
    busy_s: float = 0.0
    wait_in_s: float = 0.0
    wait_out_s: float = 0.0
    items: int = 0
    bytes: int = 0
    depth_sum: int = 0
    depth_samples: int = 0
    depth_max: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add_busy(self, dt: float, nbytes: int = 0) -> None:
        with self._lock:
            self.busy_s += dt
            self.items += 1
            self.bytes += nbytes

    def add_wait_in(self, dt: float) -> None:
        with self._lock:
            self.wait_in_s += dt

    def add_wait_out(self, dt: float) -> None:
        with self._lock:
            self.wait_out_s += dt

    def sample_depth(self, depth: int) -> None:
        with self._lock:
            self.depth_sum += depth
            self.depth_samples += 1
            self.depth_max = max(self.depth_max, depth)

    @property
    def span_s(self) -> float:
        return self.busy_s + self.wait_in_s + self.wait_out_s

    @property
    def occupancy(self) -> float:
        """Fraction of the stage's lifetime spent working (vs blocked)."""
        span = self.span_s
        return self.busy_s / span if span > 0 else 0.0

    def as_dict(self) -> Dict[str, object]:
        return dict(
            name=self.name,
            busy_s=round(self.busy_s, 4),
            wait_in_s=round(self.wait_in_s, 4),
            wait_out_s=round(self.wait_out_s, 4),
            occupancy=round(self.occupancy, 4),
            items=self.items,
            bytes=self.bytes,
            queue_depth_avg=(
                round(self.depth_sum / self.depth_samples, 2)
                if self.depth_samples
                else 0.0
            ),
            queue_depth_max=self.depth_max,
        )


@dataclasses.dataclass
class PipelineStats:
    """Telemetry for one pipeline run: ordered stages + end-to-end wall."""

    stages: List[StageStats] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    overlapped: bool = True

    def stage(self, name: str) -> StageStats:
        for s in self.stages:
            if s.name == name:
                return s
        s = StageStats(name)
        self.stages.append(s)
        return s

    def summary(self) -> Dict[str, object]:
        """The tracker-summary / bench-line shape: one entry per stage plus
        the overlap headline (sum of stage busy vs end-to-end wall — >1
        means host stages genuinely ran concurrently)."""
        busy = sum(s.busy_s for s in self.stages)
        return dict(
            overlapped=self.overlapped,
            wall_s=round(self.wall_s, 4),
            stage_busy_total_s=round(busy, 4),
            overlap_factor=(
                round(busy / self.wall_s, 3) if self.wall_s > 0 else 0.0
            ),
            stages={s.name: s.as_dict() for s in self.stages},
        )

    def log(self, prefix: str = "ingest-pipeline") -> None:
        logger.info("[timed] %s: %s", prefix, self.summary())

    def publish(self, label: str) -> None:
        """Flush this run's stage telemetry into the process-global metrics
        registry (obs/metrics) so the run report carries pipeline occupancy
        next to solver and cache metrics. Called once at pipeline finalize;
        the per-chunk hot path only ever touches the local dataclasses."""
        from photon_tpu_torch.obs.metrics import registry

        reg = registry()
        reg.gauge("pipeline_wall_s", label=label).set(self.wall_s)
        reg.gauge("pipeline_overlapped", label=label).set(int(self.overlapped))
        busy = sum(s.busy_s for s in self.stages)
        reg.gauge("pipeline_overlap_factor", label=label).set(
            busy / self.wall_s if self.wall_s > 0 else 0.0
        )
        for s in self.stages:
            kw = dict(label=label, stage=s.name)
            reg.gauge("pipeline_stage_busy_s", **kw).set(s.busy_s)
            reg.gauge("pipeline_stage_starved_s", **kw).set(s.wait_in_s)
            reg.gauge("pipeline_stage_backpressured_s", **kw).set(
                s.wait_out_s
            )
            reg.gauge("pipeline_stage_occupancy", **kw).set(s.occupancy)
            reg.counter("pipeline_stage_items_total", **kw).inc(s.items)
            reg.counter("pipeline_stage_bytes_total", **kw).inc(s.bytes)
            reg.gauge("pipeline_stage_queue_depth_max", **kw).set(s.depth_max)
            reg.gauge("pipeline_stage_queue_depth_avg", **kw).set(
                s.depth_sum / s.depth_samples if s.depth_samples else 0.0
            )


# Most-recent pipeline telemetry per label, for driver summaries (the same
# process-global pattern as Timed.records).
_pipeline_records: Dict[str, PipelineStats] = {}


def record_pipeline(label: str, stats: PipelineStats) -> None:
    _pipeline_records[label] = stats


def pipeline_records() -> Dict[str, PipelineStats]:
    return _pipeline_records


def last_pipeline(label: str) -> Optional[PipelineStats]:
    return _pipeline_records.get(label)
