"""Phase timer and pipeline statistics (the ``Timed`` class and
``StageStats``/``PipelineStats`` of photon_tpu/utils/timed.py, copied
without the trace spans and the metrics-registry publication)."""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("photon_tpu_torch")


class Timed:
    """Context-manager timer that logs and records the wall time of a phase
    in the process-global ``records`` (cleared by ``reset``)."""

    records: Dict[str, float] = {}
    _records_lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0

    @classmethod
    def reset(cls) -> None:
        with cls._records_lock:
            cls.records.clear()

    def __enter__(self) -> "Timed":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.monotonic() - self._t0
        with Timed._records_lock:
            Timed.records[self.name] = self.elapsed
        logger.info("[timed] %s: %.3fs", self.name, self.elapsed)


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


# Most-recent pipeline telemetry per label, for driver summaries (the same
# process-global pattern as Timed.records).
_pipeline_records: Dict[str, PipelineStats] = {}


def record_pipeline(label: str, stats: PipelineStats) -> None:
    _pipeline_records[label] = stats


def pipeline_records() -> Dict[str, PipelineStats]:
    return _pipeline_records


def last_pipeline(label: str) -> Optional[PipelineStats]:
    return _pipeline_records.get(label)
