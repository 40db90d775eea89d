"""Copy of photon_tpu/obs/metrics.py (framework-free; the port does not import it).

Process-global metrics registry: counters, gauges, histograms with labels.

The registry is where every subsystem's counters LAND — solve-cache
traces/hits/calls per key, pipeline stage busy/starved/backpressured wall,
replay-cache bytes and spills, shape-bucket pad waste per dim, optimizer
iterations and convergence reasons — replacing the habit of each subsystem
growing a private stats dataclass nobody else can find. The private
dataclasses (``SolveCacheStats``, ``StageStats``, …) remain as the cheap
accumulation mechanism on their hot paths and PUBLISH here at natural
flush points (pipeline finalize, report finalize), so reading the registry
never perturbs a hot loop.

Instruments are keyed by ``(name, sorted(labels))``; every mutation takes
the instrument's own lock, so concurrent stage threads can increment the
same counter without losing updates (tests/test_telemetry.py hammers this).
Values are plain Python numbers — publishing a device array here would
force a host sync, so callers convert exactly once, at finalize.

Naming convention (new instruments MUST follow it):

- Counters end in ``_total`` (``serve_requests_total``). A counter counts
  events or monotonically-accumulated quantities; byte accumulators are
  counters too (``re_store_upload_bytes_total``).
- The unit is a suffix, and it is the LAST suffix before ``_total``:
  seconds are ``_s`` (``serve_queue_wait_s``), bytes are ``_bytes``
  (``host_rss_bytes``). ``_seconds`` and unit-then-qualifier orderings
  (``model_staleness_s_hist``) are legacy; renamed instruments keep a
  read-alias in ``CANONICAL_NAMES`` so old call sites and dashboards
  resolve to the SAME instrument under the new name.
- Serve-path instruments carry a ``replica`` label: fleet replicas stamp
  it via ``set_default_labels(replica=<id>)`` at process start; the
  frontend's own instruments get ``replica="frontend"`` filled in at
  ``/metrics`` render time (``render_prometheus(extra_labels=...)``),
  so one merged scrape never mixes two processes' series.

``render_prometheus`` turns ``snapshot()`` dicts (ours or a fleet
replica's, shipped over the scrape op) into Prometheus text exposition
format v0.0.4: counters/gauges verbatim, histograms as summaries
(``{quantile=...}`` + ``_sum``/``_count``).
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# Legacy instrument name -> canonical name. Both spellings address the
# SAME instrument (the registry canonicalizes on every lookup), and
# snapshots/renders emit only the canonical name.
CANONICAL_NAMES: Dict[str, str] = {
    "re_entities_skipped": "re_entities_skipped_total",
    "pipeline_wall_seconds": "pipeline_wall_s",
    "pipeline_stage_busy_seconds": "pipeline_stage_busy_s",
    "pipeline_stage_starved_seconds": "pipeline_stage_starved_s",
    "pipeline_stage_backpressured_seconds": "pipeline_stage_backpressured_s",
    "model_staleness_s_hist": "model_staleness_hist_s",
}


def canonical_name(name: str) -> str:
    return CANONICAL_NAMES.get(name, name)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    kind = "instrument"

    def __init__(self, name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(_Instrument):
    """Monotonically-increasing count (events, items, bytes)."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelKey):
        super().__init__(name, labels)
        self._value = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def as_dict(self) -> dict:
        return dict(record="metric", metric=self.name, type=self.kind,
                    labels=self.label_dict(), value=self.value, stats=None)


class Gauge(_Instrument):
    """Last-write-wins value (occupancy, cached bytes, wall seconds)."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey):
        super().__init__(name, labels)
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def add(self, amount: float) -> None:
        with self._lock:
            self._value = (self._value or 0) + amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def as_dict(self) -> dict:
        return dict(record="metric", metric=self.name, type=self.kind,
                    labels=self.label_dict(), value=self.value, stats=None)


class Histogram(_Instrument):
    """Streaming summary (count/sum/min/max) plus a bounded DETERMINISTIC
    reservoir for percentile estimates (p50/p95/p99 — the latency columns a
    serving report is useless without).

    The reservoir keeps every observation until it reaches capacity, then
    halves itself (every 2nd element) and doubles its sampling stride, so it
    always holds an evenly-strided subsample of the full sequence in
    arrival order. Deterministic by construction — no RNG — so two runs over
    the same observation sequence report the same percentiles, and memory is
    bounded at ``RESERVOIR_CAP`` floats regardless of observation count.
    Percentiles are exact below the cap and stride-approximate above it."""

    kind = "histogram"
    RESERVOIR_CAP = 4096
    # Exemplar store: a handful of (value, trace_id) pairs linking the
    # series to flight-recorder traces. Same deterministic keep-every-
    # stride / halve-and-double scheme as the value reservoir (no RNG):
    # two runs over the same traced sequence keep the same exemplars.
    EXEMPLAR_CAP = 8

    def __init__(self, name: str, labels: LabelKey):
        super().__init__(name, labels)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._sample: List[float] = []
        self._stride = 1
        self._since_kept = 0
        self._exemplars: List[Tuple[float, str]] = []
        self._ex_stride = 1
        self._ex_since = 0

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._since_kept += 1
            if self._since_kept >= self._stride:
                self._since_kept = 0
                self._sample.append(v)
                if len(self._sample) >= self.RESERVOIR_CAP:
                    self._sample = self._sample[::2]
                    self._stride *= 2
            if trace_id:
                self._ex_since += 1
                if self._ex_since >= self._ex_stride:
                    self._ex_since = 0
                    self._exemplars.append((v, trace_id))
                    if len(self._exemplars) >= self.EXEMPLAR_CAP:
                        self._exemplars = self._exemplars[::2]
                        self._ex_stride *= 2

    def exemplars(self) -> List[dict]:
        """Kept (value, trace_id) pairs, oldest first. The LAST one is
        what the Prometheus render attaches (freshest link)."""
        with self._lock:
            return [
                {"value": v, "traceId": tid} for v, tid in self._exemplars
            ]

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.sum / self.count if self.count else None

    @staticmethod
    def _quantile(ordered: List[float], q: float) -> float:
        """Linear interpolation between closest ranks (numpy's default)."""
        pos = q * (len(ordered) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(ordered) - 1)
        return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)

    def percentiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, Optional[float]]:
        with self._lock:
            ordered = sorted(self._sample)
        if not ordered:
            return {f"p{round(q * 100)}": None for q in qs}
        return {
            f"p{round(q * 100)}": self._quantile(ordered, q) for q in qs
        }

    def as_dict(self) -> dict:
        pcts = self.percentiles()
        with self._lock:
            stats = dict(
                count=self.count,
                sum=self.sum,
                min=self.min,
                max=self.max,
                mean=self.sum / self.count if self.count else None,
                **pcts,
            )
            if self._exemplars:
                # ``stats`` is an OPEN dict in the report schema
                # (obs/report.py validates the envelope, not stats keys),
                # so exemplars ride the existing record shape.
                stats["exemplars"] = [
                    {"value": v, "traceId": tid}
                    for v, tid in self._exemplars
                ]
        return dict(record="metric", metric=self.name, type=self.kind,
                    labels=self.label_dict(), value=None, stats=stats)


class MetricsRegistry:
    """Label-aware instrument store. ``counter/gauge/histogram`` create on
    first use and return the same instrument for the same (name, labels)
    thereafter; a name cannot change kind."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, LabelKey], _Instrument] = {}
        self._default_labels: Dict[str, str] = {}

    def set_default_labels(self, **labels) -> None:
        """Labels merged into every instrument created AFTER this call —
        how a fleet replica stamps ``replica=<id>`` on all its serve
        metrics without threading the id through every call site. Explicit
        labels win on collision; passing nothing clears the defaults.
        Set once at process start (before instruments exist): instruments
        created earlier keep their original label sets."""
        with self._lock:
            self._default_labels = {
                str(k): str(v) for k, v in labels.items()
            }

    def default_labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._default_labels)

    def _get(self, cls, name: str, labels: Dict[str, object]):
        name = canonical_name(name)
        if self._default_labels:
            labels = {**self._default_labels, **labels}
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1])
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}"
                )
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def find(self, name: str, **labels) -> Optional[_Instrument]:
        """Lookup without creating (tests, bench readers). Default labels
        are merged the same way ``_get`` merges them, so an in-process
        reader addresses instruments by the labels IT passed at creation."""
        name = canonical_name(name)
        if self._default_labels:
            labels = {**self._default_labels, **labels}
        with self._lock:
            return self._instruments.get((name, _label_key(labels)))

    def collect(self, prefix: str = "") -> List[_Instrument]:
        with self._lock:
            return [
                inst
                for (name, _), inst in sorted(self._instruments.items())
                if name.startswith(prefix)
            ]

    def snapshot(self) -> List[dict]:
        """One report-ready dict per instrument (the ``metric`` JSONL
        record shape)."""
        return [inst.as_dict() for inst in self.collect()]

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._default_labels = {}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every subsystem publishes into."""
    return _REGISTRY


def reset_registry() -> None:
    _REGISTRY.reset()


# -- Prometheus text exposition -------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")
_QUANTILES = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


def prometheus_name(name: str) -> str:
    """Canonicalize then sanitize to the Prometheus metric-name charset."""
    name = _PROM_NAME_BAD.sub("_", canonical_name(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_label_value(value: object) -> str:
    s = str(value)
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _prom_labels(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    parts = [
        f'{_PROM_LABEL_BAD.sub("_", str(k))}="{_prom_label_value(v)}"'
        for k, v in sorted(labels.items(), key=lambda kv: str(kv[0]))
    ]
    return "{" + ",".join(parts) + "}"


def _prom_number(value) -> str:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(
    snapshots: Iterable[dict],
    extra_labels: Optional[Dict[str, str]] = None,
) -> str:
    """Snapshot dicts (``MetricsRegistry.snapshot()`` shape — local or
    shipped from a fleet replica over the scrape op) -> Prometheus text
    exposition format v0.0.4.

    ``extra_labels`` FILL IN where absent (existing labels win): the
    frontend stamps ``replica="frontend"`` on its own instruments this way
    so the merged fleet scrape keeps every serve-path series disambiguated
    by replica. Counters/gauges render verbatim; histograms render as
    summaries (quantile series + ``_sum``/``_count``). Series are grouped
    by name so each metric gets exactly one ``# TYPE`` header even when
    several processes contribute."""
    extra = {str(k): str(v) for k, v in (extra_labels or {}).items()}
    grouped: "Dict[str, List[dict]]" = {}
    order: List[str] = []
    for snap in snapshots:
        if not isinstance(snap, dict) or snap.get("record") != "metric":
            continue
        name = prometheus_name(str(snap.get("metric", "")))
        if name not in grouped:
            grouped[name] = []
            order.append(name)
        grouped[name].append(snap)
    lines: List[str] = []
    for name in order:
        snaps = grouped[name]
        kind = snaps[0].get("type", "gauge")
        prom_type = {"counter": "counter", "histogram": "summary"}.get(
            str(kind), "gauge"
        )
        lines.append(f"# TYPE {name} {prom_type}")
        for snap in snaps:
            labels = dict(snap.get("labels") or {})
            for k, v in extra.items():
                labels.setdefault(k, v)
            if snap.get("type") == "histogram":
                stats = snap.get("stats") or {}
                for pkey, q in _QUANTILES:
                    val = stats.get(pkey)
                    if val is None:
                        continue
                    qlabels = dict(labels)
                    qlabels["quantile"] = q
                    lines.append(
                        f"{name}{_prom_labels(qlabels)} {_prom_number(val)}"
                    )
                lines.append(
                    f"{name}_sum{_prom_labels(labels)} "
                    f"{_prom_number(stats.get('sum', 0.0))}"
                )
                count_line = (
                    f"{name}_count{_prom_labels(labels)} "
                    f"{_prom_number(stats.get('count', 0))}"
                )
                # OpenMetrics exemplar: link the freshest kept
                # (value, trace_id) pair to the series so a scrape can
                # jump from a latency bucket straight to the flight-
                # recorder trace (photon-tpu-obs traces <trace_id>).
                exemplars = stats.get("exemplars")
                if exemplars:
                    ex = exemplars[-1]
                    count_line += (
                        f' # {{trace_id="{ex["traceId"]}"}}'
                        f' {_prom_number(ex["value"])}'
                    )
                lines.append(count_line)
            else:
                value = snap.get("value")
                if value is None:
                    continue
                lines.append(
                    f"{name}{_prom_labels(labels)} {_prom_number(value)}"
                )
    return "\n".join(lines) + ("\n" if lines else "")
