"""Copy of photon_tpu/obs/export.py (framework-free; the port does not import it).

OTLP-shaped span/metrics export: JSON-over-HTTP, protobuf-free.

The observability plane is entirely in-process: the flight recorder answers
"what just went wrong *here*", but nothing leaves the box. This module
closes that edge with a batch exporter that POSTs OTLP-shaped JSON
(``resourceSpans`` / ``resourceMetrics``, the same envelope an OTLP/HTTP
collector accepts for JSON encoding) to ``<endpoint>/v1/traces`` and
``<endpoint>/v1/metrics`` — stdlib ``urllib`` only, because the
container has no protobuf/grpc and the degradation policy (model
artifacts > training progress > observability) forbids observability
from ever becoming a hard dependency.

Degradation contract, in order:
  - the hot path NEVER blocks: ``on_span`` is an O(1) enqueue under a
    lock; a full queue drops the span and counts it;
  - a flaky collector is retried with exponential backoff, a dead one
    costs one bounded retry cycle per batch and then the batch is
    DROPPED and counted (``dropped_batches``/``last_error``), visible in
    ``/healthz`` under ``otlp_exporter`` — never an exception, never a
    stall in scoring or training;
  - ``close()`` bounds its final drain, so driver shutdown cannot hang
    on an unreachable endpoint.

The exporter taps the tracer's sink mechanism (``Tracer.add_sink``),
which fires only for spans recorded under a sampled ``TraceContext`` —
untraced spans (the overwhelming majority under training) pay nothing.
Sinks survive ``begin_run()`` (the tracer reset keeps them), so drivers
install once, right after ``begin_run``.

``MockCollector`` is the stdlib in-process collector tests, ``ci.sh
obs`` and ``bench.py`` run against: it stores every decoded batch,
supports injected failures (``fail_next``) for the retry/drop paths, and
needs nothing outside ``http.server``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Callable, List, Optional, Tuple

from photon_tpu_torch.obs.trace import SpanRecord, tracer

OTLP_TRACES_PATH = "/v1/traces"
OTLP_METRICS_PATH = "/v1/metrics"

# Queue/batch defaults: 2048 spans ≈ 4 full flight-recorder trace trees;
# bounded so a dead collector costs memory O(queue_cap), not O(uptime).
DEFAULT_QUEUE_CAP = 2048
DEFAULT_BATCH_MAX = 256
DEFAULT_FLUSH_INTERVAL_S = 0.5


def _hex_or_pad(value: Optional[str], width: int) -> str:
    """OTLP requires fixed-width lowercase hex ids; pad defensively so a
    hand-minted test id never produces an invalid document."""
    v = (value or "").lower()
    return v.rjust(width, "0")[:width]


def span_to_otlp(rec: SpanRecord, epoch_unix_s: float) -> dict:
    """One ``SpanRecord`` → one OTLP JSON span. ``start_s`` is relative
    to the tracer epoch; the wall epoch converts it to unix nanos."""
    start_ns = int((epoch_unix_s + rec.start_s) * 1e9)
    end_ns = start_ns + int(rec.duration_s * 1e9)
    out = {
        "traceId": _hex_or_pad(rec.trace_id, 32),
        "spanId": _hex_or_pad(rec.span_id, 16),
        "name": rec.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": [
            {"key": "thread", "value": {"stringValue": rec.thread}},
        ],
    }
    if rec.parent_span_id:
        out["parentSpanId"] = _hex_or_pad(rec.parent_span_id, 16)
    if rec.pid is not None:
        out["attributes"].append(
            {"key": "pid", "value": {"intValue": str(rec.pid)}}
        )
    if rec.parent:
        out["attributes"].append(
            {"key": "parent_path", "value": {"stringValue": rec.parent}}
        )
    return out


def _otlp_attrs(labels: Optional[dict]) -> list:
    return [
        {"key": str(k), "value": {"stringValue": str(v)}}
        for k, v in sorted((labels or {}).items())
    ]


def snapshot_to_otlp(snapshot: List[dict], now_unix_ns: int) -> List[dict]:
    """A ``MetricsRegistry.snapshot()`` → OTLP JSON metric list.

    Counters map to monotonic sums, gauges to gauges, histograms to OTLP
    summary-style gauges carrying count/sum/quantile attributes (the
    registry keeps quantiles, not buckets — exporting what we actually
    measure beats inventing bucket boundaries). Exemplars ride along as
    OTLP exemplars with ``traceId`` so a collector can link back."""
    ts = str(now_unix_ns)
    out: List[dict] = []
    for snap in snapshot:
        name = snap.get("metric")
        kind = snap.get("type")
        attrs = _otlp_attrs(snap.get("labels"))
        if kind == "counter":
            out.append({
                "name": name,
                "sum": {
                    "aggregationTemporality": 2,  # CUMULATIVE
                    "isMonotonic": True,
                    "dataPoints": [{
                        "timeUnixNano": ts,
                        "asDouble": float(snap.get("value") or 0),
                        "attributes": attrs,
                    }],
                },
            })
        elif kind == "gauge":
            out.append({
                "name": name,
                "gauge": {
                    "dataPoints": [{
                        "timeUnixNano": ts,
                        "asDouble": float(snap.get("value") or 0),
                        "attributes": attrs,
                    }],
                },
            })
        elif kind == "histogram":
            stats = snap.get("stats") or {}
            point = {
                "timeUnixNano": ts,
                "count": str(int(stats.get("count") or 0)),
                "sum": float(stats.get("sum") or 0.0),
                "attributes": attrs + [
                    {"key": f"quantile_{q}",
                     "value": {"doubleValue": float(stats[q])}}
                    for q in ("p50", "p95", "p99")
                    if stats.get(q) is not None
                ],
            }
            exemplars = stats.get("exemplars") or ()
            if exemplars:
                point["exemplars"] = [
                    {
                        "timeUnixNano": ts,
                        "asDouble": float(ex["value"]),
                        "traceId": _hex_or_pad(ex.get("traceId"), 32),
                    }
                    for ex in exemplars
                ]
            out.append({
                "name": name,
                "histogram": {
                    "aggregationTemporality": 2,
                    "dataPoints": [point],
                },
            })
    return out


class OTLPExporter:
    """Bounded-queue background exporter. One instance per process.

    ``on_span`` is the tracer sink (traced spans only); ``export_metrics``
    enqueues one registry snapshot as a batch. A single worker thread
    drains both, POSTing JSON with bounded retry + backoff; terminal
    failures drop-and-count. ``health()`` is the ``/healthz`` block."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = "photon-tpu",
        queue_cap: int = DEFAULT_QUEUE_CAP,
        batch_max: int = DEFAULT_BATCH_MAX,
        flush_interval_s: float = DEFAULT_FLUSH_INTERVAL_S,
        timeout_s: float = 5.0,
        max_retries: int = 3,
        backoff_s: float = 0.1,
        backoff_max_s: float = 2.0,
        metrics_interval_s: float = 0.0,
        snapshot_fn: Optional[Callable[[], List[dict]]] = None,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.queue_cap = queue_cap
        self.batch_max = batch_max
        self.flush_interval_s = flush_interval_s
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        # Periodic self-scrape: >0 → the worker snapshots the registry
        # every interval, so long-running drivers export without any
        # caller-side plumbing. snapshot_fn is injectable for tests.
        self.metrics_interval_s = metrics_interval_s
        self._snapshot_fn = snapshot_fn

        self._lock = threading.Lock()
        self._spans: deque = deque()
        self._metric_batches: deque = deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()

        self.exported_spans = 0
        self.exported_span_batches = 0
        self.exported_metric_batches = 0
        self.dropped_spans = 0
        self.dropped_batches = 0
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        self.last_export_unix_s: Optional[float] = None

        self._worker = threading.Thread(
            target=self._run, name="otlp-export", daemon=True
        )
        self._worker.start()

    # ---- intake (hot path) ------------------------------------------

    def on_span(self, rec: SpanRecord) -> None:
        """Tracer sink: O(1) enqueue; full queue drops-and-counts. Never
        raises (the tracer swallows sink errors anyway — this keeps the
        accounting honest instead of relying on that backstop)."""
        with self._lock:
            if len(self._spans) >= self.queue_cap:
                self.dropped_spans += 1
                return
            self._spans.append(rec)
            self._idle.clear()
        self._wake.set()

    def export_metrics(self, snapshot: Optional[List[dict]] = None) -> bool:
        """Enqueue one metrics snapshot as a batch; False if dropped."""
        if snapshot is None:
            snapshot = self._take_snapshot()
        if not snapshot:
            return True
        with self._lock:
            # Metrics batches are cumulative — a newer snapshot strictly
            # supersedes an older unsent one, so the queue bound sheds
            # the OLDEST batch (drop-and-count), keeping freshest state.
            if len(self._metric_batches) >= 8:
                self._metric_batches.popleft()
                self.dropped_batches += 1
            self._metric_batches.append(snapshot)
            self._idle.clear()
        self._wake.set()
        return True

    def _take_snapshot(self) -> List[dict]:
        if self._snapshot_fn is not None:
            return self._snapshot_fn()
        from photon_tpu_torch.obs.metrics import registry

        return registry().snapshot()

    # ---- worker ------------------------------------------------------

    def _run(self) -> None:
        last_metrics = time.monotonic()
        while True:
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            if (
                self.metrics_interval_s > 0
                and time.monotonic() - last_metrics >= self.metrics_interval_s
            ):
                last_metrics = time.monotonic()
                try:
                    self.export_metrics()
                except Exception:  # noqa: BLE001 — never kill the worker
                    pass
            self._drain_once()
            if self._stop.is_set():
                self._drain_once()
                return

    def _drain_once(self) -> None:
        while True:
            with self._lock:
                batch = []
                while self._spans and len(batch) < self.batch_max:
                    batch.append(self._spans.popleft())
                metric_batch = (
                    self._metric_batches.popleft()
                    if not batch and self._metric_batches else None
                )
                if not batch and metric_batch is None:
                    self._idle.set()
                    return
            if batch:
                self._send_spans(batch)
            elif metric_batch is not None:
                self._send_metrics(metric_batch)

    def _send_spans(self, batch: List[SpanRecord]) -> None:
        epoch = tracer().epoch_unix_s
        payload = {
            "resourceSpans": [{
                "resource": {"attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": self.service_name}},
                ]},
                "scopeSpans": [{
                    "scope": {"name": "photon_tpu.obs"},
                    "spans": [span_to_otlp(r, epoch) for r in batch],
                }],
            }],
        }
        if self._post(OTLP_TRACES_PATH, payload):
            self.exported_spans += len(batch)
            self.exported_span_batches += 1
        else:
            self.dropped_spans += len(batch)
            self.dropped_batches += 1

    def _send_metrics(self, snapshot: List[dict]) -> None:
        now_ns = int(time.time() * 1e9)
        payload = {
            "resourceMetrics": [{
                "resource": {"attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": self.service_name}},
                ]},
                "scopeMetrics": [{
                    "scope": {"name": "photon_tpu.obs"},
                    "metrics": snapshot_to_otlp(snapshot, now_ns),
                }],
            }],
        }
        if self._post(OTLP_METRICS_PATH, payload):
            self.exported_metric_batches += 1
        else:
            self.dropped_batches += 1

    def _post(self, path: str, payload: dict) -> bool:
        body = json.dumps(payload).encode("utf-8")
        delay = self.backoff_s
        for attempt in range(self.max_retries):
            if attempt and self._stop.is_set():
                break  # shutdown: one try, no backoff sleeps
            try:
                req = urllib.request.Request(
                    self.endpoint + path, data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    pass
                self.consecutive_failures = 0
                self.last_export_unix_s = time.time()
                return True
            except Exception as exc:  # noqa: BLE001 — degrade, never raise
                self.last_error = f"{type(exc).__name__}: {exc}"[:200]
                self.consecutive_failures += 1
                if attempt + 1 < self.max_retries:
                    time.sleep(delay)
                    delay = min(delay * 2, self.backoff_max_s)
        return False

    # ---- lifecycle / introspection ----------------------------------

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the queue drains (or timeout). Test/bench helper —
        production paths never wait on the exporter."""
        self._wake.set()
        return self._idle.wait(timeout_s)

    def close(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        self._worker.join(timeout_s)

    def health(self) -> dict:
        with self._lock:
            depth = len(self._spans) + len(self._metric_batches)
        return {
            "endpoint": self.endpoint,
            "queue_depth": depth,
            "queue_cap": self.queue_cap,
            "exported_spans": self.exported_spans,
            "exported_span_batches": self.exported_span_batches,
            "exported_metric_batches": self.exported_metric_batches,
            "dropped_spans": self.dropped_spans,
            "dropped_batches": self.dropped_batches,
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
            "last_export_unix_s": self.last_export_unix_s,
        }


# ---- process-global registry ----------------------------------------
#
# One exporter per process, installed by the driver right after
# begin_run(). Tracer sinks survive begin_run's tracer reset, so the
# subscription holds for the whole process lifetime.

_ACTIVE: Optional[OTLPExporter] = None
_ACTIVE_LOCK = threading.Lock()


def install_exporter(exporter: OTLPExporter) -> OTLPExporter:
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, exporter
    if prev is not None:
        tracer().remove_sink(prev.on_span)
        prev.close(timeout_s=1.0)
    tracer().add_sink(exporter.on_span)
    return exporter


def active_exporter() -> Optional[OTLPExporter]:
    return _ACTIVE


def uninstall_exporter() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        exporter, _ACTIVE = _ACTIVE, None
    if exporter is not None:
        tracer().remove_sink(exporter.on_span)
        exporter.close(timeout_s=1.0)


def exporter_health() -> Optional[dict]:
    """The ``/healthz`` ``otlp_exporter`` block; None when no exporter is
    installed (the block is omitted, as in payloads without an exporter)."""
    exporter = _ACTIVE
    return None if exporter is None else exporter.health()


def maybe_install_exporter(
    endpoint: Optional[str], service_name: str, **kwargs
) -> Optional[OTLPExporter]:
    """Driver entry: ``--otlp-endpoint`` wiring in one line. Falsy
    endpoint → no-op (observability stays fully in-process)."""
    if not endpoint:
        return None
    return install_exporter(
        OTLPExporter(endpoint, service_name=service_name, **kwargs)
    )


# ---- mock collector --------------------------------------------------


class MockCollector:
    """Stdlib in-process OTLP collector for tests/bench/CI.

    Stores every decoded batch; ``fail_next(n)`` makes the next ``n``
    requests answer 503 (retry/backoff drills); ``port=0`` binds an
    ephemeral port. Runs a daemon ThreadingHTTPServer — ``close()`` when
    done."""

    def __init__(self, port: int = 0):
        import http.server

        collector = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                with collector._lock:
                    collector.requests_total += 1
                    if collector._fail_budget > 0:
                        collector._fail_budget -= 1
                        self.send_response(503)
                        self.end_headers()
                        return
                    try:
                        payload = json.loads(raw.decode("utf-8"))
                    except Exception:  # noqa: BLE001
                        self.send_response(400)
                        self.end_headers()
                        return
                    if self.path == OTLP_TRACES_PATH:
                        collector.span_batches.append(payload)
                    elif self.path == OTLP_METRICS_PATH:
                        collector.metric_batches.append(payload)
                    else:
                        self.send_response(404)
                        self.end_headers()
                        return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):  # quiet
                pass

        self._lock = threading.Lock()
        self.span_batches: List[dict] = []
        self.metric_batches: List[dict] = []
        self.requests_total = 0
        self._fail_budget = 0
        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="mock-otlp", daemon=True
        )
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def fail_next(self, n: int) -> None:
        with self._lock:
            self._fail_budget = n

    def spans(self) -> List[dict]:
        """All received OTLP spans, flattened across batches."""
        out = []
        with self._lock:
            batches = list(self.span_batches)
        for payload in batches:
            for rs in payload.get("resourceSpans", ()):
                for ss in rs.get("scopeSpans", ()):
                    out.extend(ss.get("spans", ()))
        return out

    def metrics(self) -> List[dict]:
        """All received OTLP metrics, flattened across batches."""
        out = []
        with self._lock:
            batches = list(self.metric_batches)
        for payload in batches:
            for rm in payload.get("resourceMetrics", ()):
                for sm in rm.get("scopeMetrics", ()):
                    out.extend(sm.get("metrics", ()))
        return out

    def metric_exemplar_trace_ids(self) -> List[Tuple[str, str]]:
        """(metric_name, traceId) for every exemplar received."""
        out = []
        for m in self.metrics():
            for dp in (m.get("histogram") or {}).get("dataPoints", ()):
                for ex in dp.get("exemplars", ()):
                    out.append((m["name"], ex.get("traceId")))
        return out

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
