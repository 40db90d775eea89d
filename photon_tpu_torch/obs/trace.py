"""Copy of photon_tpu/obs/trace.py (framework-free; the port does not import it).

Hierarchical trace spans: host-wall attribution for one training run.

The span tree is the run-report's answer to "where did this run spend its
time" — the hierarchical wall-clock attribution Snap ML (arxiv 1803.06333)
and the pjit/TPUv4 scaling work (arxiv 2204.06514) use to find the next
bottleneck: data path vs. solver vs. compile, per coordinate and per CD
pass, in one tree instead of four subsystems' private logs.

Contract (the sync-free dispatch rule): spans measure HOST wall only —
``time.monotonic`` around whatever the ``with`` body does. A span around a
jitted dispatch under ``CoordinateDescent.run(profile=False)`` therefore
times enqueue cost, never device execution, and introduces zero
``block_until_ready`` host syncs (tests/test_solve_cache.py pins this).

Nesting is thread-local by default: a span opened inside another span on
the same thread becomes its child (path ``parent/child``). Work handed to
another thread — the ingest pipeline's stage threads — passes the parent
path EXPLICITLY (``span(name, parent=path)``), so the tree stays connected
across threads without any global ambient state leaking between runs.

Cross-PROCESS nesting rides a W3C-traceparent-style ``TraceContext``
``(trace_id, parent_span_id, sampled)``: the frontend mints one per
request, every IPC frame carries it (``trace`` field), and each receiving
process opens REMOTE-CHILD spans — spans stamped with
``trace_id/span_id/parent_span_id`` so the trees from the HTTP worker, the
scorer, and each fleet replica reassemble into one request tree. Trace
identity lives OUTSIDE the run-report schema: ``SpanRecord.as_dict()`` is
unchanged (report.py's strict schema still validates); the wire/dump form
is ``as_trace_dict()``. Untraced spans (no context) pay nothing new.

The tail-based ``FlightRecorder`` buffers traced spans per trace id and, at
request completion, keeps the full tree ONLY for requests that are slow
(latency above its own streaming p99), errored, degraded, or explicitly
forced by a client-sent ``traceparent`` header — the "what just went wrong"
ring the ``/v1/traces`` endpoint and ``photon-tpu-obs`` dump.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from photon_tpu_torch.obs.metrics import Histogram, _label_key

SEP = "/"

# Serving soaks record spans per micro-batch indefinitely; an unbounded
# list is a slow memory leak. The collector keeps the NEWEST max_spans
# (deque ring), counting what it sheds — the run report's byte budget
# (obs/report.py) is the second line of defense.
DEFAULT_MAX_SPANS = int(os.environ.get("PHOTON_TPU_TRACE_MAX_SPANS", 100_000))

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """What crosses a process boundary: which request (``trace_id``), which
    caller span to nest under (``parent_span_id``), and whether anyone is
    recording (``sampled``). ``forced`` marks traces the CLIENT asked for
    via an explicit ``traceparent`` header — the flight recorder keeps
    those unconditionally instead of tail-sampling them."""

    trace_id: str
    parent_span_id: Optional[str] = None
    sampled: bool = True
    forced: bool = False

    def child(self, span_id: str) -> "TraceContext":
        """The context to hand DOWNSTREAM from a span: same trace, the
        given span as the new parent."""
        return TraceContext(self.trace_id, span_id, self.sampled, self.forced)

    # -- wire forms --------------------------------------------------------

    def to_dict(self) -> dict:
        return dict(
            traceId=self.trace_id,
            parentSpanId=self.parent_span_id,
            sampled=bool(self.sampled),
            forced=bool(self.forced),
        )

    @classmethod
    def from_dict(cls, obj) -> Optional["TraceContext"]:
        if not isinstance(obj, dict):
            return None
        tid = obj.get("traceId")
        if not isinstance(tid, str) or not tid:
            return None
        psid = obj.get("parentSpanId")
        return cls(
            trace_id=tid,
            parent_span_id=psid if isinstance(psid, str) and psid else None,
            sampled=bool(obj.get("sampled", True)),
            forced=bool(obj.get("forced", False)),
        )

    def to_traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.parent_span_id or '0' * 16}-{flags}"

    @classmethod
    def from_traceparent(cls, header: Optional[str]) -> Optional["TraceContext"]:
        """Parse an incoming ``traceparent`` header. An explicit header is a
        request to SEE the trace, so it arrives ``forced``."""
        if not header:
            return None
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if m is None:
            return None
        _, tid, psid, flags = m.groups()
        if tid == "0" * 32:
            return None
        return cls(
            trace_id=tid,
            parent_span_id=None if psid == "0" * 16 else psid,
            sampled=bool(int(flags, 16) & 1),
            forced=True,
        )


def mint_context(sampled: bool = True, forced: bool = False) -> TraceContext:
    """A fresh root context (no parent span yet): what the frontend mints
    when a request arrives without a ``traceparent`` header."""
    return TraceContext(new_trace_id(), None, sampled, forced)


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span. ``start_s`` is relative to the tracer epoch
    (reset at driver entry), so the report is stable across machines.

    The trace-identity fields (``trace_id/span_id/parent_span_id/pid``) are
    set only on spans recorded under a sampled TraceContext; they are
    deliberately NOT part of ``as_dict()`` so the run-report schema
    (obs/report.py, exact-field validation) is untouched — cross-process
    dumps use ``as_trace_dict()`` instead."""

    name: str  # full hierarchical path, e.g. "cd/iter3/per-user/solve"
    parent: Optional[str]  # full path of the enclosing span (None = root)
    start_s: float
    duration_s: float
    thread: str
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    pid: Optional[int] = None

    def as_dict(self) -> dict:
        return dict(
            record="span",
            name=self.name,
            parent=self.parent,
            start_s=round(self.start_s, 6),
            duration_s=round(self.duration_s, 6),
            thread=self.thread,
        )

    def as_trace_dict(self) -> dict:
        """The cross-process dump form: everything ``as_dict`` has plus
        trace identity, keyed for JSON wire use."""
        return dict(
            name=self.name,
            parent=self.parent,
            start_s=round(self.start_s, 6),
            duration_s=round(self.duration_s, 6),
            thread=self.thread,
            traceId=self.trace_id,
            spanId=self.span_id,
            parentSpanId=self.parent_span_id,
            pid=self.pid,
        )


class Tracer:
    """Thread-safe span collector. One process-global instance backs the
    module-level helpers; tests may build private ones."""

    def __init__(self, max_spans: Optional[int] = None):
        self._lock = threading.Lock()
        self.max_spans = DEFAULT_MAX_SPANS if max_spans is None else max_spans
        self._spans: deque = deque(
            maxlen=self.max_spans if self.max_spans > 0 else None
        )
        self.dropped_spans = 0
        self._local = threading.local()
        self._epoch = time.monotonic()
        self.epoch_unix_s = time.time()
        self._sinks: List[Callable[[SpanRecord], None]] = []

    # -- thread-local nesting stack ---------------------------------------

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tstack(self) -> List[Optional[Tuple[str, str, bool]]]:
        """Parallel to ``_stack``: per open span, its (trace_id, span_id,
        forced) when it was opened under a sampled context, else None."""
        ts = getattr(self._local, "tstack", None)
        if ts is None:
            ts = self._local.tstack = []
        return ts

    def current_path(self) -> Optional[str]:
        """Full path of the innermost open span on THIS thread (None at
        top level). Capture it before handing work to another thread and
        pass it as ``parent=`` there."""
        stack = self._stack()
        return stack[-1] if stack else None

    # -- cross-process context ---------------------------------------------

    @contextmanager
    def attach_context(self, ctx: Optional[TraceContext]) -> Iterator[None]:
        """Install an incoming (deserialized) context as this thread's
        ambient trace: spans opened in the body become remote children of
        the caller's span. Restores the previous attachment on exit."""
        prev = getattr(self._local, "attached", None)
        self._local.attached = ctx
        try:
            yield
        finally:
            self._local.attached = prev

    def _innermost_traced(self) -> Optional[Tuple[str, str, bool]]:
        for entry in reversed(self._tstack()):
            if entry is not None:
                return entry
        return None

    def current_context(self) -> Optional[TraceContext]:
        """The context to hand DOWNSTREAM from this thread right now: the
        innermost open traced span if any, else the attached incoming
        context, else None (nothing is tracing)."""
        entry = self._innermost_traced()
        if entry is not None:
            tid, sid, forced = entry
            return TraceContext(tid, sid, True, forced)
        return getattr(self._local, "attached", None)

    # Alias named for symmetry with attach_context: "extract" is what a
    # sender calls immediately before serializing onto the wire.
    extract_context = current_context

    def _effective_context(
        self, context: Optional[TraceContext]
    ) -> Optional[TraceContext]:
        if context is not None:
            return context
        return self.current_context()

    # -- recording ---------------------------------------------------------

    @contextmanager
    def span(
        self,
        name: str,
        parent: Optional[str] = None,
        context: Optional[TraceContext] = None,
    ) -> Iterator[str]:
        """Time the body; record one SpanRecord on exit (exceptions
        included — a failed phase still shows its wall). Yields the full
        path so callers can hand it to worker threads.

        With a sampled ``context`` (explicit, ambient from an enclosing
        traced span, or attached via ``attach_context``) the span also gets
        trace identity: a fresh span id, parented on the innermost open
        traced span or the context's remote parent."""
        base = parent if parent is not None else self.current_path()
        path = f"{base}{SEP}{name}" if base else name
        ctx = self._effective_context(context)
        tentry: Optional[Tuple[str, str, bool]] = None
        psid: Optional[str] = None
        if ctx is not None and ctx.sampled:
            inner = self._innermost_traced()
            psid = inner[1] if inner is not None else ctx.parent_span_id
            tentry = (ctx.trace_id, new_span_id(), ctx.forced)
        stack = self._stack()
        tstack = self._tstack()
        stack.append(path)
        tstack.append(tentry)
        t0 = time.monotonic()
        try:
            yield path
        finally:
            dt = time.monotonic() - t0
            if stack and stack[-1] == path:
                stack.pop()
                if tstack:
                    tstack.pop()
            self._append(
                SpanRecord(
                    path, base, t0 - self._epoch, dt,
                    threading.current_thread().name,
                    trace_id=tentry[0] if tentry else None,
                    span_id=tentry[1] if tentry else None,
                    parent_span_id=psid if tentry else None,
                    pid=os.getpid() if tentry else None,
                )
            )

    def record(
        self,
        name: str,
        duration_s: float,
        parent: Optional[str] = None,
        start_s: Optional[float] = None,
        context: Optional[TraceContext] = None,
        span_id: Optional[str] = None,
    ) -> SpanRecord:
        """Record an externally-timed span (e.g. a generator whose lifetime
        was measured by its own try/finally, or a request whose completion
        lands on a callback thread). ``context``/``span_id`` give it trace
        identity: pre-mint the span id at dispatch time when downstream
        work must reference this span as parent BEFORE it completes.

        ``parent=""`` pins the span at the process root: completion
        callbacks run on whatever thread the engine flushes from, and a
        request-hop span must not inherit that thread's open span stack."""
        base = (parent if parent is not None else self.current_path()) or None
        path = f"{base}{SEP}{name}" if base else name
        if start_s is None:
            start_s = time.monotonic() - self._epoch - duration_s
        traced = context is not None and context.sampled
        rec = SpanRecord(
            path, base, start_s, duration_s,
            threading.current_thread().name,
            trace_id=context.trace_id if traced else None,
            span_id=(span_id or new_span_id()) if traced else None,
            parent_span_id=context.parent_span_id if traced else None,
            pid=os.getpid() if traced else None,
        )
        self._append(rec)
        return rec

    def add_sink(self, sink: Callable[[SpanRecord], None]) -> None:
        """Register a callable invoked (outside the tracer lock) for every
        TRACED span recorded — how the flight recorder collects per-request
        trees without the tracer knowing about it. Untraced spans skip the
        sinks entirely, keeping the training hot path unchanged."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[SpanRecord], None]) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            if (
                self._spans.maxlen is not None
                and len(self._spans) == self._spans.maxlen
            ):
                self.dropped_spans += 1  # ring full: deque sheds the oldest
            self._spans.append(rec)
            sinks = list(self._sinks) if rec.trace_id is not None else ()
        for sink in sinks:
            try:
                sink(rec)
            except Exception:
                pass  # a broken sink must never fail the traced work

    # -- introspection / lifecycle ----------------------------------------

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        """New run: drop finished spans and restart the epoch. Open spans
        on other threads finish into the new run (they cannot be
        retroactively unwound); drivers reset at entry, before any spans
        open."""
        with self._lock:
            self._spans.clear()
            self.dropped_spans = 0
            self._epoch = time.monotonic()
            self.epoch_unix_s = time.time()


class FlightRecorder:
    """Tail-based keeper of full span trees for the requests worth looking
    at: slow (above this recorder's own streaming p99), errored, degraded
    (FE-only / breaker-open / pin-fallback), or client-forced.

    Registered as a tracer sink, it buffers traced spans per trace id in a
    bounded open table; ``finish(trace_id, ...)`` closes a request and
    decides keep vs. discard. Kept trees land in a bounded ring dumped by
    ``/v1/traces``. Everything is host-side dict/list work — no device
    interaction, so the sync-free dispatch rule holds with the recorder on.
    """

    DEFAULT_CAPACITY = int(os.environ.get("PHOTON_TPU_FLIGHT_CAPACITY", 128))
    MAX_SPANS_PER_TRACE = 512
    P99_REFRESH_EVERY = 32

    def __init__(
        self,
        capacity: Optional[int] = None,
        open_cap: int = 2048,
        min_latency_samples: int = 100,
    ):
        self._lock = threading.Lock()
        self.capacity = self.DEFAULT_CAPACITY if capacity is None else capacity
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self._open: "OrderedDict[str, List[SpanRecord]]" = OrderedDict()
        self.open_cap = open_cap
        self.min_latency_samples = min_latency_samples
        self._lat = Histogram("flight_latency_s", _label_key({}))
        self._p99_cache: Optional[float] = None
        self._since_refresh = 0
        self.kept_total = 0
        self.discarded_total = 0
        self.open_evicted_total = 0
        self.span_overflow_total = 0
        self.ring_dropped_total = 0
        self.keep_all = os.environ.get("PHOTON_TPU_TRACE_KEEP_ALL") == "1"

    # -- tracer sink -------------------------------------------------------

    def on_span(self, rec: SpanRecord) -> None:
        tid = rec.trace_id
        if tid is None:
            return
        with self._lock:
            buf = self._open.get(tid)
            if buf is None:
                if len(self._open) >= self.open_cap:
                    # A trace whose finish() never came (caller died):
                    # evict the oldest wholesale rather than grow forever.
                    self._open.popitem(last=False)
                    self.open_evicted_total += 1
                buf = self._open[tid] = []
            if len(buf) >= self.MAX_SPANS_PER_TRACE:
                self.span_overflow_total += 1
                return
            buf.append(rec)

    # -- request completion ------------------------------------------------

    def _slow_threshold(self) -> Optional[float]:
        if self._lat.count < self.min_latency_samples:
            return None
        self._since_refresh += 1
        if self._p99_cache is None or (
            self._since_refresh >= self.P99_REFRESH_EVERY
        ):
            self._since_refresh = 0
            self._p99_cache = self._lat.percentiles((0.99,))["p99"]
        return self._p99_cache

    def finish(
        self,
        trace_id: str,
        latency_s: Optional[float] = None,
        error: Optional[str] = None,
        degraded: bool = False,
        forced: bool = False,
        meta: Optional[dict] = None,
    ) -> Optional[str]:
        """Close one request's trace: returns the keep reason
        (``forced/error/degraded/slow``) or None if discarded. The slow
        threshold is this recorder's own p99 so it self-calibrates to the
        workload without a config knob."""
        with self._lock:
            spans = self._open.pop(trace_id, [])
        threshold = None
        if latency_s is not None:
            threshold = self._slow_threshold()
            self._lat.observe(latency_s)
        reason = None
        if forced or self.keep_all:
            reason = "forced"
        elif error is not None:
            reason = "error"
        elif degraded:
            reason = "degraded"
        elif (
            latency_s is not None
            and threshold is not None
            and latency_s > threshold
        ):
            reason = "slow"
        if reason is None:
            with self._lock:
                self.discarded_total += 1
            return None
        entry = dict(
            traceId=trace_id,
            reason=reason,
            latencySeconds=latency_s,
            error=error,
            degraded=bool(degraded),
            pid=os.getpid(),
            unixTs=time.time(),
            meta=meta or {},
            spans=[s.as_trace_dict() for s in spans],
        )
        with self._lock:
            # The ring sheds its OLDEST kept tree when full; count the
            # shed so sustained forced-keep traffic (every tree kept) is
            # visible as overflow instead of silently rotating away.
            if (
                self._ring.maxlen is not None
                and len(self._ring) >= self._ring.maxlen
            ):
                self.ring_dropped_total += 1
            self._ring.append(entry)
            self.kept_total += 1
        return reason

    # -- introspection / lifecycle ----------------------------------------

    def traces(self, limit: Optional[int] = None) -> List[dict]:
        """Kept trees, oldest first (the ring order); ``limit`` keeps the
        NEWEST n."""
        with self._lock:
            out = list(self._ring)
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def stats(self) -> dict:
        with self._lock:
            return dict(
                kept=self.kept_total,
                discarded=self.discarded_total,
                open=len(self._open),
                open_evicted=self.open_evicted_total,
                span_overflow=self.span_overflow_total,
                ring_dropped=self.ring_dropped_total,
                capacity=self.capacity,
                latency_samples=self._lat.count,
                slow_threshold_s=self._p99_cache,
            )

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self.kept_total = 0
            self.discarded_total = 0
            self.open_evicted_total = 0
            self.span_overflow_total = 0
            self.ring_dropped_total = 0
            self._lat = Histogram("flight_latency_s", _label_key({}))
            self._p99_cache = None
            self._since_refresh = 0


def merge_trace_dumps(entries: List[dict]) -> List[dict]:
    """Merge flight-recorder dump entries from MULTIPLE processes into one
    entry per trace id: each hop's process kept its own spans for the same
    request, and the fleet ``/v1/traces`` answer should read as one tree.
    Spans concatenate (deduped by span id), ``pids`` is the sorted set of
    processes that contributed, latency is the max observed hop latency,
    and the first entry seen supplies the keep reason. Order of first
    appearance is preserved."""
    by_id: "OrderedDict[str, dict]" = OrderedDict()
    for e in entries:
        tid = e.get("traceId")
        if tid is None:
            continue
        cur = by_id.get(tid)
        if cur is None:
            cur = by_id[tid] = dict(e)
            cur["spans"] = list(e.get("spans") or [])
        else:
            cur["spans"].extend(e.get("spans") or [])
            if cur.get("error") is None and e.get("error") is not None:
                cur["error"] = e.get("error")
            cur["degraded"] = bool(cur.get("degraded")) or bool(
                e.get("degraded")
            )
            lats = [
                v
                for v in (cur.get("latencySeconds"), e.get("latencySeconds"))
                if v is not None
            ]
            cur["latencySeconds"] = max(lats) if lats else None
    out = []
    for cur in by_id.values():
        seen = set()
        spans = []
        for s in cur["spans"]:
            sid = s.get("spanId")
            if sid is not None:
                if sid in seen:
                    continue
                seen.add(sid)
            spans.append(s)
        cur["spans"] = spans
        cur["pids"] = sorted(
            {s.get("pid") for s in spans if s.get("pid") is not None}
        )
        out.append(cur)
    return out


_TRACER = Tracer()
_FLIGHT = FlightRecorder()
_TRACER.add_sink(_FLIGHT.on_span)


def tracer() -> Tracer:
    """The process-global tracer every subsystem records into."""
    return _TRACER


def flight_recorder() -> FlightRecorder:
    """The process-global tail-based recorder behind ``/v1/traces``."""
    return _FLIGHT


@contextmanager
def span(
    name: str,
    parent: Optional[str] = None,
    context: Optional[TraceContext] = None,
) -> Iterator[str]:
    with _TRACER.span(name, parent=parent, context=context) as path:
        yield path


def record_span(
    name: str,
    duration_s: float,
    parent: Optional[str] = None,
    start_s: Optional[float] = None,
    context: Optional[TraceContext] = None,
    span_id: Optional[str] = None,
) -> SpanRecord:
    return _TRACER.record(
        name, duration_s, parent=parent, start_s=start_s,
        context=context, span_id=span_id,
    )


def current_span_path() -> Optional[str]:
    return _TRACER.current_path()


def attach_context(ctx: Optional[TraceContext]):
    return _TRACER.attach_context(ctx)


def extract_context() -> Optional[TraceContext]:
    return _TRACER.current_context()


def get_spans() -> List[SpanRecord]:
    return _TRACER.spans()


def reset_tracer() -> None:
    _TRACER.reset()


def reset_flight_recorder() -> None:
    _FLIGHT.reset()
