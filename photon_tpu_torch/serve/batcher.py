"""Bounded micro-batching queue for online GAME scoring (port of
photon_tpu/serve/batcher.py; host code, with its metrics and spans;
``MicroBatcher.stats()`` also carries the counts).

The serving engine's admission layer, shaped by the hierarchical-batching
lesson of Snap ML (PAPERS.md) and this repo's single-compile dispatch
discipline: requests queue on their caller threads, one flusher thread
drains them into micro-batches that flush on MAX-BATCH-SIZE or DEADLINE
(whichever first), and every batch's row count pads UP the shared
``bucket_dim`` shape grid (data/padding.py) so the scorer replays one of a
handful of CUDA graphs captured at warm-up — no capture after warm-up.

Load shedding is explicit, not implicit: when queue depth would exceed
``queue_cap``, ``submit`` raises :class:`BackpressureError` on the CALLER's
thread immediately (counted as ``shed`` in ``stats()``) instead of
letting latency collapse for everyone already queued. Per-request deadlines
are honored at flush time: a request whose deadline passed while queued
fails with :class:`DeadlineExceededError` without spending scorer time.

Threading contract: ``submit`` is thread-safe (any number of front-end
threads); scoring runs ONLY on the flusher thread via the ``score_fn``
callback, which therefore needs no internal locking against other batches.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.obs.trace import tracer
from photon_tpu_torch.utils import resources


class BackpressureError(RuntimeError):
    """Queue depth exceeded the cap — the caller should back off/retry.
    Raised at submit time so shed cost is one exception, not a queued
    request that times out later."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before its batch reached the scorer."""


@dataclasses.dataclass
class ScoreRequest:
    """One scoring request. ``features`` maps feature-shard name → a dense
    (d,) float vector, a {column: value} dict, or an (indices, values)
    pair — the batcher densifies rows host-side (serving shards are the
    model's own dims). ``entity_ids`` maps RE type → interned int or raw
    string id (resolved through the store's EntityIndex)."""

    features: Dict[str, object]
    entity_ids: Dict[str, object] = dataclasses.field(default_factory=dict)
    offset: float = 0.0
    uid: Optional[object] = None
    # Version pin: None scores on the engine's primary generation; a set
    # value is resolved (exact key or basename) against the resident
    # versions at submit time — unknown pins raise there, on the caller's
    # thread, never inside a batch. After scoring the engine overwrites
    # this with the generation that ACTUALLY produced the score (the
    # primary for unpinned requests, or on a pin-evicted fallback), so
    # response labels are always truthful.
    model_version: Optional[str] = None
    # Set by ServingEngine.submit from its ``tenant`` argument: rides along
    # so the feedback spool can apply per-tenant sampling fractions.
    tenant: Optional[str] = None
    # Cross-process trace context (TraceContext.to_dict() shape), stamped
    # by whichever frontend admitted the request: the engine hands it to
    # downstream hops (fleet replicas) and to the feedback spool so a
    # micro-generation can name the requests that fed it.
    trace: Optional[dict] = None
    # Set by the engine when this request's score was produced under a
    # degraded path (breaker-open FE-only resolve, pin-eviction fallback):
    # the flight recorder keeps such requests' span trees.
    degraded: bool = False


@dataclasses.dataclass
class _Pending:
    request: ScoreRequest
    future: Future
    enqueue_t: float
    deadline_t: Optional[float]
    priority: str = "interactive"


class MicroBatcher:
    """Flush-on-size-or-deadline micro-batcher with bounded admission.

    ``score_fn(requests) -> sequence of float scores`` runs on the flusher
    thread; its exceptions fail that batch's futures only — the batcher
    keeps serving subsequent batches.
    """

    def __init__(
        self,
        score_fn: Callable[[List[ScoreRequest]], Sequence[float]],
        max_batch_size: int = 64,
        max_delay_s: float = 0.002,
        queue_cap: int = 1024,
        name: str = "serve",
    ):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._score_fn = score_fn
        self.max_batch_size = int(max_batch_size)
        self.max_delay_s = float(max_delay_s)
        self.queue_cap = int(queue_cap)
        self.name = name
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._in_flight = 0
        self._counts: Dict[str, float] = dict(requests=0, shed=0, preempted=0, deadline_missed=0, batches=0,
                                              rows=0, max_queue_wait_s=0.0, max_latency_s=0.0)
        self._last_fill = 0.0
        self._thread = threading.Thread(
            target=self._flush_loop, name=f"photon-{name}-flush", daemon=True
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def submit(
        self,
        request: ScoreRequest,
        deadline_s: Optional[float] = None,
        priority: str = "interactive",
    ) -> Future:
        """Enqueue one request; returns a Future resolving to its float
        score. ``deadline_s`` is a relative budget (seconds from now)
        covering queue wait + scoring. ``priority`` is the admission class:
        when the queue is at cap, an interactive submit PREEMPTS the
        newest queued batch-class request (which fails with
        ``BackpressureError``) instead of being shed itself — bulk
        backfill yields capacity to latency-sensitive traffic."""
        reg = registry()
        now = time.monotonic()
        fut: Future = Future()
        victim: Optional[_Pending] = None
        # Host memory pressure tightens the admission cap (half at soft,
        # quarter at hard): each queued request pins host buffers, and
        # shedding by backpressure beats dying by OOM-killer.
        cap = resources.tightened_cap(self.queue_cap)
        with self._cond:
            if self._closed:
                raise RuntimeError(f"batcher {self.name!r} is closed")
            if len(self._pending) >= cap:
                if priority != "batch":
                    for i in range(len(self._pending) - 1, -1, -1):
                        if self._pending[i].priority == "batch":
                            victim = self._pending[i]
                            del self._pending[i]
                            self._counts["preempted"] += 1
                            reg.counter("serve_requests_preempted_total").inc()
                            break
                if victim is None:
                    self._counts["shed"] += 1
                    reg.counter("serve_requests_shed_total").inc()
                    raise BackpressureError(
                        f"serve queue depth {len(self._pending)} at cap "
                        f"{cap}; request shed"
                    )
            self._pending.append(
                _Pending(
                    request,
                    fut,
                    now,
                    None if deadline_s is None else now + float(deadline_s),
                    priority,
                )
            )
            self._counts["requests"] += 1
            reg.counter("serve_requests_total").inc()
            self._cond.notify_all()
        if victim is not None:
            # Outside the lock: done-callbacks run inline on set_exception.
            victim.future.set_exception(
                BackpressureError(
                    "batch-class request preempted by interactive traffic "
                    "at full queue; retry with backoff"
                )
            )
        return fut

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- flusher -----------------------------------------------------------

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait(0.1)
                if self._closed and not self._pending:
                    return
                # Fill-or-deadline: wait for a full batch, but never hold
                # the oldest request past max_delay.
                while (
                    len(self._pending) < self.max_batch_size
                    and not self._closed
                ):
                    remaining = self.max_delay_s - (
                        time.monotonic() - self._pending[0].enqueue_t
                    )
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = [
                    self._pending.popleft()
                    for _ in range(
                        min(len(self._pending), self.max_batch_size)
                    )
                ]
                self._in_flight = len(batch)
            try:
                self._run_batch(batch)
            finally:
                with self._cond:
                    self._in_flight = 0
                    self._cond.notify_all()

    def _run_batch(self, batch: List[_Pending]) -> None:
        reg = registry()
        now = time.monotonic()
        live: List[_Pending] = []
        for p in batch:
            if p.deadline_t is not None and now > p.deadline_t:
                with self._lock:
                    self._counts["deadline_missed"] += 1
                reg.counter("serve_deadline_missed_total").inc()
                p.future.set_exception(
                    DeadlineExceededError(
                        f"deadline passed {now - p.deadline_t:.4f}s before "
                        "scoring"
                    )
                )
            else:
                live.append(p)
        if not live:
            return
        wait = max(now - p.enqueue_t for p in live)
        with tracer().span(f"{self.name}/batch"):
            for p in live:
                reg.histogram("serve_queue_wait_s").observe(now - p.enqueue_t)
            try:
                scores = self._score_fn([p.request for p in live])
            except BaseException as exc:  # noqa: BLE001 — fail THIS batch only
                for p in live:
                    if not p.future.done():
                        p.future.set_exception(exc)
                return
            with tracer().span("respond"):
                done_t = time.monotonic()
                for p, s in zip(live, scores):
                    reg.histogram("serve_request_latency_s").observe(done_t - p.enqueue_t)
                    p.future.set_result(float(s))
        reg.histogram("serve_batch_rows").observe(len(live))
        reg.counter("serve_batches_total").inc()
        reg.gauge("serve_batch_fill").set(len(live) / self.max_batch_size)
        with self._lock:
            c = self._counts
            c["batches"] += 1
            c["rows"] += len(live)
            c["max_queue_wait_s"] = max(c["max_queue_wait_s"], wait)
            c["max_latency_s"] = max(c["max_latency_s"], max(done_t - p.enqueue_t for p in live))
            self._last_fill = len(live) / self.max_batch_size

    def stats(self) -> Dict[str, float]:
        """Requests admitted, shed, preempted and past their deadline;
        batches and rows scored; the longest queue wait and latency; the
        last batch's fill."""
        with self._lock:
            return dict(self._counts, last_batch_fill=self._last_fill, queue_depth=len(self._pending))

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until the queue is empty and no batch is in flight."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._pending or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def close(self, drain: bool = True) -> None:
        """Stop accepting requests; by default score out what's queued."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                while self._pending:
                    p = self._pending.popleft()
                    p.future.set_exception(
                        RuntimeError(f"batcher {self.name!r} closed")
                    )
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
