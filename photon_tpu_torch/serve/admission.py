"""Per-tenant admission control for the serving front end (port of
photon_tpu/serve/admission.py; host code, copied without its metrics: the
snapshot carries the per-tenant counts and latencies they published).

Multi-tenant fairness is a policy problem, not a kernel problem (Snap ML's
lesson, PAPERS.md): a single abusive caller can destroy everyone's p99 long
before the scorer saturates. This module decides — BEFORE a request touches
the micro-batcher — whether a tenant may spend queue capacity, using two
orthogonal mechanisms layered on the existing
:class:`~photon_tpu_torch.serve.batcher.BackpressureError` machinery:

1. **Token-bucket QPS quotas.** Each tenant owns a bucket refilled at
   ``qps`` tokens/s up to ``burst``; an empty bucket sheds the request with
   :class:`QuotaExceededError` (a ``BackpressureError`` subclass, so every
   existing 429 path keeps working unchanged while shed REASONS stay
   distinguishable in metrics).
2. **Priority classes.** ``interactive`` traffic may use the whole queue;
   ``batch`` traffic is admitted only while queue depth is below
   ``batch_queue_fraction`` of the cap, and the batcher may additionally
   preempt queued batch-class requests when an interactive submit finds the
   queue full — bulk backfill never starves latency-sensitive callers.

All state lives in the single scorer process (the front-end workers hold no
quota state), so quotas are globally consistent no matter how many HTTP
workers fan requests in. The clock is injectable for deterministic tests.

Accounting: per tenant, requests by priority, sheds by reason and the
latency of admitted requests, in ``snapshot()`` (the ``/healthz`` block).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

from photon_tpu_torch.serve.batcher import BackpressureError

# Priority classes: plain strings on the wire (HTTP header / JSON field /
# IPC frame) and in the batcher, so no enum crosses process boundaries.
INTERACTIVE = "interactive"
BATCH = "batch"
PRIORITIES = (INTERACTIVE, BATCH)

DEFAULT_TENANT = "default"


class QuotaExceededError(BackpressureError):
    """The tenant exhausted its admission budget. Subclasses
    ``BackpressureError`` so the HTTP layer's existing 429 mapping applies;
    ``reason`` distinguishes quota sheds from capacity sheds in metrics."""

    def __init__(self, message: str, tenant: str, reason: str = "quota"):
        super().__init__(message)
        self.tenant = tenant
        self.reason = reason


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``
    capacity. Monotonic, injectable clock; thread-safe (one lock per
    tenant bucket — admission is cheap, contention is per-tenant)."""

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst, self._tokens + (now - self._last) * self.rate)


def parse_tenant_rates(spec: Optional[str]) -> Dict[str, float]:
    """CLI helper: ``"tenantA=5,tenantB=250"`` → ``{"tenantA": 5.0, ...}``."""
    out: Dict[str, float] = {}
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"tenant rate spec entry {part!r} must look like name=qps"
            )
        name, rate = part.split("=", 1)
        out[name.strip()] = float(rate)
    return out


@dataclasses.dataclass
class AdmissionConfig:
    """Quota policy. ``default_qps=None`` means unknown tenants are
    unlimited (quota-exempt) — quotas then apply only to tenants named in
    ``tenant_qps``. Burst defaults to ``max(qps, 1)`` per tenant."""

    default_qps: Optional[float] = None
    default_burst: Optional[float] = None
    tenant_qps: Dict[str, float] = dataclasses.field(default_factory=dict)
    tenant_burst: Dict[str, float] = dataclasses.field(default_factory=dict)
    batch_queue_fraction: float = 0.5  # batch admitted below this depth

    def enabled(self) -> bool:
        return self.default_qps is not None or bool(self.tenant_qps)


class AdmissionController:
    """Admission decisions + per-tenant accounting for one scorer process.

    ``admit`` raises :class:`QuotaExceededError` (→ HTTP 429) or returns
    None; it never blocks — shedding is an exception on the caller's
    thread, same discipline as the batcher's backpressure."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or AdmissionConfig()
        self._clock = clock
        self._buckets: Dict[str, Optional[TokenBucket]] = {}
        self._lock = threading.Lock()
        self._admitted: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        self._requests: Dict[tuple, int] = {}  # (tenant, priority) -> requests
        self._shed_reasons: Dict[tuple, int] = {}  # (tenant, reason) -> sheds
        self._latency: Dict[str, tuple] = {}  # tenant -> (count, sum s, max s)

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        with self._lock:
            if tenant not in self._buckets:
                cfg = self.config
                rate = cfg.tenant_qps.get(tenant, cfg.default_qps)
                if rate is None:
                    self._buckets[tenant] = None  # quota-exempt
                else:
                    self._buckets[tenant] = TokenBucket(
                        rate,
                        cfg.tenant_burst.get(tenant, cfg.default_burst),
                        clock=self._clock,
                    )
            return self._buckets[tenant]

    def _record_shed(self, tenant: str, reason: str) -> None:
        with self._lock:
            self._shed[tenant] = self._shed.get(tenant, 0) + 1
            key = (tenant, reason)
            self._shed_reasons[key] = self._shed_reasons.get(key, 0) + 1

    def admit(
        self,
        tenant: Optional[str],
        priority: str = INTERACTIVE,
        queue_depth: int = 0,
        queue_cap: int = 0,
    ) -> None:
        """Charge one request against ``tenant``'s budget. Batch-class
        traffic is additionally refused while the queue is already
        ``batch_queue_fraction`` full — that headroom is reserved for
        interactive callers."""
        tenant = tenant or DEFAULT_TENANT
        with self._lock:
            key = (tenant, priority)
            self._requests[key] = self._requests.get(key, 0) + 1
        if (
            priority == BATCH
            and queue_cap > 0
            and queue_depth >= self.config.batch_queue_fraction * queue_cap
        ):
            self._record_shed(tenant, "batch_capacity")
            raise QuotaExceededError(
                f"batch-class request from tenant {tenant!r} shed: queue "
                f"depth {queue_depth} is past the batch admission share "
                f"({self.config.batch_queue_fraction:.0%} of {queue_cap})",
                tenant,
                reason="batch_capacity",
            )
        bucket = self._bucket(tenant)
        if bucket is not None and not bucket.try_acquire():
            self._record_shed(tenant, "quota")
            raise QuotaExceededError(
                f"tenant {tenant!r} exceeded its {bucket.rate:g} qps quota "
                f"(burst {bucket.burst:g}); request shed",
                tenant,
            )
        with self._lock:
            self._admitted[tenant] = self._admitted.get(tenant, 0) + 1

    def observe_latency(
        self,
        tenant: Optional[str],
        latency_s: float,
        trace_id: Optional[str] = None,
    ) -> None:
        # ``trace_id`` is accepted for the reference's signature; spans and
        # exemplars are not ported.
        with self._lock:
            n, total, top = self._latency.get(tenant or DEFAULT_TENANT, (0, 0.0, 0.0))
            self._latency[tenant or DEFAULT_TENANT] = (n + 1, total + latency_s, max(top, latency_s))

    def snapshot(self) -> Dict[str, Dict]:
        """Per-tenant admission state for ``/healthz`` and the soak bench."""
        with self._lock:
            tenants = set(self._admitted) | set(self._shed) | set(self._buckets)
            out = {}
            for t in sorted(tenants):
                bucket = self._buckets.get(t)
                n, total, top = self._latency.get(t, (0, 0.0, 0.0))
                out[t] = dict(
                    admitted=self._admitted.get(t, 0),
                    shed=self._shed.get(t, 0),
                    qps_limit=bucket.rate if bucket is not None else None,
                    burst=bucket.burst if bucket is not None else None,
                    requests={p: c for (tt, p), c in self._requests.items() if tt == t},
                    shed_reasons={r: c for (tt, r), c in self._shed_reasons.items() if tt == t},
                    latency_mean_s=total / n if n else None,
                    latency_max_s=top if n else None,
                )
            return out


def tenant_quality(quality_snapshots) -> Dict[str, Dict]:
    """Reduce QualityPlane snapshots (one per scorer replica) to the
    per-tenant quality keys the admission ledger surfaces: count-weighted
    ``quality_auc`` / ``auc_lift`` across every (model_version, re_type)
    cell the tenant appears in. The frozen-baseline lane is excluded — it
    is the yardstick the lift is measured against, not a tenant's live
    quality."""
    agg: Dict[str, Dict] = {}
    for snap in quality_snapshots:
        if not isinstance(snap, dict):
            continue
        baseline = snap.get("baseline")
        for entry in snap.get("versions") or []:
            if baseline and entry.get("model_version") == baseline:
                continue
            tenant = entry.get("tenant") or DEFAULT_TENANT
            n = int(entry.get("count") or 0)
            if n <= 0:
                continue
            a = agg.setdefault(
                tenant,
                dict(n=0, auc_w=0.0, auc_n=0, lift_w=0.0, lift_n=0),
            )
            a["n"] += n
            auc = entry.get("auc")
            if auc is not None:
                a["auc_w"] += float(auc) * n
                a["auc_n"] += n
            lift = entry.get("auc_lift")
            if lift is not None:
                a["lift_w"] += float(lift) * n
                a["lift_n"] += n
    out: Dict[str, Dict] = {}
    for tenant, a in agg.items():
        rec: Dict = dict(observations=a["n"])
        if a["auc_n"]:
            rec["quality_auc"] = round(a["auc_w"] / a["auc_n"], 6)
        if a["lift_n"]:
            rec["auc_lift"] = round(a["lift_w"] / a["lift_n"], 6)
        out[tenant] = rec
    return out


class FleetAdmissionLedger(AdmissionController):
    """Fleet-global admission: ONE token-bucket ledger for the whole scorer
    fleet, living in the routing front end (single-coordinator model — the
    frontend already sees every request, so the coordinator is free; no
    gossip protocol to converge or partition).

    Replica engines run with admission DISABLED (default unlimited config),
    so a tenant's budget is charged exactly once fleet-wide — an abusive
    tenant is shed identically whether the fleet has 1 replica or 50: the
    fleet's shed counts match single-process admission.

    On top of the inherited quota/priority machinery this ledger tracks
    per-replica in-flight counts (begin/end around each routed request) —
    the router's least-loaded tiebreak for entity-less requests and the
    drain discipline's "replica is idle" signal.
    """

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        super().__init__(config=config, clock=clock)
        self._inflight: Dict[str, int] = {}
        self._quality: Dict[str, Dict] = {}

    def begin(self, replica_id: str) -> None:
        with self._lock:
            self._inflight[replica_id] = self._inflight.get(replica_id, 0) + 1

    def end(self, replica_id: str) -> None:
        with self._lock:
            n = self._inflight.get(replica_id, 0) - 1
            if n <= 0:
                self._inflight.pop(replica_id, None)
            else:
                self._inflight[replica_id] = n

    def inflight(self, replica_id: Optional[str] = None) -> int:
        with self._lock:
            if replica_id is not None:
                return self._inflight.get(replica_id, 0)
            return sum(self._inflight.values())

    def update_quality(self, per_tenant: Optional[Dict[str, Dict]]) -> None:
        """Install the latest per-tenant quality rollup (see
        :func:`tenant_quality`); merged into :meth:`snapshot` so the fleet
        ``/healthz`` tenants block reports admission AND model quality for
        each caller side by side."""
        with self._lock:
            self._quality = {
                str(t): dict(v) for t, v in (per_tenant or {}).items()
            }

    def snapshot(self) -> Dict[str, Dict]:
        out = super().snapshot()
        with self._lock:
            quality = {t: dict(v) for t, v in self._quality.items()}
        for tenant, rec in quality.items():
            out.setdefault(
                tenant,
                dict(admitted=0, shed=0, qps_limit=None, burst=None),
            ).update(rec)
        return out

    def fleet_snapshot(self) -> Dict:
        """Tenant quota state + per-replica in-flight depth for the fleet
        ``/healthz`` block."""
        with self._lock:
            inflight = dict(self._inflight)
        return dict(tenants=self.snapshot(), inflight=inflight)
