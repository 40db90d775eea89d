"""Copy of photon_tpu/obs/slo.py (framework-free; the port does not import it).

SLO plane: availability, latency, and freshness objectives with
multi-window burn-rate alerting state.

An SLO here is a RATIO objective over discrete events: each event is good
or bad (request succeeded; latency under the bar; model staleness under
the bar), and the objective says what fraction must be good
(``target``, e.g. 0.999). The error budget is ``1 - target``; the burn
rate over a window is ``bad_fraction / budget`` — 1.0 means "spending the
budget exactly as fast as the SLO allows", 14.4 means "the whole 30-day
budget would be gone in ~2 days".

Alerting state follows the standard multiwindow-multi-burn-rate scheme
(Google SRE workbook): PAGE when the burn exceeds a high threshold over
BOTH a long and a short window (the short window makes the alert reset
fast once the bleeding stops), WARN on a lower threshold over slower
windows. The thresholds/windows are constructor knobs so the CI drill can
run the state machine in seconds with an injected clock.

Events land in a time-bucketed ring (fixed bucket width, horizon = the
longest window), so memory is bounded and recording is O(1). Everything is
host-side integer math — safe to call from serve completion callbacks
without violating the sync-free dispatch rule.

``SLOTracker.snapshot()`` is the ``/healthz`` block; ``publish_metrics()``
mirrors burn rates and numeric states into the metrics registry so the
``/metrics`` scrape carries them fleet-wide.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from photon_tpu_torch.obs.metrics import MetricsRegistry, registry

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_PAGE = "page"
STATE_LEVEL = {STATE_OK: 0, STATE_WARN: 1, STATE_PAGE: 2}

# (long_window_s, short_window_s, burn_threshold) — both windows must
# exceed the threshold for the rule to fire.
DEFAULT_PAGE_RULES: Tuple[Tuple[float, float, float], ...] = (
    (3600.0, 300.0, 14.4),
)
DEFAULT_WARN_RULES: Tuple[Tuple[float, float, float], ...] = (
    (21600.0, 1800.0, 6.0),
)

# Second-scale rules for drills and CI: the same state machine, but with
# windows a test can traverse in wall time — a sustained burn pages in a
# few seconds and CLEARS a few seconds after the bleeding stops (the
# short window is what resets the page).
DRILL_PAGE_RULES: Tuple[Tuple[float, float, float], ...] = (
    (30.0, 5.0, 10.0),
)
DRILL_WARN_RULES: Tuple[Tuple[float, float, float], ...] = (
    (60.0, 10.0, 5.0),
)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One ratio SLO. ``threshold`` is the per-event bar for value-based
    objectives (latency seconds, staleness seconds); None for pure
    success/failure objectives like availability."""

    name: str
    target: float
    threshold: Optional[float] = None
    unit: Optional[str] = None

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


def default_objectives(
    availability_target: float = 0.999,
    latency_threshold_s: float = 0.5,
    latency_target: float = 0.99,
    staleness_threshold_s: float = 120.0,
    staleness_target: float = 0.99,
) -> List[Objective]:
    return [
        Objective("availability", availability_target),
        Objective("latency_p99", latency_target, latency_threshold_s, "s"),
        Objective(
            "model_staleness_s", staleness_target, staleness_threshold_s, "s"
        ),
    ]


def streaming_objectives(
    cycle_target: float = 0.95,
    staleness_threshold_s: float = 120.0,
    staleness_target: float = 0.99,
    fe_age_threshold_s: float = 3600.0,
    fe_age_target: float = 0.95,
) -> List[Objective]:
    """The updater-side SLO plane: micro-generation cycle success ratio
    plus published-model freshness — measurable with NO server running
    (the serve-side staleness objective only ticks at promote time) —
    plus the locked-fixed-effect age objective. Streaming deltas never
    retrain the FE, so its age grows monotonically between full publishes;
    once cycles observe it past the bar the burn machinery turns sustained
    violation into warn/page state, which is what the updater's
    ``stream_fe_retrain_wanted`` trigger keys off."""
    return [
        Objective("update_cycle", cycle_target),
        Objective(
            "model_staleness_s", staleness_target, staleness_threshold_s, "s"
        ),
        Objective("fe_age_s", fe_age_target, fe_age_threshold_s, "s"),
    ]


def quality_objectives(
    auc_target: float = 0.99,
    calibration_target: float = 0.99,
) -> List[Objective]:
    """The model-quality objectives (obs/quality.py): per-event good/bad
    comes from the quality plane — good while the windowed online AUC stays
    within ``auc_drop_bound`` of the frozen baseline's, and while windowed
    ECE stays under ``ece_bound``. No per-event value threshold here: the
    quality plane already applied its bars; these objectives only run the
    multi-window burn machinery, so a paging ``auc_drop`` drives the SAME
    rollout-watcher actuation (abort shadow / rollback / freeze) as any
    operational page."""
    return [
        Objective("auc_drop", auc_target),
        Objective("calibration_drift", calibration_target),
    ]


class _BucketRing:
    """Time-bucketed (good, bad) counts over a bounded horizon. Buckets are
    ``bucket_s`` wide; entries older than the horizon are trimmed on every
    touch, so memory is O(horizon / bucket_s) regardless of event rate."""

    def __init__(self, bucket_s: float, horizon_s: float):
        self.bucket_s = bucket_s
        self.max_buckets = int(math.ceil(horizon_s / bucket_s)) + 1
        self._buckets: List[List[float]] = []  # [bucket_idx, good, bad]

    def add(self, good: bool, now: float) -> None:
        idx = int(now // self.bucket_s)
        if self._buckets and self._buckets[-1][0] == idx:
            slot = self._buckets[-1]
        else:
            slot = [idx, 0, 0]
            self._buckets.append(slot)
            floor = idx - self.max_buckets
            while self._buckets and self._buckets[0][0] <= floor:
                self._buckets.pop(0)
        if good:
            slot[1] += 1
        else:
            slot[2] += 1

    def totals(self, window_s: float, now: float) -> Tuple[int, int]:
        """(good, bad) over the trailing window. Bucket-granular: a bucket
        counts iff it starts inside the window."""
        floor = int((now - window_s) // self.bucket_s)
        good = bad = 0
        for idx, g, b in reversed(self._buckets):
            if idx <= floor:
                break
            good += g
            bad += b
        return int(good), int(bad)


class SLOTracker:
    """Burn-rate state for a set of ratio objectives. One instance lives on
    the serving engine; fleet replicas each run their own (their snapshots
    ride the ``stats`` scrape like every other per-replica block)."""

    def __init__(
        self,
        objectives: Optional[Sequence[Objective]] = None,
        page_rules: Sequence[Tuple[float, float, float]] = DEFAULT_PAGE_RULES,
        warn_rules: Sequence[Tuple[float, float, float]] = DEFAULT_WARN_RULES,
        bucket_s: float = 5.0,
        min_events: int = 10,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.objectives: Dict[str, Objective] = {
            o.name: o for o in (objectives or default_objectives())
        }
        self.page_rules = tuple(page_rules)
        self.warn_rules = tuple(warn_rules)
        self.min_events = min_events
        self._clock = clock
        horizon = max(
            [w for rule in self.page_rules + self.warn_rules for w in rule[:2]]
            or [3600.0]
        )
        self._lock = threading.Lock()
        self._rings: Dict[str, _BucketRing] = {
            name: _BucketRing(bucket_s, horizon) for name in self.objectives
        }
        self._events: Dict[str, int] = {name: 0 for name in self.objectives}

    # -- recording ---------------------------------------------------------

    def record_event(
        self, objective: str, good: bool, now: Optional[float] = None
    ) -> None:
        ring = self._rings.get(objective)
        if ring is None:
            return
        t = self._clock() if now is None else now
        with self._lock:
            ring.add(good, t)
            self._events[objective] += 1

    def record_request(
        self,
        ok: bool,
        latency_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """One serve completion: feeds availability always, the latency
        objective when the request succeeded with a measured latency
        (failed requests shouldn't double-count against latency)."""
        t = self._clock() if now is None else now
        self.record_event("availability", ok, now=t)
        if ok and latency_s is not None:
            obj = self.objectives.get("latency_p99")
            if obj is not None and obj.threshold is not None:
                self.record_event(
                    "latency_p99", latency_s <= obj.threshold, now=t
                )

    def record_staleness(
        self, staleness_s: float, now: Optional[float] = None
    ) -> None:
        obj = self.objectives.get("model_staleness_s")
        if obj is not None and obj.threshold is not None:
            self.record_event(
                "model_staleness_s", staleness_s <= obj.threshold, now=now
            )

    def record_fe_age(
        self, age_s: float, now: Optional[float] = None
    ) -> None:
        """One observation of the locked fixed effect's age — good while
        under the objective's threshold. Observed once per update cycle,
        so the multi-window burn state reflects SUSTAINED staleness, not a
        single slow full retrain."""
        obj = self.objectives.get("fe_age_s")
        if obj is not None and obj.threshold is not None:
            self.record_event("fe_age_s", age_s <= obj.threshold, now=now)

    # -- burn / state ------------------------------------------------------

    def _burn(self, objective: str, window_s: float, now: float) -> Optional[float]:
        obj = self.objectives[objective]
        with self._lock:
            good, bad = self._rings[objective].totals(window_s, now)
        total = good + bad
        if total == 0:
            return None
        return (bad / total) / obj.budget

    def burn_rates(
        self, objective: str, now: Optional[float] = None
    ) -> Dict[str, Optional[float]]:
        t = self._clock() if now is None else now
        windows = sorted(
            {w for rule in self.page_rules + self.warn_rules for w in rule[:2]}
        )
        return {
            _window_name(w): self._burn(objective, w, t) for w in windows
        }

    def state(self, objective: str, now: Optional[float] = None) -> str:
        """Multiwindow-multi-burn evaluation for one objective. With fewer
        than ``min_events`` in the long window the state is ``ok`` — an
        idle service is not in violation."""
        t = self._clock() if now is None else now
        with self._lock:
            ring = self._rings[objective]
            horizon_events = sum(
                g + b
                for _, g, b in ring._buckets  # noqa: SLF001 — same module
            )
        if horizon_events < self.min_events:
            return STATE_OK
        for long_w, short_w, threshold in self.page_rules:
            bl = self._burn(objective, long_w, t)
            bs = self._burn(objective, short_w, t)
            if bl is not None and bs is not None and bl > threshold and bs > threshold:
                return STATE_PAGE
        for long_w, short_w, threshold in self.warn_rules:
            bl = self._burn(objective, long_w, t)
            bs = self._burn(objective, short_w, t)
            if bl is not None and bs is not None and bl > threshold and bs > threshold:
                return STATE_WARN
        return STATE_OK

    # -- surfaces ----------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The ``/healthz`` block: per objective target/threshold, burn per
        window, state; plus the worst state overall."""
        t = self._clock() if now is None else now
        out: dict = {"objectives": {}, "state": STATE_OK}
        worst = STATE_OK
        for name, obj in self.objectives.items():
            state = self.state(name, now=t)
            if STATE_LEVEL[state] > STATE_LEVEL[worst]:
                worst = state
            out["objectives"][name] = dict(
                target=obj.target,
                threshold=obj.threshold,
                unit=obj.unit,
                events=self._events[name],
                burn=self.burn_rates(name, now=t),
                state=state,
            )
        out["state"] = worst
        return out

    def publish_metrics(
        self,
        reg: Optional[MetricsRegistry] = None,
        now: Optional[float] = None,
    ) -> None:
        """Mirror burn + state into gauges (``slo_burn_rate{objective,
        window}``, ``slo_state{objective}`` as 0/1/2) so the fleet
        ``/metrics`` scrape carries SLO posture without parsing healthz."""
        reg = reg or registry()
        t = self._clock() if now is None else now
        for name in self.objectives:
            for window, burn in self.burn_rates(name, now=t).items():
                if burn is not None:
                    reg.gauge(
                        "slo_burn_rate", objective=name, window=window
                    ).set(burn)
            reg.gauge("slo_state", objective=name).set(
                STATE_LEVEL[self.state(name, now=t)]
            )


def _window_name(window_s: float) -> str:
    if window_s % 3600 == 0:
        return f"{int(window_s // 3600)}h"
    if window_s % 60 == 0:
        return f"{int(window_s // 60)}m"
    return f"{int(window_s)}s"
