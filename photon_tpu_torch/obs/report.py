"""Port of photon_tpu/obs/report.py: the schema and ``validate_record`` are the
reference's, unchanged, so each package reads the other's report. The
environment record reads torch (``jax_backend`` keeps its name and holds
the platform JAX would name for the same device: ``gpu`` or ``cpu``), and
the solve-cache block reads the port's ``SolveCacheStats``.

Run-report finalizer: one schema-stable JSONL artifact per run.

Role parity: the reference GAME driver's single structured optimization
log per run (photon-client event/Event.scala PhotonOptimizationLogEvent) —
here generalized to the whole telemetry surface: trace spans (obs/trace),
registry metrics (obs/metrics), phase timers (utils/timed), the
coordinate-descent tracker, and the environment, serialized as one JSONL
file behind ``--telemetry-out`` on every CLI driver and emitted through
``EventEmitter`` as a ``PhotonOptimizationLogEvent`` payload.

Sync discipline: this module is the ONE place device-resident diagnostics
(RandomEffectTrackerStats arrays, OptimizeResult scalars) are read — once,
at finalize, after training finished. Nothing here runs inside the
dispatch hot loop, so ``CoordinateDescent.run(profile=False)`` stays
sync-free end to end with telemetry fully enabled.

Every line validates against :data:`TELEMETRY_SCHEMA` (checked in; tests
and the ci.sh telemetry smoke stage both enforce it), and every line
passes through ``sanitize_for_json`` so no NaN/Inf token ever reaches a
strict JSON parser.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
from typing import Any, Dict, List, Optional

from photon_tpu_torch.utils import resources

# v2 (2026-08): histogram ``stats`` gained p50/p95/p99 keys (bounded
# deterministic reservoir, obs/metrics.py). Backward compatible for readers:
# ``stats`` was already typed as an open dict, no field was removed or
# renamed — v1 readers keep parsing v2 artifacts; only readers that REQUIRE
# percentiles need to check schema_version >= 2.
SCHEMA_VERSION = 2

_NONE = type(None)

# record type -> {field: allowed python types}. Exactly these fields, no
# more, no fewer — "schema-stable" means a reader written against this
# dict keeps parsing every future run at the same schema_version.
TELEMETRY_SCHEMA: Dict[str, Dict[str, tuple]] = {
    "meta": {
        "record": (str,),
        "schema_version": (int,),
        "run_id": (str,),
        "driver": (str,),
        "created_unix_s": (int, float),
    },
    "env": {
        "record": (str,),
        "jax_backend": (str,),
        "device_count": (int,),
        "process_index": (int,),
        "python": (str,),
        "env": (dict,),
    },
    "span": {
        "record": (str,),
        "name": (str,),
        "parent": (str, _NONE),
        "start_s": (int, float),
        "duration_s": (int, float),
        "thread": (str,),
    },
    "phase": {
        "record": (str,),
        "name": (str,),
        "duration_s": (int, float),
    },
    "metric": {
        "record": (str,),
        "metric": (str,),
        "type": (str,),
        "labels": (dict,),
        "value": (int, float, _NONE),
        "stats": (dict, _NONE),
    },
    "coordinate_descent": {
        "record": (str,),
        "label": (str,),
        "coordinate": (str,),
        "cd_iteration": (int,),
        "wall_s": (int, float, _NONE),
        "diagnostics": (dict,),
    },
}


def validate_record(rec: Any) -> None:
    """Raise ValueError unless ``rec`` is exactly one schema record."""
    if not isinstance(rec, dict):
        raise ValueError(f"telemetry record must be a dict, got {type(rec)}")
    kind = rec.get("record")
    fields = TELEMETRY_SCHEMA.get(kind)
    if fields is None:
        raise ValueError(f"unknown telemetry record type {kind!r}")
    missing = set(fields) - set(rec)
    extra = set(rec) - set(fields)
    if missing or extra:
        raise ValueError(
            f"{kind} record fields mismatch: missing={sorted(missing)} "
            f"extra={sorted(extra)}"
        )
    for field, types in fields.items():
        v = rec[field]
        if not isinstance(v, types) or (
            # bool is an int subclass; only "record"-typed str fields and
            # genuine numerics are allowed, never a stray bool-as-int.
            isinstance(v, bool) and bool not in types
        ):
            raise ValueError(
                f"{kind}.{field}: {type(v).__name__} not in "
                f"{tuple(t.__name__ for t in types)}"
            )


def _diagnostics_dict(diag: Any) -> Dict[str, Any]:
    """Serialize one tracker diagnostic — the single finalize-time read of
    device-resident stats. Objects expose ``diagnostics_dict()``
    (RandomEffectTrackerStats, OptimizeResult); anything else degrades to
    its repr so a new coordinate type never breaks report writing."""
    fn = getattr(diag, "diagnostics_dict", None)
    if fn is not None:
        return fn()
    return {"repr": repr(diag)}


def _publish_solve_cache(reg) -> None:
    """Snapshot the shared solve cache into the registry: the reference's
    traces/calls/hits/evictions/entries gauges and per-trace-key trace
    counts, plus the port's captures, replays, eager calls, copied bytes and
    X passes (``SolveCacheStats``)."""
    from photon_tpu_torch.algorithm.solve_cache import default_cache

    cache = default_cache()
    stats = cache.stats
    reg.gauge("solve_cache_traces").set(stats.traces)
    reg.gauge("solve_cache_calls").set(stats.calls)
    reg.gauge("solve_cache_hits").set(stats.hits)
    reg.gauge("solve_cache_evictions").set(stats.evictions)
    reg.gauge("solve_cache_entries").set(cache.num_entries)
    for name in ("captures", "replays", "eager_calls", "copied_bytes",
                 "x_passes_run"):
        reg.gauge(f"solve_cache_{name}").set(getattr(stats, name))
    per_key: Dict[str, int] = {}
    for key in stats.trace_keys:
        k = "/".join(str(p) for p in key)
        per_key[k] = per_key.get(k, 0) + 1
    for k, n in per_key.items():
        reg.gauge("solve_cache_traces_by_key", key=k).set(n)


def _publish_tracker(reg, label: str, tracker: Dict[str, list]) -> None:
    """Optimizer outcomes → registry (iters histogram + convergence-reason
    counters), from the finalize-time diagnostics (``tracker`` holds each
    diagnostic's dict, read once)."""
    for cid, diags in tracker.items():
        for d in diags:
            if d.get("type") == "fixed_effect":
                reg.histogram(
                    "optimizer_iterations", coordinate=cid, label=label
                ).observe(d["iterations"])
                reg.counter(
                    "optimizer_convergence_total",
                    coordinate=cid, reason=d["reason"], label=label,
                ).inc()
            elif d.get("type") == "random_effect":
                reg.counter(
                    "re_entities_trained_total", coordinate=cid, label=label
                ).inc(d["entities"])
                reg.counter(
                    "re_entities_converged_total", coordinate=cid, label=label
                ).inc(d["converged"])
                reg.histogram(
                    "re_mean_iterations", coordinate=cid, label=label
                ).observe(d["mean_iterations"])


def environment_record() -> Dict[str, Any]:
    import torch

    cuda = torch.cuda.is_available()
    rank = 0
    dist = getattr(torch, "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        rank = int(dist.get_rank())
    return dict(
        record="env",
        jax_backend="gpu" if cuda else "cpu",
        device_count=int(torch.cuda.device_count()) if cuda else 1,
        process_index=rank,
        python=sys.version.split()[0],
        env={k: v for k, v in sorted(os.environ.items())
             if k.startswith(("PHOTON_TPU_", "JAX_PLATFORMS"))},
    )


def collect_run_records(
    driver: str,
    run_id: Optional[str] = None,
    trackers: Optional[List[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """Assemble the full record list: meta, env, phases, spans, metrics,
    coordinate-descent tracker rows. ``trackers`` entries are
    ``{"label", "tracker", "wall_times"}`` (one per trained config)."""
    from photon_tpu_torch.evaluation.metrics_map import sanitize_for_json
    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.obs.trace import get_spans, tracer
    from photon_tpu_torch.utils.timed import Timed

    reg = registry()
    _publish_solve_cache(reg)

    records: List[Dict[str, Any]] = [
        dict(
            record="meta",
            schema_version=SCHEMA_VERSION,
            run_id=run_id or f"{driver}-{os.getpid()}",
            driver=driver,
            created_unix_s=tracer().epoch_unix_s,
        ),
        environment_record(),
    ]
    with Timed.records_lock():
        phases = dict(Timed.records)
    records.extend(
        dict(record="phase", name=name, duration_s=round(dur, 6))
        for name, dur in sorted(phases.items())
    )
    records.extend(s.as_dict() for s in get_spans())
    for entry in trackers or []:
        label = str(entry.get("label", ""))
        # The one read of each device-resident diagnostic.
        tracker = {cid: [_diagnostics_dict(d) for d in diags] for cid, diags in (entry.get("tracker") or {}).items()}
        wall_times = entry.get("wall_times") or {}
        _publish_tracker(reg, label, tracker)
        for cid, diags in tracker.items():
            walls = wall_times.get(cid, [])
            for i, diag in enumerate(diags):
                records.append(
                    dict(
                        record="coordinate_descent",
                        label=label,
                        coordinate=cid,
                        cd_iteration=i,
                        wall_s=round(walls[i], 6) if i < len(walls) else None,
                        diagnostics=diag,
                    )
                )
    # Metrics last: tracker publication above lands in this snapshot.
    records.extend(reg.snapshot())
    records = [sanitize_for_json(r) for r in records]
    for rec in records:
        validate_record(rec)
    return records


_write_lock = threading.Lock()

# Budget enforcement drops record types in this order (cheapest loss
# first): spans are per-operation and unbounded under load, CD rows are
# per-iteration, phases are per-run. meta/env/metric records NEVER drop —
# they are the summary a size-capped report exists to preserve.
_DROP_ORDER = ("span", "coordinate_descent", "phase")


def _budget_lines(
    lines: List[str], kinds: List[str], max_bytes: int
) -> List[str]:
    """Trim serialized lines to ``max_bytes``, dropping droppable record
    kinds oldest-first. Returns the surviving lines (original order)."""
    total = sum(len(line) for line in lines)
    if total <= max_bytes:
        return lines
    keep = [True] * len(lines)
    dropped = 0
    for kind in _DROP_ORDER:
        if total <= max_bytes:
            break
        for i, k in enumerate(kinds):
            if k == kind and keep[i]:
                keep[i] = False
                total -= len(lines[i])
                dropped += 1
                if total <= max_bytes:
                    break
    if dropped:
        from photon_tpu_torch.obs.metrics import registry

        registry().counter("telemetry_records_dropped_total").inc(dropped)
        logging.getLogger("photon_tpu_torch").warning(
            "run report over its %d-byte budget: dropped %d oldest "
            "span/cd/phase records (summary records always kept)",
            max_bytes, dropped,
        )
    return [line for i, line in enumerate(lines) if keep[i]]


def write_run_report(
    path: str,
    records: List[Dict[str, Any]],
    max_bytes: Optional[int] = None,
) -> None:
    """Serialize records as JSONL (one validated, sanitized object per
    line). Parent directories are created; the write is atomic (tmp +
    rename), so a reader polling mid-soak never sees a torn file.

    ``max_bytes`` (default: ``PHOTON_TPU_TELEMETRY_MAX_BYTES`` env, else
    unbounded) is the rotation budget: the previous report rotates to
    ``<path>.1`` and, if the new snapshot alone exceeds the budget, the
    oldest span records drop first (then coordinate-descent rows, then
    phases) — meta/env/metric summary records are always kept, so a
    long soak degrades telemetry granularity, never observability.

    Telemetry sits at the bottom of the degradation priority: an OSError on
    the final write (disk full at finalize, say) drops the report with a
    warning and a ``telemetry_write_failures_total`` count instead of
    crashing the driver after training already succeeded. The partial tmp
    file is removed either way."""
    global _last_write_error
    if max_bytes is None:
        env = os.environ.get("PHOTON_TPU_TELEMETRY_MAX_BYTES")
        if env:
            max_bytes = int(env)
    guard = resources.DiskBudgetGuard("telemetry.write")
    lines = [json.dumps(rec, sort_keys=True) + "\n" for rec in records]
    with _write_lock:
        tmp = path + ".tmp"
        try:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            if max_bytes is not None and max_bytes > 0:
                kinds = [rec.get("record") for rec in records]
                lines = _budget_lines(lines, kinds, max_bytes)
                if os.path.exists(path):
                    try:
                        os.replace(path, path + ".1")
                    except OSError:
                        pass  # rotation is best-effort; the write is not
            with open(tmp, "w") as f:
                guard.check()  # ``enospc``/error rules for telemetry.write
                f.writelines(lines)
            os.replace(tmp, path)
            try:
                from photon_tpu_torch.obs.metrics import registry

                registry().counter("telemetry_bytes_written_total").inc(
                    sum(len(line) for line in lines)
                )
            except Exception:
                pass
            _last_write_error = None
        except OSError as exc:
            guard.record(exc)
            guard.cleanup(tmp)
            try:
                from photon_tpu_torch.obs.metrics import registry

                registry().counter("telemetry_write_failures_total").inc()
            except Exception:
                pass
            logging.getLogger("photon_tpu_torch").warning(
                "dropping run report %s (%d records): write failed: %s",
                path, len(records), exc,
            )
            _last_write_error = f"{type(exc).__name__}: {exc}"


# Last run-report write failure (None after a successful write): the
# human-readable tail of the sink-health story the counters can't tell.
_last_write_error: Optional[str] = None


def telemetry_sink_health() -> Dict[str, Any]:
    """The ``/healthz`` telemetry-sink block: is the observability data
    itself healthy — bytes landed, records shed under the byte budget,
    write failures, and the most recent write error (telemetry sits at the
    bottom of the degradation priority, so "serving is fine but telemetry
    is dropping" must be visible SOMEWHERE other than the dropped data)."""
    from photon_tpu_torch.obs.metrics import registry

    def _count(name: str) -> float:
        inst = registry().find(name)
        return float(inst.value) if inst is not None else 0.0

    return dict(
        bytes_written=_count("telemetry_bytes_written_total"),
        records_dropped=_count("telemetry_records_dropped_total"),
        write_failures=_count("telemetry_write_failures_total"),
        last_write_error=_last_write_error,
    )


def finalize_run_report(
    driver: str,
    path: Optional[str] = None,
    emitter=None,
    trackers: Optional[List[Dict[str, Any]]] = None,
    run_id: Optional[str] = None,
    max_bytes: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """The driver-exit hook: collect, write (when ``path``), and emit one
    ``PhotonOptimizationLogEvent`` carrying the records (listeners get the
    same payload the file holds)."""
    records = collect_run_records(driver, run_id=run_id, trackers=trackers)
    if path:
        write_run_report(path, records, max_bytes=max_bytes)
    if emitter is not None:
        from photon_tpu_torch.utils.events import optimization_log_event

        emitter.emit(
            optimization_log_event(
                kind="run_telemetry",
                driver=driver,
                path=path,
                num_records=len(records),
                records=records,
            )
        )
    return records
