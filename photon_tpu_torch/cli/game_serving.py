"""GAME online-serving driver: an HTTP/JSONL front end over the
ServingEngine (port of photon_tpu/cli/game_serving.py).

    python -m photon_tpu_torch.cli.game_serving --model-input-dir DIR [--device cuda|cpu]

The engine runs on ``--device`` (cuda unless the caller asks for the CPU).
Two deployment shapes share one endpoint implementation
(serve/frontend.py): ``--workers 0`` (default), a threaded HTTP server in
this process; ``--workers N``, N spawned HTTP worker processes that accept
and parse on a shared listening socket and relay over a Unix socket to
this process, which alone owns the card.

Endpoints: ``POST /v1/score`` (one request → ``{"score", "modelVersion"}``;
429 on a shed, ``kind`` says which, 504 on a deadline),
``POST /v1/score-batch`` (JSONL in and out, order kept, a per-line error for
a bad line), ``POST /v1/reload`` (``{"modelDir"}``: a zero-downtime swap),
``GET /healthz`` (engine stats). ``X-Tenant``/``X-Priority`` route requests
through token-bucket quotas and priority classes (serve/admission.py),
``X-Model-Version`` pins a resident version.

``--reload-poll-interval`` follows the publish root's ``LATEST`` pointer:
a new generation is loaded (retried with backoff, then poisoned), optionally
shadowed on a sample of traffic and promoted when its divergence stays
under the bound (abandoned and poisoned otherwise), and rolled back after
breaker trips.

With ``--slo-gate`` the watcher follows the engine's SLO burn: a page
aborts a shadow, rolls back a promotion in its settle window and freezes
promotions until the burn clears, each decision a forced trace.
``--telemetry-out`` writes the run report at shutdown (and every
``--telemetry-flush-interval`` seconds, under ``--telemetry-max-mb``);
``--otlp-endpoint`` exports spans and metrics to a collector.

``--feedback-spool`` attaches the streaming feedback spool: scored requests
carrying a ``uid`` wait in its label join, ``POST /v1/feedback`` completes
it, and joined records seal into JSONL segments that ``game_streaming``
consumes. ``GET /v1/experiment`` rolls up the experiments recorded under
the publish root (``game_experiment`` runs them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import threading
import time
from typing import Optional

from photon_tpu_torch.cli.common import (add_device_arg, close_otlp, drop_otlp, install_otlp, resolve_device,
                                         setup_logging)
from photon_tpu_torch.obs import begin_run, finalize_run_report
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.obs.report import collect_run_records, write_run_report
from photon_tpu_torch.obs.trace import flight_recorder, mint_context, record_span
from photon_tpu_torch.serve.admission import AdmissionConfig, parse_tenant_rates
from photon_tpu_torch.serve.batcher import BackpressureError, DeadlineExceededError
from photon_tpu_torch.serve.engine import ServeConfig, ScoreRequest, load_engine
from photon_tpu_torch.serve.frontend import (
    LocalBackend,
    ServingFrontend,
    ServingHTTPServer,
    make_http_handler,
    request_from_json,
)

__all__ = [
    "BackpressureError",
    "DeadlineExceededError",
    "ScoreRequest",
    "build_parser",
    "main",
    "make_handler",
    "resolve_model_dir",
    "run",
]

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("game-serving")
    p.add_argument("--model-input-dir", required=True)
    p.add_argument("--model-artifacts-dir", default=None,
                   help="dir holding index-map-*.json / entity-index-*.json "
                        "(defaults to the parent of the model dir)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8712,
                   help="0 picks an ephemeral port (printed on startup)")
    p.add_argument("--workers", type=int, default=0,
                   help="HTTP worker processes. 0 = in-process threaded "
                        "server (tests/smoke). N>0 spawns N parse/accept "
                        "workers sharing one listen socket, relaying over a "
                        "Unix socket to this device-owning scorer process")
    p.add_argument("--scorer-endpoint", default=None,
                   help="override the worker->scorer relay endpoint: a "
                        "filesystem path (Unix socket, the default: a "
                        "tempdir socket) or tcp://host:port for a "
                        "cross-host scorer. TCP needs an explicit port "
                        "(workers start before the scorer binds) and the "
                        "shared secret in $PHOTON_TPU_FLEET_SECRET — "
                        "never on argv")
    p.add_argument("--max-batch-size", type=int, default=64,
                   help="micro-batch row cap; rounded UP onto the bucket_dim "
                        "shape grid so warm-up covers every dispatch shape")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="max time the oldest queued request waits for the "
                        "batch to fill before flushing anyway")
    p.add_argument("--queue-cap", type=int, default=1024,
                   help="admission bound: submits beyond this depth are shed "
                        "with HTTP 429 (serve_requests_shed_total)")
    p.add_argument("--hot-bytes-mb", type=float, default=64.0,
                   help="device-byte budget for cached random-effect tables "
                        "(hot store; LRU demotion beyond it)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline (queue wait + scoring); "
                        "expired requests fail 504 without scorer time")
    p.add_argument("--tenant-default-qps", type=float, default=None,
                   help="token-bucket QPS quota for tenants not named in "
                        "--tenant-qps (unset = unknown tenants are "
                        "quota-exempt)")
    p.add_argument("--tenant-default-burst", type=float, default=None,
                   help="bucket burst capacity for the default quota")
    p.add_argument("--tenant-qps", default=None,
                   help="per-tenant QPS quotas, e.g. 'abuser=50,partner=500'")
    p.add_argument("--tenant-burst", default=None,
                   help="per-tenant burst capacities, same syntax")
    p.add_argument("--batch-queue-fraction", type=float, default=0.5,
                   help="batch-priority requests are admitted only while "
                        "queue depth is below this fraction of --queue-cap "
                        "(the rest is reserved for interactive traffic)")
    p.add_argument("--telemetry-out", default=None,
                   help="write the unified run report JSONL here on shutdown")
    p.add_argument("--telemetry-flush-interval", type=float, default=0.0,
                   help="seconds between live run-report rewrites during "
                        "serving (0 = only at shutdown)")
    p.add_argument("--telemetry-max-mb", type=float, default=64.0,
                   help="byte budget for the run report: the previous file "
                        "rotates to <path>.1 and span records drop "
                        "oldest-first to fit (0 = unbounded)")
    p.add_argument("--reload-poll-interval", type=float, default=0.0,
                   help="seconds between checks of the model dir for a new "
                        "generation (a LATEST pointer file naming a subdir, "
                        "or a rewritten model-metadata.json); a change "
                        "triggers a zero-downtime reload. 0 disables — "
                        "reloads then happen only via POST /v1/reload")
    p.add_argument("--shadow-fraction", type=float, default=0.0,
                   help="fraction of live primary traffic re-scored on a "
                        "newly detected generation BEFORE it can become "
                        "primary (divergence recorded, responses untouched). "
                        "0 = no shadow phase: new generations promote "
                        "directly, the pre-rollout behavior")
    p.add_argument("--shadow-quota", type=int, default=64,
                   help="shadow-scored requests a candidate must pass "
                        "(divergence under --divergence-bound) before the "
                        "watcher promotes it to primary")
    p.add_argument("--divergence-bound", type=float, default=1e-3,
                   help="max |shadow - primary| score divergence; a "
                        "candidate breaching it is abandoned and poisoned")
    p.add_argument("--promotion-settle", type=float, default=300.0,
                   help="seconds after a promotion before it is considered "
                        "settled: the rollback parent unpins (becomes "
                        "evictable) and breaker-trip rollback monitoring for "
                        "that promotion stops (<= 0 = pin until the next "
                        "promote/rollback)")
    p.add_argument("--breaker-trip-bound", type=int, default=0,
                   help="circuit-breaker trips since promotion that trigger "
                        "automatic rollback to the parent generation "
                        "(0 disables rollback monitoring)")
    p.add_argument("--reload-max-attempts", type=int, default=3,
                   help="reload attempts (with exponential backoff) per "
                        "detected generation before it is marked poisoned "
                        "and skipped for good")
    p.add_argument("--reload-backoff", type=float, default=0.2,
                   help="initial retry backoff seconds for a failed reload")
    p.add_argument("--max-model-versions", type=int, default=2,
                   help="resident model generations (primary + candidates "
                        "pinnable via X-Model-Version)")
    p.add_argument("--feedback-spool", default=None,
                   help="directory for the streaming feedback spool: scored "
                        "requests joined with labels reported via "
                        "POST /v1/feedback land here as sealed JSONL "
                        "segments for photon-tpu-game-streaming to consume "
                        "(unset = feedback disabled)")
    p.add_argument("--feedback-sample-fraction", type=float, default=1.0,
                   help="fraction of scored requests retained for the label "
                        "join (deterministic fractional sampling)")
    p.add_argument("--feedback-tenant-fractions", default=None,
                   help="per-tenant sampling overrides, e.g. 'abuser=0.01,"
                        "partner=1.0'")
    p.add_argument("--feedback-segment-records", type=int, default=256,
                   help="seal a spool segment after this many records")
    p.add_argument("--feedback-segment-age", type=float, default=5.0,
                   help="seal a non-empty spool segment after this many "
                        "seconds (bounds label->consumable latency)")
    p.add_argument("--feedback-join-ttl", type=float, default=300.0,
                   help="seconds a scored request waits for its label before "
                        "the pending join is dropped")
    p.add_argument("--otlp-endpoint", default=None,
                   help="base URL of an OTLP/HTTP collector accepting JSON "
                        "(spans POST to <endpoint>/v1/traces, metrics to "
                        "<endpoint>/v1/metrics). Export is bounded-queue + "
                        "drop-and-count: a dead collector degrades "
                        "observability, never scoring")
    p.add_argument("--otlp-metrics-interval", type=float, default=15.0,
                   help="seconds between registry-snapshot exports to the "
                        "collector (0 = spans only)")
    p.add_argument("--slo-gate", action="store_true",
                   help="subscribe the rollout watcher to SLO burn state: a "
                        "paging burn on availability/latency aborts an "
                        "in-flight shadow, rolls back a promotion still in "
                        "its settle window (candidate poisoned, LATEST "
                        "repointed), and freezes further promotions until "
                        "the burn clears")
    add_device_arg(p)
    p.add_argument("--verbose", action="store_true")
    return p


def resolve_model_dir(model_dir: str) -> str:
    """Follow a ``LATEST`` pointer file when present: its content names the
    current generation (a subdirectory of ``model_dir``, or an absolute
    path). Without one, ``model_dir`` itself is the generation — its
    metadata mtime is the change signal."""
    p = os.path.join(model_dir, "LATEST")
    if os.path.isfile(p):
        try:
            with open(p) as f:
                name = f.read().strip()
        except OSError:
            return model_dir
        if name:
            cand = name if os.path.isabs(name) else os.path.join(model_dir, name)
            if os.path.isdir(cand):
                return cand
    return model_dir


def _model_fingerprint(directory: str):
    from photon_tpu_torch.io.model_io import METADATA_FILE

    try:
        mtime = os.path.getmtime(os.path.join(directory, METADATA_FILE))
    except OSError:
        mtime = None
    return (directory, mtime)


@dataclasses.dataclass
class RolloutOptions:
    """Watcher-side rollout policy. The defaults reproduce the pre-rollout
    watcher: no shadow phase (direct promote on detection), no rollback
    monitoring — plus retry-with-backoff on a failed reload (a transient
    store fault used to permanently skip a good generation)."""

    shadow_fraction: float = 0.0
    shadow_quota: int = 64
    divergence_bound: float = 1e-3
    breaker_trip_bound: int = 0  # 0 = rollback monitoring off
    max_reload_attempts: int = 3
    backoff_s: float = 0.2
    backoff_max_s: float = 5.0
    # SLO actuation (--slo-gate): a paging burn on any objective in
    # slo_objectives aborts shadows, rolls back unsettled promotions and
    # freezes further promotions until the burn clears. Objectives the
    # tracker has no ring for are ignored (the quality objectives wait for
    # the quality plane).
    slo_gate: bool = False
    slo_objectives: tuple = ("availability", "latency_p99", "auc_drop", "calibration_drift")


def _poison(publish_root: str, version: str, reason: str) -> None:
    from photon_tpu_torch.io.model_io import mark_poisoned

    try:
        mark_poisoned(publish_root, version, reason)
    except OSError:
        logger.exception("could not record poisoned generation %r", version)
    registry().counter("serve_generations_poisoned_total").inc()


def _observe_staleness(target: str) -> None:
    """Label-arrival to promotion lag of a streaming generation: its
    manifest records the oldest label it trained on."""
    from photon_tpu_torch.io.model_io import load_generation_manifest

    try:
        manifest = load_generation_manifest(target) or {}
    except (OSError, ValueError):
        return
    ts = (manifest.get("stream") or {}).get("oldestLabelTs")
    if ts is None:
        return
    lag = max(0.0, time.time() - float(ts))
    registry().gauge("model_staleness_s").set(lag)
    registry().histogram("model_staleness_hist_s").observe(lag)


def _try_delta_install(engine, target: str) -> bool:
    """In-place delta apply: when the detected generation is a delta layer
    and its base is already resident, register it via the store-overlay
    path — no disk load of the full model, no store rebuild, no warm-up.
    False means 'not applicable here' (full layer, base not resident, or
    entity growth) and the caller does the full resolved load."""
    from photon_tpu_torch.io.model_io import delta_info, read_delta_rows

    info = delta_info(target)
    if not info or not info.get("base"):
        return False
    try:
        payload = read_delta_rows(
            target, engine._index_maps, engine._entity_indexes
        )
        engine.load_delta_version(payload["base"], payload, target)
        return True
    except Exception as exc:  # noqa: BLE001 — fall back to the full load
        logger.info(
            "in-place delta apply of %s not possible (%s); falling back to "
            "a full resolved load", target, exc,
        )
        return False


def _install_generation(engine, target: str, opts: RolloutOptions,
                        stop: threading.Event, publish_root: str) -> str:
    """Load one detected generation with retry+backoff. Returns 'shadow'
    (resident, mirroring traffic), 'promoted' (direct reload), 'poisoned'
    (attempts exhausted — never tried again), or 'stopped'.

    A delta micro-generation whose base is resident applies IN PLACE
    (per-entity row overlay onto the base's store — sub-second, no
    warm-up); anything else takes the full load of the RESOLVED model, so
    a delta chain loads correctly even on a cold start."""
    from photon_tpu_torch.io.model_io import load_resolved_game_model

    delay = opts.backoff_s
    attempts = max(int(opts.max_reload_attempts), 1)
    shadowing = opts.shadow_fraction > 0 and opts.shadow_quota > 0
    for attempt in range(1, attempts + 1):
        try:
            if _try_delta_install(engine, target):
                if shadowing:
                    engine.start_shadow(target, opts.shadow_fraction)
                    return "shadow"
                engine.promote(target)
                _observe_staleness(target)
                return "promoted"
            model = load_resolved_game_model(
                target, engine._index_maps, engine._entity_indexes,
                to_device=False, publish_root=publish_root,
            )
            if shadowing:
                engine.load_version(model, model_version=target)
                engine.start_shadow(target, opts.shadow_fraction)
                return "shadow"
            engine.reload(model, model_version=target)
            _observe_staleness(target)
            return "promoted"
        except Exception as exc:  # noqa: BLE001 — old model keeps serving
            logger.warning(
                "auto-reload from %s failed (attempt %d/%d): %s; model %r "
                "keeps serving",
                target, attempt, attempts, exc, engine.model_version,
            )
            registry().counter("serve_reload_retries_total").inc()
            if attempt >= attempts:
                _poison(
                    publish_root,
                    os.path.basename(target.rstrip("/")),
                    f"reload_failed: {exc}",
                )
                return "poisoned"
            if stop.wait(min(delay, opts.backoff_max_s)):
                return "stopped"
            delay = min(delay * 2.0, opts.backoff_max_s)
    return "stopped"


def _repoint_latest(publish_root: str, version: str) -> None:
    """After a rollback, move the on-disk LATEST pointer back to the parent
    so a restart (or any other consumer of the pointer) doesn't resurrect
    the demoted generation."""
    from photon_tpu_torch.io.model_io import publish_latest_pointer

    name = os.path.basename(str(version).rstrip("/"))
    if os.path.isdir(os.path.join(publish_root, name)):
        try:
            publish_latest_pointer(publish_root, name)
        except OSError:
            logger.exception("could not repoint LATEST to %r", name)


def _slo_paging(engine, objectives) -> list:
    """Gated objectives in PAGE state; [] when healthy or when the engine
    has no SLO tracker."""
    out = []
    slo = getattr(engine, "slo", None)
    if slo is None:
        return out
    for name in objectives:
        try:
            if slo.state(name) == "page":
                out.append(name)
        except (KeyError, AttributeError):
            continue
    return out


def _trace_rollout_decision(action: str, version, reason: str) -> None:
    """Every SLO-gate decision is counted and kept as a forced trace, so
    "why did my promotion abort" is answerable from /v1/traces alone."""
    registry().counter("serve_slo_gate_actions_total", action=action).inc()
    try:
        ctx = mint_context(forced=True)
        record_span(f"rollout/{action}", 0.0, parent="", context=ctx)
        flight_recorder().finish(ctx.trace_id, forced=True,
                                 meta={"action": action, "version": str(version), "reason": reason})
    except Exception:  # noqa: BLE001 — tracing never blocks the gate
        logger.exception("could not trace rollout decision %r", action)


def _reload_watcher(engine, model_dir: str, interval: float, stop: threading.Event,
                    opts: Optional[RolloutOptions] = None) -> None:
    """Poll ``model_dir`` for new generations and walk each through the
    rollout lifecycle: candidate → (shadow →) primary → possibly rolled
    back.

    - A detected generation loads with retry and backoff; exhausted attempts
      poison it (skipped for good; a restart honours the poison list too).
    - With ``shadow_fraction > 0`` the candidate first mirrors a sample of
      live traffic; it is promoted once ``shadow_quota`` shadow scores stayed
      under ``divergence_bound``, and abandoned and poisoned on a breach.
    - With ``breaker_trip_bound > 0`` a promoted generation whose breaker
      trips since promotion reach the bound is rolled back to its parent,
      poisoned, and LATEST repointed to the parent.

    With ``slo_gate`` a paging burn on a gated objective aborts an
    in-flight shadow (candidate poisoned), rolls back a promotion still in
    its settle window (demote, poison, repoint LATEST), and freezes
    promotions until the burn clears; every decision is a forced trace and
    a count of ``serve_slo_gate_actions_total``."""
    from photon_tpu_torch.io.model_io import is_poisoned

    opts = opts or RolloutOptions()
    current = _model_fingerprint(resolve_model_dir(model_dir))
    candidate: Optional[str] = None
    frozen_reason: Optional[str] = None
    while not stop.wait(interval):
        paging = _slo_paging(engine, opts.slo_objectives) if opts.slo_gate else []
        if opts.slo_gate:
            # Any page freezes promotions; the freeze clears once no gated
            # objective pages.
            if frozen_reason is not None and not paging:
                logger.info("SLO burn cleared (%s); promotions unfrozen", frozen_reason)
                registry().gauge("serve_promotions_frozen").set(0)
                _trace_rollout_decision("unfreeze", engine.model_version, frozen_reason)
                frozen_reason = None
            elif paging and frozen_reason is None:
                frozen_reason = "slo_page: " + ",".join(paging)
                logger.warning("SLO paging (%s); promotions frozen", frozen_reason)
                registry().gauge("serve_promotions_frozen").set(1)
                _trace_rollout_decision("freeze", engine.model_version, frozen_reason)
        if paging and candidate is not None:
            # Paging during shadow: abort the candidate and poison it.
            reason = "slo_page: " + ",".join(paging)
            engine.stop_shadow()
            logger.warning("candidate %r aborted by SLO gate: %s", candidate, reason)
            _poison(model_dir, os.path.basename(candidate.rstrip("/")), reason)
            _trace_rollout_decision("shadow_abort", candidate, reason)
            candidate = None
        if paging and engine.promotion_in_window():
            # Paging in the settle window: unwind the promotion as breaker
            # trips do.
            reason = "slo_page: " + ",".join(paging)
            demoted = engine.rollback(reason)
            if demoted is not None:
                _poison(model_dir, os.path.basename(str(demoted).rstrip("/")), reason)
                _repoint_latest(model_dir, engine.model_version)
                current = _model_fingerprint(resolve_model_dir(model_dir))
                _trace_rollout_decision("slo_rollback", demoted, reason)
        if candidate is not None:
            st = engine.shadow_stats()
            if st["version"] is None:
                candidate = None  # cleared elsewhere (a manual promote or stop)
            elif st["max_divergence"] > opts.divergence_bound:
                engine.stop_shadow()
                reason = f"shadow_divergence: {st['max_divergence']:.6g}"
                logger.warning("candidate %r abandoned: %s", candidate, reason)
                _poison(model_dir, os.path.basename(candidate.rstrip("/")), reason)
                candidate = None
            elif st["count"] >= opts.shadow_quota:
                if frozen_reason is not None:
                    # Quota met with promotions frozen: the candidate stays
                    # in shadow and promotes after the unfreeze.
                    registry().counter("serve_promotions_frozen_held_total").inc()
                else:
                    logger.info("candidate %r passed shadow quota (%d scores, max divergence %.3g); promoting",
                                candidate, st["count"], st["max_divergence"])
                    engine.promote(candidate)
                    _observe_staleness(candidate)
                    candidate = None
        if opts.breaker_trip_bound > 0:
            trips = engine.trips_since_promotion()
            if trips >= opts.breaker_trip_bound:
                demoted = engine.rollback(f"breaker_trips: {trips}")
                if demoted is not None:
                    _poison(model_dir, os.path.basename(str(demoted).rstrip("/")), f"breaker_trips: {trips}")
                    _repoint_latest(model_dir, engine.model_version)
                    current = _model_fingerprint(resolve_model_dir(model_dir))
        target = resolve_model_dir(model_dir)
        fp = _model_fingerprint(target)
        if fp == current:
            continue
        current = fp
        name = os.path.basename(target.rstrip("/"))
        if is_poisoned(model_dir, name):
            logger.warning("ignoring poisoned generation %r (see %s)", name, model_dir)
            continue
        logger.info("model change detected: loading %s", target)
        outcome = _install_generation(engine, target, opts, stop, model_dir)
        if outcome == "shadow":
            candidate = target
        elif outcome == "stopped":
            return


def make_handler(engine, artifacts_dir=None):
    """Back-compat factory: the in-process HTTP handler over ``engine``."""
    return make_http_handler(LocalBackend(engine))


def _admission_config(args) -> AdmissionConfig:
    return AdmissionConfig(
        default_qps=args.tenant_default_qps,
        default_burst=args.tenant_default_burst,
        tenant_qps=parse_tenant_rates(args.tenant_qps),
        tenant_burst=parse_tenant_rates(args.tenant_burst),
        batch_queue_fraction=args.batch_queue_fraction,
    )


def _serve_config(args) -> ServeConfig:
    return ServeConfig(
        max_batch_size=args.max_batch_size,
        max_delay_ms=args.max_delay_ms,
        queue_cap=args.queue_cap,
        hot_bytes=int(args.hot_bytes_mb * (1 << 20)),
        default_deadline_ms=args.deadline_ms,
        admission=_admission_config(args),
        max_versions=args.max_model_versions,
        shadow_fraction=args.shadow_fraction,
        promotion_settle_s=args.promotion_settle,
        device=str(resolve_device(args.device)),
    )


def _rollout_options(args) -> RolloutOptions:
    return RolloutOptions(
        shadow_fraction=args.shadow_fraction,
        shadow_quota=args.shadow_quota,
        divergence_bound=args.divergence_bound,
        breaker_trip_bound=args.breaker_trip_bound,
        max_reload_attempts=args.reload_max_attempts,
        backoff_s=args.reload_backoff,
        slo_gate=bool(args.slo_gate),
    )


def _telemetry_max_bytes(args):
    mb = float(args.telemetry_max_mb or 0.0)
    return int(mb * (1 << 20)) if mb > 0 else None


def _start_background(args, engine, stop: threading.Event) -> Optional[threading.Thread]:
    """The reload watcher and the periodic run-report flusher, in both
    deployment shapes. Returns the watcher's thread, if any."""
    watcher = None
    if args.reload_poll_interval and args.reload_poll_interval > 0:
        watcher = threading.Thread(target=_reload_watcher,
                                   args=(engine, args.model_input_dir, args.reload_poll_interval, stop,
                                         _rollout_options(args)),
                                   name="model-reload-watcher", daemon=True)
        watcher.start()
    if args.telemetry_out and args.telemetry_flush_interval > 0:
        max_bytes = _telemetry_max_bytes(args)

        def _flush_loop():
            while not stop.wait(args.telemetry_flush_interval):
                try:
                    write_run_report(args.telemetry_out, collect_run_records("game_serving"), max_bytes=max_bytes)
                except Exception:  # noqa: BLE001 — telemetry never kills serving
                    logger.exception("periodic telemetry flush failed")

        threading.Thread(target=_flush_loop, name="telemetry-flush", daemon=True).start()
    return watcher


def _load_engine(args, config: ServeConfig):
    model_dir = resolve_model_dir(args.model_input_dir)
    logger.info("loading + warming model from %s", model_dir)
    artifacts = args.model_artifacts_dir
    if artifacts is None and model_dir != args.model_input_dir:
        # LATEST resolved to a generation subdir; the artifacts live
        # beside the generations, in the publication root.
        artifacts = args.model_input_dir
    engine = load_engine(model_dir, artifacts_dir=artifacts, config=config)
    _attach_feedback(args, engine)
    return engine


def _attach_feedback(args, engine) -> None:
    """Wire the streaming feedback spool (the engine owns its lifecycle)."""
    if not getattr(args, "feedback_spool", None):
        return
    from photon_tpu_torch.stream.spool import FeedbackSpool, SpoolConfig

    fractions = {}
    if args.feedback_tenant_fractions:
        for part in args.feedback_tenant_fractions.split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                fractions[k.strip()] = float(v)
    spool = FeedbackSpool(args.feedback_spool, SpoolConfig(
        segment_max_records=args.feedback_segment_records,
        segment_max_age_s=args.feedback_segment_age,
        sample_fraction=args.feedback_sample_fraction,
        tenant_fractions=fractions,
        join_ttl_s=args.feedback_join_ttl,
    ))
    spool.start_auto_flush()
    engine.attach_feedback(spool)
    logger.info("feedback spool attached at %s", args.feedback_spool)


def _startup_banner(engine, host, port, workers: int) -> None:
    print(json.dumps({
        "serving": True,
        "host": host,
        "port": port,
        "workers": workers,
        "maxBatchSize": engine.max_batch,
        "modelVersion": engine.model_version,
    }), flush=True)


def _run_multiprocess(args):
    """The traffic shape: spawn N workers, then build the engine and serve
    the scorer IPC socket from this process."""
    frontend = ServingFrontend(args.host, args.port, args.workers, scorer_endpoint=args.scorer_endpoint)
    frontend.start_workers()
    stop = threading.Event()

    def _shutdown(signum, frame):
        stop.set()

    # Handlers go in before the (slow) warm-up: a SIGTERM then must still
    # reach frontend.shutdown(), or the workers would outlive the parent.
    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    begin_run()
    exporter = install_otlp(args, "photon-tpu-serving")
    try:
        engine = _load_engine(args, _serve_config(args))
    except BaseException:
        frontend.shutdown()
        close_otlp(exporter)
        raise
    frontend.start_scorer(engine)
    watcher = _start_background(args, engine, stop)
    _startup_banner(engine, frontend.host, frontend.port, args.workers)
    try:
        while not stop.wait(0.5):
            frontend.poll_workers()
            if frontend.live_workers() == 0:
                logger.error("all serve workers exited; shutting down")
                break
    finally:
        stop.set()
        frontend.shutdown()  # workers drain first: no new admissions
        if watcher is not None:
            watcher.join(timeout=30)
        engine.close(drain=True)  # then score out what is queued
        finalize_run_report("game_serving", path=args.telemetry_out, max_bytes=_telemetry_max_bytes(args))
        close_otlp(exporter)
        print(json.dumps({"serving": False, "stats": engine.stats(),
                          "workerExits": {str(k): v for k, v in frontend.worker_exits.items()}}, default=str))


def _run_inprocess(args):
    begin_run()
    exporter = install_otlp(args, "photon-tpu-serving")
    try:
        engine = _load_engine(args, _serve_config(args))
        server = ServingHTTPServer((args.host, args.port), make_handler(engine))
    except BaseException:
        drop_otlp(exporter)
        raise
    stop = threading.Event()

    def _shutdown(signum, frame):
        stop.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    watcher = _start_background(args, engine, stop)
    _startup_banner(engine, server.server_address[0], server.server_address[1], 0)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        stop.set()
        if watcher is not None:
            watcher.join(timeout=30)
        engine.close(drain=True)
        server.server_close()
        finalize_run_report("game_serving", path=args.telemetry_out, max_bytes=_telemetry_max_bytes(args))
        close_otlp(exporter)
        print(json.dumps({"serving": False, "stats": engine.stats()}, default=str))


def run(args):
    setup_logging(args.verbose)
    from photon_tpu_torch.utils import resources

    # Host RSS watchdog: under memory pressure the micro-batcher's admission
    # cap tightens (shed by backpressure, not by the OOM killer).
    resources.start_watchdog()
    if args.workers and args.workers > 0:
        _run_multiprocess(args)
    else:
        _run_inprocess(args)


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
