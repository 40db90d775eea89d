"""Exporter + SLO-actuation tests: the OTLP-shaped JSON exporter against
the stdlib MockCollector (round-trip, retry, drop-and-count degradation),
exemplar-linked histograms (deterministic sampling, Prometheus render,
``photon-tpu-obs`` parsing/resolution), flight-recorder ring overflow
accounting, and the ``--slo-gate`` watcher's freeze/rollback decisions
driven by an injected paging burn.
"""

import argparse
import json
import socket
import threading
import time

import pytest

from photon_tpu_torch.cli.obs_tool import cmd_traces, parse_prometheus
from photon_tpu_torch.obs.export import (
    MockCollector,
    OTLPExporter,
    exporter_health,
    install_exporter,
    maybe_install_exporter,
    span_to_otlp,
    uninstall_exporter,
)
from photon_tpu_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    _label_key,
    registry,
    render_prometheus,
)
from photon_tpu_torch.obs.slo import (
    DRILL_PAGE_RULES,
    DRILL_WARN_RULES,
    SLOTracker,
    default_objectives,
    streaming_objectives,
)
from photon_tpu_torch.obs.trace import (
    FlightRecorder,
    SpanRecord,
    flight_recorder,
    mint_context,
    new_trace_id,
    reset_flight_recorder,
    span,
)

TID = "ab" * 16
SID = "cd" * 8


def _wait_for(pred, timeout_s=10.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _span_rec(name="req/score", tid=TID, sid=SID) -> SpanRecord:
    return SpanRecord(
        name=name, parent=None, start_s=0.25, duration_s=0.05,
        thread="main", trace_id=tid, span_id=sid, pid=123,
    )


# ---------------------------------------------------------------------------
# OTLP document shapes
# ---------------------------------------------------------------------------


def test_span_to_otlp_shape():
    out = span_to_otlp(_span_rec(), epoch_unix_s=1_000_000.0)
    assert out["traceId"] == TID and out["spanId"] == SID
    assert out["kind"] == 1
    start = int(out["startTimeUnixNano"])
    end = int(out["endTimeUnixNano"])
    assert start == int(1_000_000.25 * 1e9)
    assert end - start == int(0.05 * 1e9)
    attrs = {a["key"]: a["value"] for a in out["attributes"]}
    assert attrs["pid"] == {"intValue": "123"}
    # Short hand-minted ids pad to OTLP's fixed widths.
    padded = span_to_otlp(_span_rec(tid="ff", sid="ee"), 0.0)
    assert padded["traceId"] == "ff".rjust(32, "0")
    assert padded["spanId"] == "ee".rjust(16, "0")


# ---------------------------------------------------------------------------
# Exporter <-> MockCollector round trip
# ---------------------------------------------------------------------------


def test_exporter_round_trip_spans_metrics_and_exemplars():
    col = MockCollector()
    reg = MetricsRegistry()
    reg.counter("serve_requests_total", tenant="t1").inc(5)
    reg.gauge("model_staleness_s").set(12.5)
    h = reg.histogram("serve_tenant_latency_s", tenant="t1")
    h.observe(0.031, trace_id=TID)
    exp = OTLPExporter(
        col.endpoint, flush_interval_s=0.05, backoff_s=0.01,
        snapshot_fn=reg.snapshot,
    )
    try:
        exp.on_span(_span_rec())
        assert exp.export_metrics() is True
        assert exp.flush(timeout_s=10.0)

        names = {s["name"] for s in col.spans()}
        assert "req/score" in names
        metric_names = {m["name"] for m in col.metrics()}
        assert {"serve_requests_total", "model_staleness_s",
                "serve_tenant_latency_s"} <= metric_names
        # Counter labels survive as OTLP attributes.
        (ctr,) = [
            m for m in col.metrics() if m["name"] == "serve_requests_total"
        ]
        dp = ctr["sum"]["dataPoints"][0]
        assert dp["asDouble"] == 5.0
        assert {"key": "tenant", "value": {"stringValue": "t1"}} in (
            dp["attributes"]
        )
        # The histogram's exemplar links the series to the trace.
        assert ("serve_tenant_latency_s", TID) in (
            col.metric_exemplar_trace_ids()
        )
        health = exp.health()
        assert health["exported_spans"] == 1
        assert health["dropped_spans"] == 0
        assert health["consecutive_failures"] == 0
    finally:
        exp.close()
        col.close()


def test_exporter_retries_through_transient_failures():
    col = MockCollector()
    exp = OTLPExporter(
        col.endpoint, flush_interval_s=0.05, backoff_s=0.01, max_retries=3,
    )
    try:
        col.fail_next(2)
        exp.on_span(_span_rec())
        _wait_for(
            lambda: exp.exported_span_batches == 1, msg="batch export"
        )
        # Two 503s then success: >= 3 requests, failure counter cleared.
        assert col.requests_total >= 3
        assert exp.consecutive_failures == 0
        assert exp.dropped_batches == 0
    finally:
        exp.close()
        col.close()


def test_dead_collector_drops_and_counts_without_blocking():
    endpoint = f"http://127.0.0.1:{_free_port()}"
    exp = OTLPExporter(
        endpoint, queue_cap=8, flush_interval_s=0.02, timeout_s=0.2,
        max_retries=2, backoff_s=0.01,
    )
    try:
        t0 = time.monotonic()
        for i in range(300):
            exp.on_span(_span_rec(sid=f"{i:016x}"))
        enqueue_s = time.monotonic() - t0
        # The hot path is an O(1) enqueue: 300 calls against a dead
        # endpoint must not take anywhere near one connect timeout.
        assert enqueue_s < 1.0, f"on_span blocked: {enqueue_s:.3f}s"
        _wait_for(
            lambda: exp.dropped_spans > 0 and exp.last_error is not None,
            msg="drop accounting",
        )
        health = exp.health()
        assert health["endpoint"] == endpoint
        assert health["exported_spans"] == 0
        assert health["consecutive_failures"] > 0
        # flush() returns (possibly False) rather than hanging.
        exp.flush(timeout_s=2.0)
    finally:
        exp.close()


def test_install_uninstall_and_health_block():
    assert maybe_install_exporter(None, "svc") is None
    assert exporter_health() is None

    col = MockCollector()
    exp = install_exporter(
        OTLPExporter(col.endpoint, flush_interval_s=0.05, backoff_s=0.01)
    )
    try:
        ctx = mint_context()
        with span("installed/hop", context=ctx):
            pass
        with span("untraced"):
            pass
        assert exp.flush(timeout_s=10.0)
        names = {s["name"] for s in col.spans()}
        assert "installed/hop" in names
        assert "untraced" not in names  # sinks fire for traced spans only
        assert exporter_health()["endpoint"] == col.endpoint
    finally:
        uninstall_exporter()
        col.close()
    assert exporter_health() is None


@pytest.mark.parametrize("driver", ["game_training", "game_serving", "game_streaming"])
def test_failed_driver_run_leaves_no_exporter_installed(tmp_path, driver):
    """A driver given --otlp-endpoint that stops on a missing input
    uninstalls its exporter on the way out (the reference's drivers leave
    it installed, so a later run in the same process found it there)."""
    import importlib

    module = importlib.import_module(f"photon_tpu_torch.cli.{driver}")
    argv = {
        "game_training": ["--input-paths", str(tmp_path / "none.avro"), "--coordinate-configurations",
                          "name=global,feature.shard=g", "--update-sequence", "global",
                          "--output-dir", str(tmp_path / "o")],
        "game_serving": ["--model-input-dir", str(tmp_path / "nowhere"), "--port", "0"],
        "game_streaming": ["--publish-root", str(tmp_path / "nowhere"), "--spool-dir", str(tmp_path / "spool"),
                           "--coordinate-configurations", "name=global,feature.shard=g",
                           "--update-sequence", "global"],
    }[driver]
    assert exporter_health() is None
    with pytest.raises(Exception):
        module.main(argv + ["--device", "cpu", "--otlp-endpoint", "http://localhost:1"])
    assert exporter_health() is None


# ---------------------------------------------------------------------------
# Exemplars: deterministic sampling + Prometheus render + CLI parse
# ---------------------------------------------------------------------------


def test_histogram_exemplars_deterministic_and_bounded():
    seq = [(i * 0.001, f"{i:032x}") for i in range(500)]
    h1 = Histogram("h", _label_key({}))
    h2 = Histogram("h", _label_key({}))
    for v, tid in seq:
        h1.observe(v, trace_id=tid)
        h2.observe(v, trace_id=tid)
    assert h1.exemplars() == h2.exemplars()  # no RNG anywhere
    assert 0 < len(h1.exemplars()) <= Histogram.EXEMPLAR_CAP
    # Untraced observations never mint exemplars.
    h3 = Histogram("h", _label_key({}))
    for v, _ in seq:
        h3.observe(v)
    assert h3.exemplars() == []
    assert "exemplars" not in (h3.as_dict()["stats"] or {})


def test_render_prometheus_emits_parseable_exemplar():
    reg = MetricsRegistry()
    reg.histogram("serve_tenant_latency_s", tenant="t1").observe(
        0.042, trace_id=TID
    )
    text = render_prometheus(reg.snapshot())
    count_lines = [
        l for l in text.splitlines()
        if l.startswith("serve_tenant_latency_s") and "_count" in l
    ]
    assert count_lines and f'# {{trace_id="{TID}"}}' in count_lines[0]

    samples = parse_prometheus(text)
    (count,) = [
        s for s in samples if s["name"] == "serve_tenant_latency_s_count"
    ]
    assert count["value"] == 1.0
    assert count["labels"] == {"tenant": "t1"}
    assert count["exemplar"]["labels"]["trace_id"] == TID
    assert abs(count["exemplar"]["value"] - 0.042) < 1e-9
    # Lines without exemplars parse without one.
    assert all(
        "exemplar" not in s
        for s in samples if s["name"].endswith("_sum")
    )


def test_obs_tool_resolves_exemplar_trace_id(monkeypatch):
    entries = [
        {"traceId": TID, "reason": "forced", "latencySeconds": 0.01,
         "spans": [], "pids": [1]},
        {"traceId": "ff" * 16, "reason": "slow", "latencySeconds": 0.5,
         "spans": [], "pids": [1]},
    ]
    monkeypatch.setattr(
        "photon_tpu_torch.cli.obs_tool._get_json",
        lambda url, timeout_s=30.0: {"traces": entries},
    )

    def _args(tid):
        return argparse.Namespace(
            url="http://x", limit=None, follow=False, json=True,
            interval=0.0, trace_id=tid,
        )

    assert cmd_traces(_args(TID)) == 0
    assert cmd_traces(_args(TID[:8])) == 0  # prefix resolves too
    assert cmd_traces(_args("00" * 16)) == 1  # absent -> nonzero exit


# ---------------------------------------------------------------------------
# Flight-recorder ring overflow
# ---------------------------------------------------------------------------


def test_ring_overflow_drops_oldest_and_counts():
    fr = FlightRecorder(capacity=4)
    tids = [new_trace_id() for _ in range(10)]
    for tid in tids:
        assert fr.finish(tid, 0.01, forced=True) == "forced"
    stats = fr.stats()
    assert stats["kept"] == 10
    assert stats["ring_dropped"] == 6  # 10 kept into a 4-slot ring
    # The ring holds the NEWEST four, oldest first.
    assert [e["traceId"] for e in fr.traces()] == tids[-4:]
    fr.reset()
    assert fr.stats()["ring_dropped"] == 0


# ---------------------------------------------------------------------------
# SLO-driven rollout actuation
# ---------------------------------------------------------------------------


class _GatedEngine:
    """What the watcher's SLO gate touches: a tracker, a promotion in its
    settle window, and the rollback hook."""

    def __init__(self, slo):
        self.slo = slo
        self.model_version = "gen-1"
        self.rollbacks = []
        self._in_window = [True]

    def promotion_in_window(self):
        return self._in_window.pop(0) if self._in_window else False

    def rollback(self, reason):
        self.rollbacks.append(reason)
        return "gen-2"

    def shadow_stats(self):
        return {"version": None, "max_divergence": 0.0, "count": 0}

    def stop_shadow(self):
        pass


def test_slo_gate_freezes_rolls_back_and_unfreezes(tmp_path):
    from photon_tpu_torch.cli.game_serving import RolloutOptions, _reload_watcher
    from photon_tpu_torch.io.model_io import is_poisoned

    reset_flight_recorder()
    fake = {"t": 1000.0}
    slo = SLOTracker(
        default_objectives(),
        page_rules=DRILL_PAGE_RULES,
        warn_rules=DRILL_WARN_RULES,
        bucket_s=1.0,
        clock=lambda: fake["t"],
    )
    eng = _GatedEngine(slo)
    root = str(tmp_path)
    stop = threading.Event()
    opts = RolloutOptions(slo_gate=True)

    def gate_actions(action):
        return registry().counter(
            "serve_slo_gate_actions_total", action=action
        ).value

    base = {
        a: gate_actions(a)
        for a in ("freeze", "unfreeze", "slo_rollback")
    }
    t = threading.Thread(
        target=_reload_watcher, args=(eng, root, 0.02, stop, opts),
        daemon=True,
    )
    t.start()
    try:
        # Availability burn well past the paging threshold.
        for _ in range(30):
            slo.record_request(False)
        _wait_for(lambda: eng.rollbacks, msg="slo rollback")
        assert "slo_page" in eng.rollbacks[0]
        _wait_for(
            lambda: gate_actions("freeze") > base["freeze"], msg="freeze"
        )
        assert registry().gauge("serve_promotions_frozen").value == 1
        # The decision counter increments LAST (after poison + repoint),
        # so waiting on it orders the whole rollback sequence.
        _wait_for(
            lambda: gate_actions("slo_rollback") > base["slo_rollback"],
            msg="slo_rollback decision",
        )
        assert is_poisoned(root, "gen-2")  # demoted generation poisoned
        # Every decision is a kept (forced) trace with its reason.
        kept = {
            (e["meta"].get("action"), e["reason"])
            for e in flight_recorder().traces()
            if e.get("meta")
        }
        assert ("slo_rollback", "forced") in kept
        assert ("freeze", "forced") in kept

        # Burn clears (time passes, traffic healthy) -> unfreeze.
        fake["t"] += 120.0
        for _ in range(30):
            slo.record_request(True, 0.01)
        _wait_for(
            lambda: gate_actions("unfreeze") > base["unfreeze"],
            msg="unfreeze",
        )
        assert registry().gauge("serve_promotions_frozen").value == 0
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()


def test_streaming_objectives_cover_cycle_and_staleness():
    slo = SLOTracker(streaming_objectives())
    assert set(slo.objectives) == {
        "update_cycle", "model_staleness_s", "fe_age_s",
    }
    slo.record_event("update_cycle", True)
    slo.record_staleness(5.0)
    slo.record_fe_age(10.0)
    slo.record_fe_age(7200.0)
    snap = slo.snapshot()
    assert snap["objectives"]["update_cycle"]["events"] == 1
    assert snap["objectives"]["model_staleness_s"]["events"] == 1
    # One good (under the 3600 s default bar) + one bad observation.
    assert snap["objectives"]["fe_age_s"]["events"] == 2
    assert snap["objectives"]["fe_age_s"]["threshold"] == 3600.0
