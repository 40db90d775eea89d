"""The port's observability plane (photon_tpu_torch/obs, serve/frontend.py)
held to the cases of tests/test_obs_plane.py: cross-process trace
propagation, the tail-based flight recorder, the merged Prometheus scrape,
and the SLO burn-rate state machine.

``test_replica_metrics_partial_scrape_is_labeled`` (:285) holds the port's
scorer fleet (serve/fleet.py). Left out of tests/test_obs_plane.py, with
the item of ROADMAP queue 1 that ports its machinery:
``test_one_score_produces_one_trace_across_three_processes`` (:567), the
fleet relay, item 9b. Its two-process counterpart here runs the port's
``game_serving --workers 1``: one request, one trace, the worker's and the
scorer's spans nested across the process boundary.
"""

import json
import os
import re
import select
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import Future
from http.server import ThreadingHTTPServer

import pytest

from photon_tpu_torch.obs.metrics import (
    MetricsRegistry,
    canonical_name,
    registry,
    render_prometheus,
)
from photon_tpu_torch.obs.slo import SLOTracker, default_objectives
from photon_tpu_torch.obs.trace import (
    FlightRecorder,
    TraceContext,
    Tracer,
    flight_recorder,
    merge_trace_dumps,
    mint_context,
    new_trace_id,
    reset_flight_recorder,
)

# ---------------------------------------------------------------------------
# TraceContext wire forms
# ---------------------------------------------------------------------------


def test_traceparent_roundtrip_and_forced_semantics():
    ctx = mint_context()
    assert re.fullmatch(r"[0-9a-f]{32}", ctx.trace_id)
    assert ctx.sampled and not ctx.forced and ctx.parent_span_id is None

    header = ctx.to_traceparent()
    back = TraceContext.from_traceparent(header)
    assert back is not None
    assert back.trace_id == ctx.trace_id
    # An explicit client header is a request to SEE the trace.
    assert back.forced is True

    with_parent = TraceContext.from_traceparent(
        "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    )
    assert with_parent.parent_span_id == "cd" * 8
    assert with_parent.sampled is True

    # Malformed / all-zero ids are rejected, never raise.
    assert TraceContext.from_traceparent(None) is None
    assert TraceContext.from_traceparent("garbage") is None
    assert TraceContext.from_traceparent(
        "00-" + "0" * 32 + "-" + "cd" * 8 + "-01"
    ) is None

    # Dict form round-trips through the IPC frame.
    again = TraceContext.from_dict(with_parent.to_dict())
    assert again == with_parent
    assert TraceContext.from_dict(None) is None
    assert TraceContext.from_dict({"nope": 1}) is None


def test_remote_child_spans_nest_across_attach():
    tr = Tracer()
    ctx = TraceContext("ab" * 16, "cd" * 8, True, False)
    with tr.attach_context(ctx):
        with tr.span("hop"):
            inner_ctx = tr.extract_context()
            with tr.span("inner"):
                pass
    spans = {s.name: s for s in tr.spans()}
    hop, inner = spans["hop"], spans["hop/inner"]
    assert hop.trace_id == inner.trace_id == ctx.trace_id
    # hop nests under the remote parent; inner under hop.
    assert hop.parent_span_id == "cd" * 8
    assert inner.parent_span_id == hop.span_id
    # What a sender would put on the wire mid-span names the open span.
    assert inner_ctx.parent_span_id == hop.span_id

    # Untraced spans carry no identity (schema + hot path unchanged).
    with tr.span("plain"):
        pass
    plain = [s for s in tr.spans() if s.name == "plain"][0]
    assert plain.trace_id is None and plain.pid is None
    assert "trace_id" not in plain.as_dict()
    assert plain.as_trace_dict()["traceId"] is None


# ---------------------------------------------------------------------------
# Flight recorder tail semantics
# ---------------------------------------------------------------------------


def test_flight_recorder_keeps_only_the_tail():
    fr = FlightRecorder(capacity=16, min_latency_samples=5)
    tr = Tracer()
    tr.add_sink(fr.on_span)

    def one_span():
        ctx = mint_context()
        with tr.span("req", context=ctx):
            pass
        return ctx

    # Unremarkable request with no latency history: discarded.
    assert fr.finish(one_span().trace_id, 0.01) is None
    # Keep reasons, in precedence order.
    assert fr.finish(one_span().trace_id, 0.01, error="boom") == "error"
    assert fr.finish(one_span().trace_id, 0.01, degraded=True) == "degraded"
    assert fr.finish(one_span().trace_id, 0.01, forced=True) == "forced"
    # Self-calibrating slow keep: feed a fast baseline, then one outlier.
    for _ in range(50):
        assert fr.finish(new_trace_id(), 0.01) is None
    assert fr.finish(new_trace_id(), 10.0) == "slow"

    kept = fr.traces()
    assert [e["reason"] for e in kept] == [
        "error", "degraded", "forced", "slow"
    ]
    assert kept[0]["spans"][0]["name"] == "req"
    assert kept[0]["error"] == "boom"
    stats = fr.stats()
    assert stats["kept"] == 4 and stats["discarded"] == 51
    # limit keeps the newest.
    assert [e["reason"] for e in fr.traces(limit=1)] == ["slow"]


def test_merge_trace_dumps_reassembles_processes():
    e1 = dict(traceId="t1", reason="forced", latencySeconds=0.2, error=None,
              degraded=False, spans=[{"spanId": "a", "pid": 10}])
    e2 = dict(traceId="t1", reason="forced", latencySeconds=0.1,
              error="late", degraded=True,
              spans=[{"spanId": "b", "pid": 20}, {"spanId": "a", "pid": 10}])
    e3 = dict(traceId="t2", reason="slow", latencySeconds=1.0, error=None,
              degraded=False, spans=[{"spanId": "c", "pid": 30}])
    merged = merge_trace_dumps([e1, e2, e3])
    assert [m["traceId"] for m in merged] == ["t1", "t2"]
    m1 = merged[0]
    assert {s["spanId"] for s in m1["spans"]} == {"a", "b"}  # deduped
    assert m1["pids"] == [10, 20]
    assert m1["latencySeconds"] == 0.2 and m1["error"] == "late"
    assert m1["degraded"] is True


# ---------------------------------------------------------------------------
# Prometheus exposition + naming aliases
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" -?[0-9.eE+-]+"
    # OpenMetrics exemplar suffix on histogram _count lines:
    # `... # {trace_id="<hex>"} <value>`
    r'( # \{trace_id="[0-9a-f]+"\} -?[0-9.eE+-]+)?$'
)


def test_render_prometheus_parses_and_fills_labels():
    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(5)
    reg.gauge("spool_bytes", replica="r0").set(7.5)
    h = reg.histogram("serve_request_latency_s")
    for v in (0.01, 0.02, 0.03):
        h.observe(v)
    text = render_prometheus(
        reg.snapshot(), extra_labels={"replica": "frontend"}
    )
    lines = text.splitlines()
    for line in lines:
        if line.startswith("#"):
            assert re.match(r"^# TYPE \S+ (counter|gauge|summary)$", line)
        else:
            assert _PROM_LINE.match(line), line
    # extra_labels fill where absent; existing labels win.
    assert 'serve_requests_total{replica="frontend"} 5' in lines
    assert 'spool_bytes{replica="r0"} 7.5' in lines
    # Histograms render as summaries with quantiles + _sum/_count.
    assert any(
        l.startswith("serve_request_latency_s{")
        and 'quantile="0.99"' in l for l in lines
    )
    assert any(l.startswith("serve_request_latency_s_count{") for l in lines)


def test_metric_name_aliases_resolve_to_one_instrument():
    reg = MetricsRegistry()
    old = reg.counter("re_entities_skipped")
    new = reg.counter("re_entities_skipped_total")
    assert old is new
    assert canonical_name("pipeline_wall_seconds") == "pipeline_wall_s"
    assert canonical_name("model_staleness_s_hist") == "model_staleness_hist_s"
    # Snapshots carry only canonical names.
    names = {s["metric"] for s in reg.snapshot()}
    assert names == {"re_entities_skipped_total"}


# ---------------------------------------------------------------------------
# Fleet partial scrape
# ---------------------------------------------------------------------------


def test_replica_metrics_partial_scrape_is_labeled():
    from photon_tpu_torch.serve.admission import FleetAdmissionLedger
    from photon_tpu_torch.serve.fleet import LIVE, FleetBackend, FleetRouter
    from photon_tpu_torch.serve.routing import HashRing

    ring = HashRing()
    ring.add("r0")
    ring.add("r1")
    router = FleetRouter(ring, FleetAdmissionLedger())

    class _Good:
        def call(self, op, timeout_s=30.0, **kw):
            if op == "metrics":
                return [dict(record="metric", metric="serve_store_hits_total", type="counter",
                             labels={"replica": "r0"}, value=5, stats=None)]
            return []

    class _DiesMidScrape:
        def call(self, op, timeout_s=30.0, **kw):
            raise ConnectionError("scorer connection lost")

    router._clients = {"r0": _Good(), "r1": _DiesMidScrape()}
    router._state = {"r0": LIVE, "r1": LIVE}

    out = router.replica_metrics()
    assert out["r0"] == {"ok": True, "metrics": [
        dict(record="metric", metric="serve_store_hits_total", type="counter", labels={"replica": "r0"}, value=5,
             stats=None),
    ]}
    assert out["r1"]["ok"] is False
    assert "connection lost" in out["r1"]["error"]

    # The merged render marks the missing member rather than silently
    # presenting the partial scrape as the whole fleet.
    text = FleetBackend(router).metrics_text()
    assert 'serve_store_hits_total{replica="r0"} 5' in text
    assert 'fleet_scrape_failed{replica="r1"} 1' in text


# ---------------------------------------------------------------------------
# SLO state machine
# ---------------------------------------------------------------------------


def test_slo_state_machine_drill():
    now = [10_000.0]
    trk = SLOTracker(
        objectives=default_objectives(latency_threshold_s=0.5),
        page_rules=((60.0, 5.0, 14.4),),
        warn_rules=((300.0, 30.0, 6.0),),
        bucket_s=1.0,
        min_events=10,
        clock=lambda: now[0],
    )
    # Idle / sparse traffic is never in violation.
    assert trk.state("availability") == "ok"
    trk.record_request(False)
    assert trk.state("availability") == "ok"  # under min_events
    now[0] += 400.0  # let the lone failure age out of every window

    # Healthy steady state.
    for _ in range(60):
        trk.record_request(True, 0.01)
        now[0] += 0.5
    assert trk.state("availability") == "ok"
    assert trk.state("latency_p99") == "ok"

    # Hard outage: burn explodes in both windows → page.
    for _ in range(60):
        trk.record_request(False)
        now[0] += 0.5
    assert trk.state("availability") == "page"
    snap = trk.snapshot()
    assert snap["state"] == "page"
    av = snap["objectives"]["availability"]
    assert av["state"] == "page" and av["burn"]["1m"] > 14.4

    # Bleeding stops: the short window clears the page fast.
    for _ in range(140):
        trk.record_request(True, 0.01)
        now[0] += 0.5
    assert trk.state("availability") != "page"

    # Latency objective pages independently of availability.
    for _ in range(80):
        trk.record_request(True, 5.0)  # successful but slow
        now[0] += 0.5
    assert trk.state("latency_p99") == "page"
    assert trk.state("availability") == "ok"

    # Burn + state mirror into gauges for the /metrics scrape.
    reg = MetricsRegistry()
    trk.publish_metrics(reg)
    st = reg.find("slo_state", objective="latency_p99")
    assert st is not None and st.value == 2
    burn = reg.find("slo_burn_rate", objective="availability", window="1m")
    assert burn is not None

    # Staleness objective: stale model → bad events.
    for _ in range(40):
        trk.record_staleness(10_000.0)
        now[0] += 0.5
    assert trk.state("model_staleness_s") == "page"


# ---------------------------------------------------------------------------
# HTTP layer: traceparent in, /metrics + /v1/traces out
# ---------------------------------------------------------------------------


class _StubBackend:
    """make_http_handler backend that resolves instantly — isolates the
    handler's trace minting / flight-recorder finish from any engine."""

    result_timeout_s = 10.0

    def __init__(self):
        self.last_trace = None

    def submit(self, raw_request, tenant, priority, model_version=None,
               trace=None):
        self.last_trace = trace
        fut = Future()
        fut.set_result({"score": 0.5, "modelVersion": "gen-test"})
        return fut

    def stats(self):
        return {"ok": True}

    def metrics_text(self):
        return render_prometheus(registry().snapshot())

    def traces(self, limit=None):
        return merge_trace_dumps(flight_recorder().traces(limit=limit))


@pytest.fixture
def _http_stub():
    from photon_tpu_torch.serve.frontend import make_http_handler

    reset_flight_recorder()
    backend = _StubBackend()
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), make_http_handler(backend)
    )
    httpd.daemon_threads = True
    import threading

    t = threading.Thread(target=httpd.serve_forever,
                         kwargs=dict(poll_interval=0.05), daemon=True)
    t.start()
    try:
        yield backend, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        reset_flight_recorder()


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_http_traceparent_forces_keep_and_endpoints_serve(_http_stub):
    backend, port = _http_stub
    tid = "ab" * 16
    status, res = _post(
        port, "/v1/score", {"features": {"f": [1.0]}},
        headers={"traceparent": f"00-{tid}-{'cd' * 8}-01"},
    )
    assert status == 200 and res["score"] == 0.5

    # The handler minted a child context for the backend hop...
    assert backend.last_trace is not None
    assert backend.last_trace["traceId"] == tid
    http_sid = backend.last_trace["parentSpanId"]
    assert re.fullmatch(r"[0-9a-f]{16}", http_sid)
    assert backend.last_trace["forced"] is True

    # ...and the forced trace was kept with the http span chained to the
    # client's parent span.
    status, ctype, body = _get(port, "/v1/traces?limit=10")
    assert status == 200
    entries = json.loads(body)["traces"]
    mine = [e for e in entries if e["traceId"] == tid]
    assert len(mine) == 1 and mine[0]["reason"] == "forced"
    span = [s for s in mine[0]["spans"] if s["name"] == "http/v1/score"][0]
    assert span["spanId"] == http_sid
    assert span["parentSpanId"] == "cd" * 8
    assert span["pid"] == os.getpid()

    # Without a traceparent the request is tail-sampled: minted trace,
    # nothing notable → not kept.
    status, res = _post(port, "/v1/score", {"features": {"f": [1.0]}})
    assert status == 200
    _, _, body = _get(port, "/v1/traces")
    assert len(json.loads(body)["traces"]) == 1  # still just the forced one

    # /metrics serves the Prometheus content type and parseable lines.
    status, ctype, body = _get(port, "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    for line in body.decode().splitlines():
        assert line.startswith("#") or _PROM_LINE.match(line), line

    # /healthz still answers.
    status, _, body = _get(port, "/healthz")
    assert status == 200 and json.loads(body) == {"ok": True}


# ---------------------------------------------------------------------------
# Scorer IPC hop propagates the context
# ---------------------------------------------------------------------------


class _StubEngine:
    model_version = "gen-stub"

    def __init__(self):
        self.last_req = None

    def submit(self, req, tenant=None, priority=None, model_version=None):
        self.last_req = req
        fut = Future()
        fut.set_result(0.75)
        return fut

    def stats(self):
        return {"ok": True}


def test_scorer_ipc_hop_records_remote_child(tmp_path):
    from photon_tpu_torch.serve.frontend import ScorerClient, ScorerServer

    reset_flight_recorder()
    engine = _StubEngine()
    server = ScorerServer(engine, str(tmp_path / "scorer.sock"))
    server.start()
    try:
        client = ScorerClient(str(tmp_path / "scorer.sock"))
        try:
            ctx = TraceContext("ef" * 16, "12" * 8, True, True)
            res = client.submit_score(
                {"features": {"f": [1.0]}}, trace=ctx.to_dict()
            ).result(30)
            assert res["score"] == 0.75

            # The scorer stamped its pre-minted span onto the request so
            # downstream hops (spool, fleet) can parent on it.
            downstream = engine.last_req.trace
            assert downstream["traceId"] == ctx.trace_id
            scorer_sid = downstream["parentSpanId"]
            assert re.fullmatch(r"[0-9a-f]{16}", scorer_sid)

            # Forced context → the scorer-side recorder kept the hop.
            kept = [
                e for e in flight_recorder().traces()
                if e["traceId"] == ctx.trace_id
            ]
            assert len(kept) == 1
            span = [
                s for s in kept[0]["spans"] if s["name"] == "scorer/score"
            ][0]
            assert span["spanId"] == scorer_sid
            assert span["parentSpanId"] == "12" * 8

            # An untraced score pays nothing: no trace stamped, none kept.
            client.submit_score({"features": {"f": [1.0]}}).result(30)
            assert engine.last_req.trace is None
            assert len(flight_recorder().traces()) == 1
        finally:
            client.close()
    finally:
        server.close()
        reset_flight_recorder()


# ---------------------------------------------------------------------------
# Spool linkage
# ---------------------------------------------------------------------------


def test_spool_records_trace_linkage(tmp_path):
    from photon_tpu_torch.stream.spool import FeedbackSpool, read_segment, sealed_segments

    sdir = str(tmp_path)
    spool = FeedbackSpool(sdir)
    trace = dict(traceId="ab" * 16, parentSpanId="cd" * 8, sampled=True, forced=False)
    assert spool.observe_scored("u0", score=0.5, trace=trace)
    assert spool.observe_scored("u1", score=0.5)  # untraced rides along
    assert spool.observe_label("u0", 1.0)
    assert spool.observe_label("u1", 0.0)
    spool.flush()
    recs = {r["uid"]: r for s in sealed_segments(sdir) for r in read_segment(os.path.join(sdir, s))}
    assert recs["u0"]["trace"] == {"traceId": "ab" * 16, "parentSpanId": "cd" * 8}
    assert "trace" not in recs["u1"]
    spool.close()


# ---------------------------------------------------------------------------
# Acceptance: one request, one trace, two processes
# ---------------------------------------------------------------------------


def _read_banner(proc, timeout_s=600.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 5.0)
        if ready:
            line = proc.stdout.readline()
            if not line:
                break
            line = line.strip()
            if line.startswith("{"):
                return json.loads(line)
        if proc.poll() is not None:
            break
    raise AssertionError(
        "driver did not become ready; stderr:\n"
        + (proc.stderr.read() if proc.stderr else "")
    )




def test_one_score_produces_one_trace_across_two_processes(tmp_path):
    """``game_serving --workers 1`` with telemetry on: a request sent with a
    ``traceparent`` comes back from ``/v1/traces`` as ONE trace holding the
    worker's ``http/v1/score`` span and, nested under it from the scorer
    process, ``scorer/score``; ``/metrics`` carries the scorer's
    ``serve_*`` families labelled by replica; SIGTERM writes a valid run
    report."""
    import signal

    from photon_tpu_torch.obs.report import validate_record
    from test_torch_serving import _publish_generation

    root = str(tmp_path / "pub")
    os.makedirs(root)
    _publish_generation(root, "gen-1", 1.0)
    report = tmp_path / "serve.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.cli.game_serving", "--model-input-dir", root, "--port", "0",
         "--workers", "1", "--max-batch-size", "4", "--device", "cpu", "--telemetry-out", str(report),
         "--slo-gate"],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = _read_banner(proc)
        port = info["port"]
        tid = new_trace_id()
        body = {"features": {"shardA": {"a0": 1.0}, "shardB": {"b0": 1.0}}, "entityIds": {"userId": "user0"}}
        status, res = _post(port, "/v1/score", body, headers={"traceparent": f"00-{tid}-{'ef' * 8}-01"})
        assert status == 200 and "score" in res
        deadline = time.monotonic() + 30
        while True:
            _, _, raw = _get(port, "/v1/traces")
            mine = [e for e in json.loads(raw)["traces"] if e["traceId"] == tid]
            names = {s["name"] for e in mine for s in e["spans"]}
            if {"http/v1/score", "scorer/score"} <= names or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert len(mine) == 1, mine
        spans = {s["name"]: s for s in mine[0]["spans"]}
        http, scorer = spans["http/v1/score"], spans["scorer/score"]
        assert http["parentSpanId"] == "ef" * 8
        assert scorer["parentSpanId"] == http["spanId"]
        assert http["pid"] != scorer["pid"] and len(mine[0]["pids"]) == 2
        _, ctype, raw = _get(port, "/metrics")
        text = raw.decode()
        assert ctype.startswith("text/plain")
        for line in text.splitlines():
            assert line.startswith("#") or _PROM_LINE.match(line), line
        assert 'serve_requests_total{replica="scorer"}' in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    records = [json.loads(line) for line in report.read_text().splitlines()]
    for rec in records:
        validate_record(rec)
    assert {r["record"] for r in records} >= {"meta", "env", "span", "metric"}
    assert any(r["record"] == "metric" and r["metric"] == "serve_requests_total" for r in records)
