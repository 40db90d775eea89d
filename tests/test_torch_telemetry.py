"""The port's run telemetry (photon_tpu_torch/obs), held to the cases of
tests/test_telemetry.py: trace spans, the metrics registry, the
schema-stable JSONL run report, and their integration points (pipeline
stage threads, the event emitter, the train_glm driver on the CPU). The
report's environment record reads torch: ``jax_backend`` holds "cpu"
here."""

import json
import threading

import numpy as np
import pytest

from photon_tpu_torch.obs import (
    TELEMETRY_SCHEMA,
    begin_run,
    collect_run_records,
    current_span_path,
    finalize_run_report,
    get_spans,
    registry,
    span,
    validate_record,
    write_run_report,
)
from photon_tpu_torch.utils.events import EventEmitter, setup_event
from photon_tpu_torch.utils.timed import Timed


@pytest.fixture(autouse=True)
def _fresh_run():
    begin_run()
    yield
    begin_run()


# ---------------------------------------------------------------------------
# trace spans
# ---------------------------------------------------------------------------


def test_span_nesting_same_thread():
    with span("cd") as p1:
        assert p1 == "cd"
        with span("iter0") as p2:
            assert p2 == "cd/iter0"
            with span("per-user/solve") as p3:
                assert p3 == "cd/iter0/per-user/solve"
    names = {s.name for s in get_spans()}
    assert names == {"cd", "cd/iter0", "cd/iter0/per-user/solve"}
    by_name = {s.name: s for s in get_spans()}
    assert by_name["cd/iter0"].parent == "cd"
    assert by_name["cd"].parent is None


def test_span_records_on_exception():
    with pytest.raises(RuntimeError):
        with span("failing"):
            raise RuntimeError("boom")
    assert [s.name for s in get_spans()] == ["failing"]


def test_span_explicit_parent_across_threads():
    """The cross-thread contract: a worker passes the captured parent path
    explicitly and its spans attach under it."""
    from photon_tpu_torch.obs import tracer

    def worker(parent):
        with tracer().span("stage", parent=parent):
            pass

    with span("ingest"):
        parent = current_span_path()
        t = threading.Thread(target=worker, args=(parent,))
        t.start()
        t.join()
    by_name = {s.name: s for s in get_spans()}
    assert by_name["ingest/stage"].parent == "ingest"
    assert by_name["ingest/stage"].thread != by_name["ingest"].thread


def test_pipeline_stage_threads_nest_under_consumer_span():
    """io/pipeline stage threads attach their spans under the consumer's
    innermost open span (captured at generator start)."""
    from photon_tpu_torch.io.pipeline import _run_staged
    from photon_tpu_torch.utils.timed import PipelineStats

    stats = PipelineStats()
    stages = [("double", lambda x: x * 2, lambda x: 0)]
    with span("ingest"):
        out = list(
            _run_staged(
                lambda: iter(range(5)), lambda x: 0, stages, stats,
                depth=2, overlap=True,
            )
        )
    assert sorted(out) == [0, 2, 4, 6, 8]
    stage_spans = [
        s for s in get_spans() if s.name.startswith("ingest/pipeline-stage/")
    ]
    assert len(stage_spans) == 2  # source thread + transform thread
    assert all(s.parent == "ingest" for s in stage_spans)
    threads = {s.thread for s in stage_spans}
    assert len(threads) == 2  # genuinely ran on worker threads


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_registry_instruments_and_labels():
    reg = registry()
    reg.counter("ops_total", kind="a").inc()
    reg.counter("ops_total", kind="a").inc(2)
    reg.counter("ops_total", kind="b").inc()
    assert reg.find("ops_total", kind="a").value == 3
    assert reg.find("ops_total", kind="b").value == 1
    assert reg.find("ops_total", kind="c") is None
    reg.gauge("occupancy").set(0.5)
    reg.gauge("occupancy").add(0.25)
    assert reg.find("occupancy").value == 0.75
    h = reg.histogram("iters")
    for v in (1, 5, 3):
        h.observe(v)
    d = h.as_dict()
    assert d["stats"] == dict(
        count=3, sum=9.0, min=1.0, max=5.0, mean=3.0,
        p50=3.0, p95=4.8, p99=4.96,
    )


def test_histogram_percentiles_deterministic_and_bounded():
    reg = registry()
    h = reg.histogram("latency_s")
    # Exact below the reservoir cap: matches numpy's linear interpolation.
    values = list(range(1000))
    for v in values:
        h.observe(float(v))
    p = h.percentiles()
    assert p["p50"] == pytest.approx(np.percentile(values, 50))
    assert p["p95"] == pytest.approx(np.percentile(values, 95))
    assert p["p99"] == pytest.approx(np.percentile(values, 99))

    # Past the cap the strided reservoir stays bounded and approximate:
    # identical sequences give identical (deterministic) results.
    h2 = reg.histogram("latency2_s")
    h3 = reg.histogram("latency3_s")
    n = h2.RESERVOIR_CAP * 3
    for i in range(n):
        h2.observe(float(i))
        h3.observe(float(i))
    assert len(h2._sample) < h2.RESERVOIR_CAP
    assert h2.percentiles() == h3.percentiles()
    assert h2.percentiles()["p50"] == pytest.approx(n / 2, rel=0.01)
    assert h2.count == n and h2.max == float(n - 1)

    # Empty histogram reports None, not a crash.
    assert registry().histogram("nothing").percentiles() == {
        "p50": None, "p95": None, "p99": None,
    }


def test_registry_rejects_kind_change_and_negative_counter():
    reg = registry()
    reg.counter("x").inc()
    with pytest.raises(TypeError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.counter("x").inc(-1)


def test_registry_thread_safety():
    """Concurrent increments on the same counter and concurrent create-on-
    first-use must not lose updates or raise."""
    reg = registry()
    threads_n, incs = 8, 500

    def hammer(i):
        for j in range(incs):
            reg.counter("hammered_total").inc()
            reg.counter("per_thread_total", thread=i % 4).inc()
            reg.histogram("obs", thread=i % 4).observe(j)

    ts = [threading.Thread(target=hammer, args=(i,)) for i in range(threads_n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert reg.find("hammered_total").value == threads_n * incs
    total = sum(
        reg.find("per_thread_total", thread=k).value for k in range(4)
    )
    assert total == threads_n * incs


# ---------------------------------------------------------------------------
# run report: schema + round trip
# ---------------------------------------------------------------------------


class _FakeFixedDiag:
    def diagnostics_dict(self):
        return dict(
            type="fixed_effect", iterations=4, value=0.25, grad_norm=1e-6,
            reason="GRADIENT_CONVERGED", converged=True, evals=9,
            eval_unit="objective_evals",
        )


class _FakeReDiag:
    def diagnostics_dict(self):
        return dict(
            type="random_effect", entities=10, converged=8, hit_max_iter=2,
            mean_iterations=3.5, max_iterations=7,
        )


def test_validate_record_is_strict():
    ok = dict(record="phase", name="read", duration_s=1.0)
    validate_record(ok)
    with pytest.raises(ValueError):
        validate_record(dict(record="phase", name="read"))  # missing field
    with pytest.raises(ValueError):
        validate_record({**ok, "extra": 1})  # extra field
    with pytest.raises(ValueError):
        validate_record({**ok, "duration_s": True})  # bool is not a number
    with pytest.raises(ValueError):
        validate_record(dict(record="nope"))


def test_run_report_round_trip(tmp_path):
    """Every record validates against the checked-in schema, survives JSONL
    serialization, and carries no NaN/Inf token (sanitized to null)."""
    with span("cd/iter0"):
        pass
    with Timed("driver/read-train"):
        pass
    registry().counter("cd_iterations_total").inc()
    registry().gauge("poisoned").set(float("nan"))  # must sanitize to null
    trackers = [{
        "label": "cfg[0]",
        "tracker": {"global": [_FakeFixedDiag()],
                    "per-user": [_FakeReDiag()]},
        "wall_times": {"global": [0.5]},
    }]
    records = collect_run_records("test", run_id="r1", trackers=trackers)
    for rec in records:
        validate_record(rec)
    kinds = {r["record"] for r in records}
    assert {"meta", "env", "phase", "span", "metric",
            "coordinate_descent"} <= kinds
    assert set(TELEMETRY_SCHEMA) >= kinds

    path = tmp_path / "run.jsonl"
    write_run_report(str(path), records)
    text = path.read_text()
    assert "NaN" not in text and "Infinity" not in text
    parsed = [json.loads(line) for line in text.splitlines()]
    assert parsed == [json.loads(json.dumps(r, sort_keys=True))
                      for r in records]

    # Tracker rows: wall joined where known, None where unknown.
    cd = {(r["coordinate"], r["cd_iteration"]): r
          for r in parsed if r["record"] == "coordinate_descent"}
    assert cd[("global", 0)]["wall_s"] == 0.5
    assert cd[("per-user", 0)]["wall_s"] is None
    assert cd[("global", 0)]["diagnostics"]["reason"] == "GRADIENT_CONVERGED"
    # Tracker publication landed in the metric snapshot.
    metrics = {(r["metric"], tuple(sorted(r["labels"].items())))
               for r in parsed if r["record"] == "metric"}
    assert any(m == "optimizer_convergence_total" for m, _ in metrics)
    assert any(m == "re_entities_trained_total" for m, _ in metrics)
    # The poisoned gauge became null, not NaN.
    (poisoned,) = [r for r in parsed
                   if r["record"] == "metric" and r["metric"] == "poisoned"]
    assert poisoned["value"] is None


def test_finalize_emits_optimization_log_event(tmp_path):
    seen = []
    emitter = EventEmitter()
    emitter.register(seen.append)
    path = tmp_path / "r.jsonl"
    records = finalize_run_report("test", path=str(path), emitter=emitter)
    assert path.exists() and records
    (ev,) = [e for e in seen if e.name == "PhotonOptimizationLogEvent"]
    assert ev.payload["kind"] == "run_telemetry"
    assert ev.payload["num_records"] == len(records)
    assert ev.payload["records"] == records


def test_begin_run_resets_all_state():
    with span("stale"):
        pass
    registry().counter("stale_total").inc()
    with Timed("stale-phase"):
        pass
    begin_run()
    assert get_spans() == []
    assert registry().find("stale_total") is None
    with Timed.records_lock():
        assert Timed.records == {}


# ---------------------------------------------------------------------------
# event emitter isolation
# ---------------------------------------------------------------------------


def test_emitter_isolates_listener_failures(caplog):
    """One raising listener must not starve later listeners (regression:
    emit() used to abort delivery at the first exception)."""
    seen = []
    emitter = EventEmitter()
    emitter.register(lambda e: (_ for _ in ()).throw(RuntimeError("bad")))
    emitter.register(seen.append)
    with caplog.at_level("ERROR", logger="photon_tpu"):
        emitter.emit(setup_event(driver="t"))
    assert [e.name for e in seen] == ["PhotonSetupEvent"]
    assert any("event listener" in r.message for r in caplog.records)


def test_emitter_register_by_name():
    import sys
    import types

    mod = types.ModuleType("_tele_listener_mod")
    mod.collected = []
    mod.listener = mod.collected.append
    sys.modules["_tele_listener_mod"] = mod
    try:
        emitter = EventEmitter()
        emitter.register_by_name("_tele_listener_mod:listener")
        emitter.emit(setup_event(driver="by-name"))
        assert [e.payload["driver"] for e in mod.collected] == ["by-name"]
    finally:
        del sys.modules["_tele_listener_mod"]


# ---------------------------------------------------------------------------
# Timed: lock and reset
# ---------------------------------------------------------------------------


def test_timed_records_shape_and_span_bridge():
    with Timed("phase-a"):
        pass
    with Timed.records_lock():
        assert set(Timed.records) == {"phase-a"}
        assert Timed.records["phase-a"] >= 0.0
    # Every Timed block also lands as a trace span.
    assert "phase-a" in {s.name for s in get_spans()}
    Timed.reset()
    with Timed.records_lock():
        assert Timed.records == {}


def test_timed_concurrent_phases():
    def work(i):
        with Timed(f"phase-{i}"):
            pass

    ts = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    with Timed.records_lock():
        assert len(Timed.records) == 16


# ---------------------------------------------------------------------------
# driver end-to-end: --telemetry-out
# ---------------------------------------------------------------------------


def test_train_glm_telemetry_out(tmp_path):
    from photon_tpu_torch.cli import train_glm

    rng = np.random.default_rng(7)
    libsvm = tmp_path / "t.txt"
    lines = []
    for _ in range(120):
        x = rng.normal(size=4)
        y = 1 if rng.uniform() < 1 / (1 + np.exp(-(x[0] - x[1]))) else -1
        feats = " ".join(f"{j + 1}:{x[j]:.4f}" for j in range(4))
        lines.append(f"{y:+d} {feats}")
    libsvm.write_text("\n".join(lines))
    out = tmp_path / "o"
    tele = tmp_path / "run.jsonl"
    args = train_glm.build_parser().parse_args([
        "--training-data", str(libsvm), "--format", "libsvm",
        "--output-dir", str(out),
        "--regularization-weights", "0.1,1",
        "--max-iterations", "10",
        "--telemetry-out", str(tele),
        "--device", "cpu",
    ])
    train_glm.run(args)

    text = tele.read_text()
    assert "NaN" not in text and "Infinity" not in text
    records = [json.loads(line) for line in text.splitlines()]
    for rec in records:
        validate_record(rec)
    by_kind = {}
    for r in records:
        by_kind.setdefault(r["record"], []).append(r)
    (meta,) = by_kind["meta"]
    assert meta["driver"] == "train_glm" and meta["schema_version"] == 2
    (env,) = by_kind["env"]
    assert env["device_count"] >= 1 and env["jax_backend"] == "cpu"
    # One solve span per λ (the driver's per-coordinate unit).
    solve_spans = [s for s in by_kind["span"]
                   if s["name"].startswith("glm/lambda")
                   and s["name"].endswith("/solve")]
    assert len(solve_spans) == 2
    # Solve-cache counters: both λ solves routed through the shared cache.
    # begin_run() zeroed the counters, so calls counts THIS run exactly;
    # traces may be 0 in a warm process (an earlier test already compiled
    # the key), in which case both dispatches are hits.
    metrics = {r["metric"]: r for r in by_kind["metric"]
               if not r["labels"]}
    assert metrics["solve_cache_calls"]["value"] == 2
    assert "solve_cache_traces" in metrics and "solve_cache_hits" in metrics
    assert (metrics["solve_cache_traces"]["value"]
            + metrics["solve_cache_hits"]["value"]) >= 2
    # Per-λ tracker rows with optimizer diagnostics.
    rows = by_kind["coordinate_descent"]
    assert len(rows) == 2
    assert all(r["diagnostics"]["type"] == "fixed_effect" for r in rows)
    assert all(r["wall_s"] is not None and r["wall_s"] >= 0 for r in rows)


def test_game_scoring_parser_has_telemetry_flags():
    from photon_tpu_torch.cli import game_scoring, game_training

    for mod in (game_scoring, game_training):
        args = mod.build_parser().parse_args(
            _minimal_args(mod) + [
                "--telemetry-out", "/tmp/x.jsonl",
                "--event-listener", "some.module:listener",
            ]
        )
        assert args.telemetry_out == "/tmp/x.jsonl"
        assert args.event_listener == ["some.module:listener"]


def _minimal_args(mod):
    name = mod.__name__.rsplit(".", 1)[-1]
    if name == "game_scoring":
        return [
            "--input-paths", "x", "--output-dir", "y",
            "--feature-shard-configurations", "name=s",
            "--model-input-dir", "m",
        ]
    return [
        "--input-paths", "x", "--output-dir", "y",
        "--feature-shard-configurations", "name=s",
        "--coordinate-configurations", "name=global,feature.shard=s",
        "--update-sequence", "global",
    ]


def test_run_report_byte_budget_rotates_and_drops_oldest(tmp_path):
    """The serving sink is long-lived: the report must respect a byte
    budget by (a) rotating the previous file to ``.1`` and (b) dropping the
    OLDEST span records first — never meta/env/metric — while counting
    what it shed."""
    from photon_tpu_torch.obs.report import write_run_report

    path = tmp_path / "run.jsonl"
    meta = {"record": "meta", "driver": "t", "run_id": "r",
            "schema_version": 1}
    spans = [{"record": "span", "name": f"s{i:04d}", "parent": None,
              "start_s": float(i), "duration_s": 0.1, "thread": "t"}
             for i in range(200)]
    write_run_report(str(path), [meta] + spans)
    full_size = path.stat().st_size
    def dropped():
        inst = registry().find("telemetry_records_dropped_total")
        return inst.value if inst is not None else 0

    before = dropped()

    write_run_report(str(path), [meta] + spans, max_bytes=full_size // 4)
    assert path.stat().st_size <= full_size // 4
    # Previous generation rotated aside, not clobbered.
    assert (tmp_path / "run.jsonl.1").stat().st_size == full_size
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    kinds = [r["record"] for r in lines]
    assert "meta" in kinds  # identity records never drop
    kept = [r["name"] for r in lines if r["record"] == "span"]
    # Oldest-first shedding: the tail of the run survives.
    assert kept and kept == [f"s{i:04d}" for i in
                             range(200 - len(kept), 200)]
    assert dropped() - before == 200 - len(kept)


def test_tracer_span_ring_bounds_memory():
    from photon_tpu_torch.obs.trace import Tracer

    tr = Tracer(max_spans=10)
    for i in range(25):
        with tr.span(f"s{i}"):
            pass
    spans = tr.spans()
    assert len(spans) == 10 and tr.dropped_spans == 15
    assert spans[-1].name == "s24"  # ring keeps the NEWEST spans
    tr.reset()
    assert tr.spans() == [] and tr.dropped_spans == 0
