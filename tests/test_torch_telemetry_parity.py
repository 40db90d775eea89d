"""The port's run reports against the reference's, and telemetry that
changes nothing else.

On one small seeded fixture (the GAME driver tests' Avro rows: 400 rows,
6 global and 3 per-item features, 8 users, 5 items; and a 300-row, 4-feature
LIBSVM file), the reference's ``train_glm`` and ``game_training`` and the
port's (``--device cpu``) each write ``--telemetry-out``. The two reports
have:
- the same record kinds, span names and parent links;
- the same metric names, types and label keys;
- equal deterministic counters (coordinate-descent passes, skipped
  entities, shape-bucket rows, solve-cache calls);
- coordinate-descent rows whose diagnostics agree at the drivers' float32
  tolerance, 1e-3 (reasons and convergence counts exactly; see
  ``F32_STOP_DEPENDENT``);
and each package's ``validate_record`` accepts the other's report, and
each package's ``obs_tool`` reads the other's.

Differences kept on purpose are named in the lists below, with the reason.

Telemetry on must not change the result: ``game_training`` with
``--telemetry-out`` writes the same model files (every Avro record and
every other file's bytes equal), makes the
same host reads before the report's finalize, and the same solve-cache
counts, as without it.
"""

import json
import os
from pathlib import Path

import pytest

from photon_tpu.cli import game_training as j_game_training
from photon_tpu.cli import obs_tool as j_obs_tool
from photon_tpu.cli import train_glm as j_train_glm
from photon_tpu.obs.report import validate_record as j_validate_record
from test_torch_game_drivers import GLOBAL, PER_ITEM, PER_USER, SHARDS, _records, _write

from photon_tpu_torch.cli import game_training, obs_tool, train_glm
from photon_tpu_torch.obs.report import validate_record

TOL = 1e-3

# Metrics only one package has, with the reason.
PORT_ONLY_METRICS = {
    # SolveCacheStats counts CUDA graph captures and replays, eager
    # dispatches, static-buffer copies and X passes, which a JAX cache has
    # no counterpart of; the report publishes them beside the reference's
    # gauges.
    "solve_cache_captures", "solve_cache_replays", "solve_cache_eager_calls", "solve_cache_copied_bytes",
    "solve_cache_x_passes_run",
}
REFERENCE_ONLY_METRICS = set()
# Spans only one package has, with the reason.
PORT_ONLY_SPANS = set()
REFERENCE_ONLY_SPANS = set()
# Label keys of solve_cache_traces_by_key name the cache keys, which are the
# packages' own (a JAX trace key holds shapes and static arguments, the
# port's its program's); compared by count of keys, not by value.
KEYED_BY_PACKAGE = {"solve_cache_traces_by_key"}
# Sampled by the host-memory watchdog's thread every 0.5 s: present in a
# report when a sample fell after the run's begin_run, in either package.
SAMPLED = {"host_rss_bytes", "host_rss_limit_bytes", "host_rss_pressure_level"}
# Diagnostics that depend on where an f32 solve stops: the drivers read
# float32, where the last ulp of the objective decides the stopping
# iteration (ROADMAP queue 3), so the two packages may stop an iteration
# apart. Objective values, reasons and convergence counts are held.
F32_STOP_DEPENDENT = {"iterations", "evals", "grad_norm", "mean_iterations", "max_iterations"}
# Counters held equal exactly.
DETERMINISTIC = ("cd_iterations_total", "re_entities_skipped_total", "bucket_alloc_total", "bucket_used_total",
                 "solve_cache_calls")


def _read(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _spans(records):
    return {(r["name"], r["parent"]) for r in records if r["record"] == "span"}


def _metric_shapes(records):
    return {(r["metric"], r["type"], tuple(sorted(r["labels"]))) for r in records if r["record"] == "metric"
            and r["metric"] not in KEYED_BY_PACKAGE | SAMPLED}


def _metric_values(records, name):
    return {tuple(sorted(r["labels"].items())): (r["value"] if r["value"] is not None else r["stats"]["count"])
            for r in records if r["record"] == "metric" and r["metric"] == name}


def _cd_rows(records):
    return {(r["label"], r["coordinate"], r["cd_iteration"]): r["diagnostics"]
            for r in records if r["record"] == "coordinate_descent"}


def _close(a, b):
    return abs(a - b) <= TOL * max(1.0, abs(a), abs(b))


def _assert_diagnostics_agree(j, t):
    assert set(j) == set(t)
    for key in j:
        dj, dt = j[key], t[key]
        assert set(dj) == set(dt), key
        for field, vj in dj.items():
            if field in F32_STOP_DEPENDENT:
                continue
            vt = dt[field]
            if isinstance(vj, float) and not isinstance(vj, bool):
                assert _close(vj, vt), (key, field, vj, vt)
            else:
                assert vj == vt, (key, field, vj, vt)


def _assert_reports_agree(j, t):
    assert {r["record"] for r in j} == {r["record"] for r in t}
    j_spans = {s for s in _spans(j) if s[0] not in REFERENCE_ONLY_SPANS}
    t_spans = {s for s in _spans(t) if s[0] not in PORT_ONLY_SPANS}
    assert j_spans == t_spans
    j_shapes = {m for m in _metric_shapes(j) if m[0] not in REFERENCE_ONLY_METRICS}
    t_shapes = {m for m in _metric_shapes(t) if m[0] not in PORT_ONLY_METRICS}
    assert j_shapes == t_shapes, (j_shapes ^ t_shapes)
    assert len(_metric_values(j, "solve_cache_traces_by_key")) > 0
    assert len(_metric_values(t, "solve_cache_traces_by_key")) > 0
    for name in DETERMINISTIC:
        assert _metric_values(j, name) == _metric_values(t, name), name
    _assert_diagnostics_agree(_cd_rows(j), _cd_rows(t))
    for rec in t:
        j_validate_record(rec)
    for rec in j:
        validate_record(rec)


def _assert_obs_tools_read(j_path, t_path, capsys):
    """The port's obs_tool summarizes both reports alike; the reference's
    obs_tool, which has no report command, renders the port's span tree
    through its trace renderer."""
    summaries = []
    for path in (j_path, t_path):
        assert obs_tool.main(["report", str(path), "--json"]) == 0
        summaries.append(json.loads(capsys.readouterr().out))
    j_sum, t_sum = summaries
    assert j_sum["records"].keys() == t_sum["records"].keys()
    assert {k: v["parent"] for k, v in j_sum["spans"].items()} == {k: v["parent"] for k, v in t_sum["spans"].items()}
    spans = [r for r in _read(t_path) if r["record"] == "span"]
    entry = {"traceId": "report", "spans": [
        {"name": s["name"], "spanId": s["name"], "parentSpanId": s["parent"], "duration_s": s["duration_s"],
         "start_s": s["start_s"]} for s in spans]}
    text = j_obs_tool.format_trace(entry)
    assert all(s["name"] in text for s in spans)


@pytest.fixture(scope="module")
def game_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("telemetry_parity")
    return {"dir": d, "train": _write(d / "train.avro", _records(400, 23, list(range(8)))),
            "valid": _write(d / "valid.avro", _records(200, 24, list(range(10))))}


def _game_argv(files, out, *extra):
    return ["--input-paths", files["train"], "--validation-paths", files["valid"], "--output-dir", str(out), *SHARDS,
            "--coordinate-configurations", GLOBAL, PER_USER, PER_ITEM, "--update-sequence", "global,perUser,perItem",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC", "--re-active-set", *extra]


def test_game_training_reports_match_reference(game_files, tmp_path, capsys):
    j_path, t_path = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    j_game_training.run(j_game_training.build_parser().parse_args(
        _game_argv(game_files, tmp_path / "j", "--telemetry-out", str(j_path))))
    game_training.main(_game_argv(game_files, tmp_path / "t", "--telemetry-out", str(t_path), "--device", "cpu"))
    capsys.readouterr()
    j, t = _read(j_path), _read(t_path)
    _assert_reports_agree(j, t)
    # Every coordinate has its pass spans with solve and score under them
    # (nested in the estimator's configuration span).
    names = {r["name"].split("]/", 1)[-1] for r in t if r["record"] == "span"}
    for it in (0, 1):
        for cid in ("global", "perUser", "perItem"):
            assert {f"cd/iter{it}/{cid}", f"cd/iter{it}/{cid}/solve", f"cd/iter{it}/{cid}/score"} <= names
    _assert_obs_tools_read(j_path, t_path, capsys)


def test_train_glm_reports_match_reference(tmp_path, capsys):
    from test_torch_train_glm import _write_libsvm

    data = _write_libsvm(tmp_path / "t.txt", 300, 4, seed=41)
    argv = ["--training-data", data, "--format", "libsvm", "--regularization-weights", "0.1,1,10"]
    j_path, t_path = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    j_train_glm.run(j_train_glm.build_parser().parse_args(
        argv + ["--output-dir", str(tmp_path / "j"), "--telemetry-out", str(j_path)]))
    train_glm.main(argv + ["--output-dir", str(tmp_path / "t"), "--telemetry-out", str(t_path), "--device", "cpu"])
    capsys.readouterr()
    _assert_reports_agree(_read(j_path), _read(t_path))
    _assert_obs_tools_read(j_path, t_path, capsys)


def _model_files(root):
    """Every file of a model directory: an Avro container's decoded records
    (its sync marker is random), any other file's bytes."""
    from photon_tpu_torch.io.avro import read_avro_records

    return {str(p.relative_to(root)): (read_avro_records(str(p)) if p.suffix == ".avro" else p.read_bytes())
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def test_game_training_telemetry_changes_nothing_else(game_files, tmp_path, monkeypatch):
    """With ``--telemetry-out`` the model files are byte-equal, and the host
    reads before the report's finalize and the solve-cache counts equal
    the run without it."""
    from photon_tpu_torch.algorithm.solve_cache import default_cache
    from photon_tpu_torch.obs import report
    from photon_tpu_torch.optim.common import HOST_READS

    seen = {}
    real = report.collect_run_records

    def counting(*args, **kwargs):
        seen["reads"] = HOST_READS.count - seen["reads0"]
        return real(*args, **kwargs)

    monkeypatch.setattr(report, "collect_run_records", counting)
    runs = {}
    for name, extra in (("off", []), ("on", ["--telemetry-out", str(tmp_path / "on.jsonl")])):
        seen["reads0"] = HOST_READS.count
        game_training.main(_game_argv(game_files, tmp_path / name, "--device", "cpu", *extra))
        runs[name] = dict(reads=seen.pop("reads"), cache=default_cache().stats.counts(),
                          files=_model_files(tmp_path / name / "best"))
    assert runs["on"]["files"] == runs["off"]["files"] and runs["on"]["files"]
    assert runs["on"]["reads"] == runs["off"]["reads"]
    assert runs["on"]["cache"] == runs["off"]["cache"]
    assert os.path.getsize(tmp_path / "on.jsonl") > 0
