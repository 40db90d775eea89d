"""Copy of photon_tpu/cli/obs_tool.py (framework-free; the port does not import it), run as
``python -m photon_tpu_torch.cli.obs_tool``, with one command the reference
lacks: ``report PATH`` summarizes a run report (``--telemetry-out``) of
either package offline, no server needed. ``experiments --publish-root``
reads the port's ``experiment_summary`` of a publish root that either
package wrote.

photon-tpu-obs: read the serving observability plane from a terminal.

Thin stdlib-only client for the three observability endpoints every
deployment shape serves (in-process, ``--workers N``, fleet front end):

- ``traces``  — ``GET /v1/traces``: the tail-based flight recorder's kept
  span trees (slow / errored / degraded / client-forced requests), merged
  across processes by trace id and printed as indented trees with the pid
  of the process each span ran in. ``--follow`` polls and prints only
  traces it has not shown yet.
- ``metrics`` — ``GET /metrics``: the fleet-merged Prometheus text
  exposition, optionally filtered to a name prefix.
- ``slo``     — ``GET /healthz``: the SLO block (per-objective burn rates
  and ok/warn/page state) plus the telemetry-sink health block.

Deliberately free of photon_tpu imports at module level: ``--help`` and a
scrape against a remote host must work without jax or the model stack.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional


def _get(url: str, timeout_s: float = 30.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:  # noqa: S310
        return resp.read()


def _get_json(url: str, timeout_s: float = 30.0):
    return json.loads(_get(url, timeout_s).decode())


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def _span_children(spans: List[dict]) -> Dict[Optional[str], List[dict]]:
    by_parent: Dict[Optional[str], List[dict]] = {}
    ids = {s.get("spanId") for s in spans}
    for s in spans:
        parent = s.get("parentSpanId")
        # A span whose parent was recorded in a process we could not
        # scrape still prints — promoted to a root rather than dropped.
        if parent not in ids:
            parent = None
        by_parent.setdefault(parent, []).append(s)
    for kids in by_parent.values():
        kids.sort(key=lambda s: s.get("start_s") or 0.0)
    return by_parent

def _format_span(s: dict, depth: int) -> str:
    dur = s.get("duration_s")
    dur_txt = f"{dur * 1000:.2f}ms" if isinstance(dur, (int, float)) else "?"
    return (
        f"  {'  ' * depth}{s.get('name', '?')}  {dur_txt}"
        f"  [pid {s.get('pid', '?')}  span {s.get('spanId', '?')}]"
    )


def format_trace(entry: dict) -> str:
    lat = entry.get("latencySeconds")
    lat_txt = f"{lat * 1000:.2f}ms" if isinstance(lat, (int, float)) else "?"
    head = (
        f"trace {entry.get('traceId', '?')}  reason={entry.get('reason', '?')}"
        f"  latency={lat_txt}  pids={entry.get('pids', [])}"
    )
    if entry.get("error"):
        head += f"  error={entry['error']!r}"
    if entry.get("degraded"):
        head += "  degraded"
    lines = [head]
    spans = entry.get("spans") or []
    by_parent = _span_children(spans)
    seen = set()

    def _walk(parent: Optional[str], depth: int) -> None:
        for s in by_parent.get(parent, []):
            sid = s.get("spanId")
            if sid in seen:
                continue
            seen.add(sid)
            lines.append(_format_span(s, depth))
            if sid is not None:
                _walk(sid, depth + 1)

    _walk(None, 0)
    return "\n".join(lines)


def cmd_traces(args: argparse.Namespace) -> int:
    url = args.url.rstrip("/") + "/v1/traces"
    if args.limit is not None:
        url += "?" + urllib.parse.urlencode({"limit": args.limit})
    wanted = getattr(args, "trace_id", None)
    shown = set()
    while True:
        try:
            payload = _get_json(url)
        except (urllib.error.URLError, OSError) as exc:
            print(f"photon-tpu-obs: {url}: {exc}", file=sys.stderr)
            return 1
        entries = payload.get("traces") or []
        if wanted:
            # Exemplar resolution: a trace_id scraped off a /metrics
            # histogram line jumps straight to its kept span tree.
            # Prefix match, so a truncated id from a dashboard works.
            entries = [
                e for e in entries
                if str(e.get("traceId", "")).startswith(wanted)
            ]
        fresh = [e for e in entries if e.get("traceId") not in shown]
        for e in fresh:
            shown.add(e.get("traceId"))
            if args.json:
                print(json.dumps(e))
            else:
                print(format_trace(e))
                print()
        if not args.follow:
            if not entries:
                if wanted:
                    print(
                        f"photon-tpu-obs: trace {wanted!r} not in the "
                        "flight recorder (evicted, or kept by another "
                        "process?)",
                        file=sys.stderr,
                    )
                    return 1
                print("(no kept traces)")
            return 0
        time.sleep(args.interval)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


# One exposition sample, optionally carrying an OpenMetrics exemplar
# (`name{labels} value # {trace_id="..."} exemplar_value`).
_SAMPLE_RE = re.compile(
    r'^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r'\s+(?P<value>[^\s#]+)'
    r'(?:\s+#\s+\{(?P<exlabels>[^}]*)\}\s+(?P<exvalue>\S+))?\s*$'
)
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_labels(blob: Optional[str]) -> Dict[str, str]:
    if not blob:
        return {}
    return {k: v for k, v in _LABEL_RE.findall(blob)}


def parse_prometheus(text: str) -> List[dict]:
    """Parse a Prometheus/OpenMetrics text scrape into sample dicts
    (``{"name", "labels", "value"}`` plus ``"exemplar"`` when the line
    carries one). Comment/HELP/TYPE lines and malformed lines are
    skipped — this is a triage tool, not a validator."""
    samples: List[dict] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        sample = {
            "name": m.group("name"),
            "labels": _parse_labels(m.group("labels")),
            "value": value,
        }
        if m.group("exvalue") is not None:
            try:
                ex_value = float(m.group("exvalue"))
            except ValueError:
                ex_value = None
            sample["exemplar"] = {
                "labels": _parse_labels(m.group("exlabels")),
                "value": ex_value,
            }
        samples.append(sample)
    return samples


def cmd_metrics(args: argparse.Namespace) -> int:
    url = args.url.rstrip("/") + "/metrics"
    try:
        text = _get(url).decode()
    except (urllib.error.URLError, OSError) as exc:
        print(f"photon-tpu-obs: {url}: {exc}", file=sys.stderr)
        return 1
    if getattr(args, "json", False):
        samples = parse_prometheus(text)
        if args.prefix:
            samples = [
                s for s in samples if s["name"].startswith(args.prefix)
            ]
        print(json.dumps({"samples": samples}, indent=2))
        return 0
    for line in text.splitlines():
        if not args.prefix:
            print(line)
            continue
        if line.startswith("#"):
            # Keep a TYPE/HELP header only when its metric matches.
            parts = line.split()
            if len(parts) >= 3 and parts[2].startswith(args.prefix):
                print(line)
        elif line.startswith(args.prefix):
            print(line)
    return 0


# ---------------------------------------------------------------------------
# quality
# ---------------------------------------------------------------------------


def quality_rows(samples: List[dict]) -> List[dict]:
    """Fold ``quality_*`` samples into one row per metric label set
    (model_version, tenant, re_type — plus whatever replica labels the
    fleet merge added). The label-delay summary's quantile label is the
    only one folded INTO a row rather than splitting rows."""
    rows: Dict[tuple, dict] = {}

    def row(labels: Dict[str, str]) -> dict:
        ident = {k: v for k, v in labels.items() if k != "quantile"}
        key = tuple(sorted(ident.items()))
        return rows.setdefault(key, {"labels": ident})

    for s in samples:
        name, labels, value = s["name"], s["labels"], s["value"]
        if name == "quality_auc":
            row(labels)["auc"] = value
        elif name == "quality_ece":
            row(labels)["ece"] = value
        elif name == "quality_auc_lift":
            row(labels)["auc_lift"] = value
        elif name in ("quality_logloss", "quality_deviance"):
            row(labels)[name[len("quality_"):]] = value
        elif name == "quality_label_delay_s":
            q = labels.get("quantile")
            if q == "0.5":
                row(labels)["label_delay_p50_s"] = value
            elif q == "0.95":
                row(labels)["label_delay_p95_s"] = value
        elif name == "quality_label_delay_s_count":
            row(labels)["labels_observed"] = value
    out = [r for r in rows.values() if len(r) > 1]
    out.sort(key=lambda r: sorted(r["labels"].items()))
    return out


def cmd_quality(args: argparse.Namespace) -> int:
    url = args.url.rstrip("/") + "/metrics"
    try:
        text = _get(url).decode()
    except (urllib.error.URLError, OSError) as exc:
        print(f"photon-tpu-obs: {url}: {exc}", file=sys.stderr)
        return 1
    samples = [
        s for s in parse_prometheus(text)
        if s["name"].startswith("quality_")
    ]
    rows = quality_rows(samples)
    if args.json:
        print(json.dumps({"quality": rows}, indent=2))
        return 0
    if not rows:
        print(
            "(no quality_* metrics in the scrape — no labelled feedback "
            "has reached the quality plane yet, or the window has not "
            "met min_events)"
        )
        return 1

    def fmt(v, digits=4):
        return f"{v:.{digits}f}" if isinstance(v, (int, float)) else "–"

    for r in rows:
        labels = r["labels"]
        ident = "  ".join(
            f"{k}={labels[k]}" for k in sorted(labels) if labels[k]
        )
        loss = (
            f"logloss={fmt(r['logloss'])}" if "logloss" in r
            else f"deviance={fmt(r['deviance'])}" if "deviance" in r
            else ""
        )
        print(f"{ident or '(unlabelled)'}")
        print(
            f"  auc={fmt(r.get('auc'))}"
            f"  lift={fmt(r.get('auc_lift'), 4) if 'auc_lift' in r else '–'}"
            f"  ece={fmt(r.get('ece'))}  {loss}"
        )
        observed = r.get("labels_observed")
        if isinstance(observed, float):
            observed = int(observed)
        print(
            f"  label_delay p50={fmt(r.get('label_delay_p50_s'), 3)}s"
            f" p95={fmt(r.get('label_delay_p95_s'), 3)}s"
            f"  observed={observed if observed is not None else '–'}"
        )
    return 0


# ---------------------------------------------------------------------------
# slo
# ---------------------------------------------------------------------------


def _find_block(stats: dict, key: str) -> Optional[dict]:
    """Depth-first search for the named block: the fleet ``/healthz``
    nests engine stats per replica."""
    if not isinstance(stats, dict):
        return None
    if isinstance(stats.get(key), dict):
        return stats[key]
    for v in stats.values():
        found = _find_block(v, key) if isinstance(v, dict) else None
        if found is not None:
            return found
    return None


def cmd_slo(args: argparse.Namespace) -> int:
    url = args.url.rstrip("/") + "/healthz"
    try:
        stats = _get_json(url)
    except (urllib.error.URLError, OSError) as exc:
        print(f"photon-tpu-obs: {url}: {exc}", file=sys.stderr)
        return 1
    slo = _find_block(stats, "slo")
    sink = _find_block(stats, "telemetry_sink")
    exporter = _find_block(stats, "otlp_exporter")
    if args.json:
        print(json.dumps(
            {
                "slo": slo,
                "telemetry_sink": sink,
                "otlp_exporter": exporter,
            },
            indent=2,
        ))
        return 0
    if slo is None:
        print("(no slo block in /healthz)")
        return 1
    print(f"overall state: {slo.get('state', '?')}")
    for name, obj in (slo.get("objectives") or {}).items():
        burns = "  ".join(
            f"{w}={b:.2f}" if isinstance(b, (int, float)) else f"{w}=–"
            for w, b in (obj.get("burn") or {}).items()
        )
        print(
            f"  {name}: state={obj.get('state', '?')}"
            f" target={obj.get('target')}"
            f" events={obj.get('events')}  burn: {burns or '–'}"
        )
    if sink is not None:
        print(
            "telemetry sink: "
            f"bytes_written={sink.get('bytes_written')}"
            f" records_dropped={sink.get('records_dropped')}"
            f" write_failures={sink.get('write_failures')}"
            f" last_write_error={sink.get('last_write_error')!r}"
        )
    if exporter is not None:
        print(
            "otlp exporter: "
            f"endpoint={exporter.get('endpoint')}"
            f" queue={exporter.get('queue_depth')}/{exporter.get('queue_cap')}"
            f" exported_spans={exporter.get('exported_spans')}"
            f" dropped_spans={exporter.get('dropped_spans')}"
            f" consecutive_failures={exporter.get('consecutive_failures')}"
            f" last_error={exporter.get('last_error')!r}"
        )
    return 0


# ---------------------------------------------------------------------------
# experiments
# ---------------------------------------------------------------------------


def _render_experiments(doc: dict) -> int:
    exps = doc.get("experiments") or []
    if not exps:
        print(
            "(no experiment generations — nothing under the publish root "
            "carries an `experiment` manifest tag)"
        )
        return 1
    for exp in exps:
        print(
            f"experiment {exp.get('id')}: rounds={exp.get('rounds')}"
            f" candidates={len(exp.get('candidates') or [])}"
            f" poisoned={len(exp.get('poisoned') or [])}"
        )
        for c in exp.get("candidates") or []:
            obs = c.get("observation")
            obs_s = f"{obs:.6f}" if isinstance(obs, (int, float)) else "–"
            flags = []
            if c.get("poisoned"):
                flags.append(f"POISONED({c.get('poisonReason', '?')})")
            if c.get("winner"):
                flags.append("WINNER")
            print(
                f"  r{c.get('round')} {c.get('paramsKey')}"
                f"  gen={c.get('generation')}"
                f"  obs={obs_s}"
                f"  {' '.join(flags)}".rstrip()
            )
        best = exp.get("best")
        if best:
            print(
                f"  best: {best.get('generation')}"
                f" obs={best.get('observation')}"
            )
    return 0


def cmd_experiments(args: argparse.Namespace) -> int:
    if args.publish_root:
        # Offline rollup straight from the generation manifests — works on
        # the publish root with no server running (the manifests ARE the
        # experiment store).
        from photon_tpu_torch.experiment import experiment_summary

        doc = experiment_summary(args.publish_root)
    else:
        url = args.url.rstrip("/") + "/v1/experiment"
        try:
            doc = _get_json(url)
        except (urllib.error.URLError, OSError) as exc:
            print(f"photon-tpu-obs: {url}: {exc}", file=sys.stderr)
            return 1
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    return _render_experiments(doc)


# ---------------------------------------------------------------------------
# report (a run report's JSONL, offline)
# ---------------------------------------------------------------------------


def summarize_report(records: List[dict]) -> dict:
    """One run report's records folded into a summary: the meta and env
    records, record counts by kind, phases, the span tree (wall per span
    path, summed over repeats; parent links from the records), the metric
    samples (value, or histogram count and sum), and the
    coordinate-descent rows."""
    kinds: Dict[str, int] = {}
    for r in records:
        kinds[r.get("record", "?")] = kinds.get(r.get("record", "?"), 0) + 1
    spans: Dict[str, dict] = {}
    for r in records:
        if r.get("record") == "span":
            s = spans.setdefault(r["name"], {"parent": r.get("parent"), "count": 0, "wall_s": 0.0})
            s["count"] += 1
            s["wall_s"] += float(r.get("duration_s") or 0.0)
    metrics = []
    for r in records:
        if r.get("record") == "metric":
            stats = r.get("stats") or {}
            metrics.append({"metric": r["metric"], "type": r["type"], "labels": r.get("labels") or {},
                            "value": r.get("value") if r.get("value") is not None else stats.get("count"),
                            "sum": stats.get("sum")})
    first = {k: next((r for r in records if r.get("record") == k), None) for k in ("meta", "env")}
    return {
        "meta": first["meta"], "env": first["env"], "records": kinds,
        "phases": {r["name"]: r["duration_s"] for r in records if r.get("record") == "phase"},
        "spans": spans, "metrics": metrics,
        "coordinate_descent": [{k: r.get(k) for k in ("label", "coordinate", "cd_iteration", "wall_s")}
                               for r in records if r.get("record") == "coordinate_descent"],
    }


def cmd_report(args: argparse.Namespace) -> int:
    try:
        with open(args.path) as f:
            records = [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError) as exc:
        print(f"photon-tpu-obs: {args.path}: {exc}", file=sys.stderr)
        return 1
    doc = summarize_report(records)
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0 if records else 1
    meta, env = doc["meta"] or {}, doc["env"] or {}
    print(f"run {meta.get('run_id', '?')}  driver={meta.get('driver', '?')}"
          f"  schema={meta.get('schema_version', '?')}  backend={env.get('jax_backend', '?')}"
          f"  devices={env.get('device_count', '?')}")
    print("records: " + "  ".join(f"{k}={v}" for k, v in sorted(doc["records"].items())))
    kids: Dict[Optional[str], List[str]] = {}
    for name, s in doc["spans"].items():
        kids.setdefault(s["parent"] if s["parent"] in doc["spans"] else None, []).append(name)

    def _walk(parent: Optional[str], depth: int) -> None:
        for name in sorted(kids.get(parent, [])):
            s = doc["spans"][name]
            print(f"  {'  ' * depth}{name.rsplit('/', 1)[-1] if parent else name}"
                  f"  {s['wall_s'] * 1000:.2f}ms  x{s['count']}")
            _walk(name, depth + 1)

    if doc["spans"]:
        print("spans:")
        _walk(None, 0)
    for m in doc["metrics"]:
        if args.prefix and not m["metric"].startswith(args.prefix):
            continue
        labels = ",".join(f"{k}={v}" for k, v in sorted(m["labels"].items()))
        print(f"  {m['metric']}{{{labels}}} {m['type']} {m['value']}")
    for r in doc["coordinate_descent"]:
        print(f"  cd {r['label']} {r['coordinate']} pass {r['cd_iteration']} wall_s={r['wall_s']}")
    return 0 if records else 1


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon-tpu-obs",
        description="Inspect a photon-tpu serving endpoint's traces, "
        "metrics, and SLO state.",
    )
    p.add_argument(
        "--url", default="http://127.0.0.1:8000",
        help="serving endpoint base URL (default %(default)s)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("traces", help="dump kept flight-recorder traces")
    t.add_argument("trace_id", nargs="?", default=None,
                   help="show only this trace id (or unique prefix) — "
                        "paste an exemplar's trace_id from a /metrics "
                        "histogram line; exits 1 when absent")
    t.add_argument("--limit", type=int, default=None,
                   help="newest N traces only")
    t.add_argument("--follow", action="store_true",
                   help="poll and print traces as they are kept")
    t.add_argument("--interval", type=float, default=2.0,
                   help="poll interval for --follow (default %(default)s)")
    t.add_argument("--json", action="store_true",
                   help="one JSON entry per line instead of trees")
    t.set_defaults(fn=cmd_traces)

    m = sub.add_parser("metrics", help="dump the Prometheus text scrape")
    m.add_argument("--prefix", default=None,
                   help="only metrics whose name starts with this")
    m.add_argument("--json", action="store_true",
                   help="parse the exposition (labels, values, exemplars) "
                        "and print one JSON document")
    m.set_defaults(fn=cmd_metrics)

    q = sub.add_parser(
        "quality",
        help="per-version/tenant online model quality (AUC, ECE, lift vs "
             "baseline, label delay) from the fleet-merged /metrics scrape",
    )
    q.add_argument("--json", action="store_true",
                   help="rows as one JSON document")
    q.set_defaults(fn=cmd_quality)

    s = sub.add_parser("slo", help="show SLO burn state from /healthz")
    s.add_argument("--json", action="store_true",
                   help="raw slo + telemetry_sink blocks as JSON")
    s.set_defaults(fn=cmd_slo)

    e = sub.add_parser(
        "experiments",
        help="per-experiment candidate lifecycle rollup (rounds, "
             "observations, poisons, winner) from a live /v1/experiment "
             "endpoint or straight from a publish root's manifests",
    )
    e.add_argument("--publish-root", default=None,
                   help="read generation manifests from this dir instead "
                        "of hitting --url (works with no server running)")
    e.add_argument("--json", action="store_true",
                   help="rollup as one JSON document")
    e.set_defaults(fn=cmd_experiments)

    r = sub.add_parser(
        "report",
        help="summarize a run report (--telemetry-out JSONL) offline: "
             "records, span tree, metrics, coordinate-descent rows",
    )
    r.add_argument("path", help="the run report's path")
    r.add_argument("--prefix", default=None,
                   help="only metrics whose name starts with this")
    r.add_argument("--json", action="store_true",
                   help="the summary as one JSON document")
    r.set_defaults(fn=cmd_report)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
