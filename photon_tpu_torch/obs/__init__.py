"""Port of photon_tpu/obs/__init__.py: run telemetry (trace spans, the
metrics registry and the JSONL run report), with the same exported names.

- :mod:`photon_tpu_torch.obs.trace` — hierarchical host-wall spans
  (``span("cd/iter3/per-user/solve")``), thread-safe, nestable across the
  ingest pipeline's stage threads. A span's wall is the host wall of
  asynchronous launches: no span synchronizes the device.
- :mod:`photon_tpu_torch.obs.metrics` — process-global counters / gauges /
  histograms with labels; the solve cache, pipeline stages, replay cache,
  shape bucketing, the out-of-core store and the serving engine publish here.
- :mod:`photon_tpu_torch.obs.report` — the run-report finalizer: spans +
  metrics + coordinate-descent tracker + environment as schema-stable JSONL
  (``--telemetry-out`` on the drivers) and as ``PhotonOptimizationLogEvent``
  payloads.

Drivers call :func:`begin_run` at entry and ``finalize_run_report`` at exit.
"""

from photon_tpu_torch.obs.export import (  # noqa: F401
    MockCollector,
    OTLPExporter,
    active_exporter,
    exporter_health,
    install_exporter,
    maybe_install_exporter,
    uninstall_exporter,
)
from photon_tpu_torch.obs.metrics import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE,
    MetricsRegistry,
    registry,
    render_prometheus,
    reset_registry,
)
from photon_tpu_torch.obs.report import (  # noqa: F401
    TELEMETRY_SCHEMA,
    collect_run_records,
    finalize_run_report,
    telemetry_sink_health,
    validate_record,
    write_run_report,
)
from photon_tpu_torch.obs.slo import SLOTracker  # noqa: F401
from photon_tpu_torch.obs.trace import (  # noqa: F401
    FlightRecorder,
    SpanRecord,
    TraceContext,
    attach_context,
    current_span_path,
    extract_context,
    flight_recorder,
    get_spans,
    merge_trace_dumps,
    mint_context,
    record_span,
    reset_flight_recorder,
    reset_tracer,
    span,
    tracer,
)


def begin_run() -> None:
    """Reset all run-scoped telemetry state: spans, the flight recorder,
    registry metrics, the ``Timed`` phase records, and the shared solve
    cache's counters (its captured graphs are kept — only the counters are
    run-scoped), so a second driver invocation in one process starts from a
    clean slate."""
    from photon_tpu_torch.algorithm.solve_cache import default_cache
    from photon_tpu_torch.utils.timed import Timed

    reset_tracer()
    reset_flight_recorder()
    reset_registry()
    Timed.reset()
    default_cache().reset_stats()
