"""Serving observability of the port (``repro.tunedb.obs``): the metrics
registry, the status endpoint, the regression sentry and request tracing.

``metrics``
    The process-wide :class:`MetricsRegistry`: per-thread-sharded counters,
    gauges, ring-buffer histograms and scrape-time collectors over the
    serving stack's own counters; Prometheus text and JSON renders.

``snapshot``
    :func:`status_snapshot` / :func:`plan_snapshot`: the one serializer
    behind ``/status``, ``/plan``, ``tunedb stats --json`` and ``tunedb
    fleet status --json`` (its ``fleet``, ``follower`` and ``router``
    sections included).

``server``
    :class:`StatusServer`: a stdlib HTTP endpoint (``/metrics``,
    ``/status``, ``/plan``, ``/trace``, ``/healthz``), embedded in the
    engine via ``ServeConfig(status_port=...)`` or run standalone with
    ``python -m repro_torch.tunedb serve-status``.

``sentry``
    :class:`RegressionSentry`: generation diffs that gate
    ``install_serving``, the fleet's shard merge and the plan follower's
    installs, and back ``tunedb diff``.

``trace``
    :class:`Tracer`: spans with deterministic sampling and Chrome
    trace-event (Perfetto) export, enabled via
    ``ServeConfig(trace_sample=...)`` / :func:`enable_tracing`, surfaced at
    ``/trace`` and ``tunedb trace {export,summary}``; a fleet's worker
    span dumps merge back through :func:`collect_fleet_spans`.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, reset_metrics)
from .sentry import (DEFAULT_NOISE_MARGIN, Regression, RegressionSentry,
                     SentryReport, last_report)
from .server import StatusServer
from .snapshot import plan_snapshot, status_snapshot
from .trace import (Span, Tracer, chrome_trace, collect_fleet_spans,
                    enable_tracing, get_tracer, load_span_file,
                    new_trace_id, reset_tracing, summarize_spans)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_metrics",
    "DEFAULT_NOISE_MARGIN", "Regression", "RegressionSentry", "SentryReport",
    "last_report",
    "StatusServer",
    "plan_snapshot", "status_snapshot",
    "Span", "Tracer", "chrome_trace", "collect_fleet_spans",
    "enable_tracing", "get_tracer", "load_span_file", "new_trace_id",
    "reset_tracing", "summarize_spans",
]
