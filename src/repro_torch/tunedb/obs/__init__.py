"""Serving observability of the port: the metrics registry and the
regression sentry (a subset of ``repro.tunedb.obs``).

``metrics``
    The process-wide :class:`MetricsRegistry`: per-thread-sharded counters,
    gauges, ring-buffer histograms and scrape-time collectors over the
    serving stack's own counters; Prometheus text and JSON renders.

``sentry``
    :class:`RegressionSentry`: generation diffs that gate
    ``install_serving`` and back ``tunedb diff``.

The reference's ``snapshot``, ``server`` (the status endpoint) and
``trace`` (request spans) wait for the tracing slice (ROADMAP A6).
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, reset_metrics)
from .sentry import (DEFAULT_NOISE_MARGIN, Regression, RegressionSentry,
                     SentryReport, last_report)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_metrics",
    "DEFAULT_NOISE_MARGIN", "Regression", "RegressionSentry", "SentryReport",
    "last_report",
]
