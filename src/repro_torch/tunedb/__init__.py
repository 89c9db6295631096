"""Tuning database of the port: the record store, serving state and frozen
dispatch plans, shape telemetry (process and fleet-global), plan
artifacts and their registry and follower, tuning sessions, the
performance models of dispatch's model tier, the retune controller that
closes the telemetry -> tune -> train -> serve loop, the tuning fleet
(``fleet``: lease-file jobs, workers, the coordinator's merge), the
fault-injection shim every bus file operation goes through when armed
(``chaos``) and its observability (``obs``: the metrics registry, the
status endpoint and its snapshot, the regression sentry and request
tracing); a subset of ``repro.tunedb``."""

from . import chaos
from .controller import (RetuneConfig, RetuneController, RetuneReport,
                         SpaceDecision)
from .model import (MODEL_SCHEMA_VERSION, ModelArtifactError, ModelSet,
                    PerfModel, backend_slug, clear_models, collect_samples,
                    default_models_dir, get_models, harvest, install_models,
                    train_models)
from .obs import (MetricsRegistry, RegressionSentry, SentryReport,
                  StatusServer, get_registry, plan_snapshot, reset_metrics,
                  status_snapshot)
from .session import (SessionReport, TuneJob, TuningSession,
                      backend_fingerprint, record_from_search)
from .store import (PLAN_HOT_K, DispatchPlan, RecordStore, ServingState,
                    Supersession, TuneRecord, clear_store, compile_plan,
                    install_serving, install_store, serving_state, shape_key)
from .telemetry import (FleetTelemetryView, ShapeTelemetry,
                        TelemetryExporter, clear_telemetry, get_telemetry,
                        record_shape)

__all__ = ["MODEL_SCHEMA_VERSION", "PLAN_HOT_K", "DispatchPlan",
           "FleetTelemetryView", "MetricsRegistry", "ModelArtifactError",
           "ModelSet", "PerfModel",
           "RecordStore", "RegressionSentry", "RetuneConfig",
           "RetuneController", "RetuneReport", "SentryReport", "ServingState",
           "SessionReport", "ShapeTelemetry", "SpaceDecision", "StatusServer",
           "Supersession", "TelemetryExporter", "TuneJob", "TuneRecord",
           "TuningSession",
           "backend_fingerprint", "chaos", "backend_slug", "clear_models",
           "clear_store", "clear_telemetry", "collect_samples", "compile_plan",
           "default_models_dir", "get_models", "get_registry", "get_telemetry",
           "harvest", "install_models", "install_serving", "install_store",
           "plan_snapshot", "record_from_search", "record_shape",
           "reset_metrics", "serving_state", "shape_key", "status_snapshot",
           "train_models"]
