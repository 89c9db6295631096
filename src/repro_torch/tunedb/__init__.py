"""Tuning database of the port: the record store and serving state, tuning
sessions, and the performance models of dispatch's model tier (a subset
of ``repro.tunedb``)."""

from .model import (MODEL_SCHEMA_VERSION, ModelArtifactError, ModelSet,
                    PerfModel, backend_slug, clear_models, collect_samples,
                    default_models_dir, get_models, harvest, install_models,
                    train_models)
from .session import (TuneJob, TuningSession, backend_fingerprint,
                      record_from_search)
from .store import (RecordStore, ServingState, TuneRecord, clear_store,
                    install_serving, install_store, serving_state)

__all__ = ["MODEL_SCHEMA_VERSION", "ModelArtifactError", "ModelSet",
           "PerfModel", "RecordStore", "ServingState", "TuneJob",
           "TuneRecord", "TuningSession", "backend_fingerprint",
           "backend_slug", "clear_models", "clear_store", "collect_samples",
           "default_models_dir", "get_models", "harvest", "install_models",
           "install_serving", "install_store", "record_from_search",
           "serving_state", "train_models"]
