"""Tuning database of the port: the record store and serving state, and
tuning sessions (a subset of ``repro.tunedb``)."""

from .session import (TuneJob, TuningSession, backend_fingerprint,
                      record_from_search)
from .store import (RecordStore, ServingState, TuneRecord, clear_store,
                    install_store, serving_state)

__all__ = ["RecordStore", "ServingState", "TuneJob", "TuneRecord",
           "TuningSession", "backend_fingerprint", "clear_store",
           "install_store", "record_from_search", "serving_state"]
