"""Tuning database of the port (serving subset of ``repro.tunedb``)."""

from .store import (RecordStore, ServingState, TuneRecord, clear_store,
                    install_store, serving_state)

__all__ = ["RecordStore", "ServingState", "TuneRecord", "clear_store",
           "install_store", "serving_state"]
