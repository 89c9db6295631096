"""Re-measurement of the model tier's picks on the serving path (paper §6),
the port of ``repro.tunedb.measure``.

The paper's loop is measure → model → re-measure: the model proposes a
top-k and measurements on the card pick the winner.  A serving engine
cannot measure while it resolves a config (the resolution sits on the
prefill or the decode tick, and on CUDA inside a graph capture), so the
recipe is split in two, as in the reference:

* :class:`ServingMeasurer`: the ``(space, cfg, inputs) -> TFLOPS``
  callable that ``ServeConfig(measure="wallclock")`` installs as
  ``ModelSet.measurer``.  It times the port's kernel through the gated
  ``CheckedBackend(CudaEventBackend(device))``: a config the correctness
  gate rejects raises ``ConfigRejected`` and drops out of the candidates,
  so a measured winner always launches and computes right.  It refuses to
  run while a CUDA stream is capturing a graph (the timer captures graphs
  of its own and allocates operand copies larger than twice the L2).
* :class:`MeasureQueue`: the idle-gap scheduler.  With a queue attached
  (``ModelSet.measure_queue``) ``ModelSet.predict`` serves the model's
  argmax at once and pushes its top-k here; the engine drains a few shapes
  after each decode tick (``Engine.maybe_retune``) and commits each
  measured winner into the model set's memo and the live plan's overlay,
  so the shape's next resolution serves the measured config as a plan hit.

Where the port differs on purpose:

* The reference's ``"sim"`` mode (and its fallback to it off a TPU) is
  its simulated TPU v5e (``SimulatedTPUBackend``), which the port does not
  carry: nothing it says holds for the card.  ``"sim"`` is refused with a
  ``ValueError``; there is no fallback.
* Only a gate rejection (``ConfigRejected``) skips a candidate: any other
  failure of a measurement, of the memo commit or of the promotion raises
  (the reference swallows them).

Each measurement is counted in :attr:`ServingMeasurer.counts` and in the
metrics registry's ``tunedb_measurements_total{backend}``; with tracing on
it is timed in a ``measure.wallclock`` span under the thread's open trace,
or in a root of its own (always kept) where none is open.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.backend import CheckedBackend, CudaEventBackend
from repro_torch.core.space import ConfigRejected
from repro_torch.device import DeviceLike

from .model import _capturing
from .obs import trace as _trace
from .obs.metrics import get_registry
from .store import normalize_inputs, serving_state, shape_key

__all__ = ["MEASURE_MODES", "MeasureQueue", "ServingMeasurer"]

MEASURE_MODES = ("wallclock",)


class ServingMeasurer:
    """``ModelSet.measurer`` for a serving process: the kernel under a
    config timed on the card behind the correctness gate
    (``CheckedBackend(CudaEventBackend(device))``), in TFLOPS."""

    def __init__(self, mode: str = "wallclock", *,
                 device: DeviceLike = None) -> None:
        if mode == "sim":
            raise ValueError(
                "measure mode 'sim' is the reference's simulated TPU v5e "
                "(SimulatedTPUBackend), which the port does not carry: "
                "nothing it says holds for the card; use 'wallclock'")
        if mode not in MEASURE_MODES:
            raise ValueError(f"measure mode {mode!r}; pick one of "
                             f"{MEASURE_MODES}")
        self.mode = mode
        self.backend = CheckedBackend(CudaEventBackend(device=device))
        self.counts: Dict[str, int] = {"wallclock": 0}

    def __call__(self, space: str, cfg: Mapping[str, int],
                 inputs: Mapping[str, int]) -> float:
        if _capturing():
            raise RuntimeError(
                f"measure: timing a {space} config while a CUDA graph is "
                "being captured; drain the measure queue between ticks")
        tr = _trace._TRACER
        if tr is None:
            return self._measure(space, cfg, inputs)
        shape = ",".join(f"{k}={v}" for k, v in sorted(inputs.items()))
        name = f"measure.{self.mode}"
        ctx = tr.span(name, space=space, shape=shape)
        if ctx is _trace._NULL_SPAN:
            # no trace open on this thread (the engine's calibration, an
            # idle-gap drain outside a sampled tick): measurements are rare,
            # so each one is kept in a root of its own
            ctx = tr.root(name, trace_id=_trace.new_trace_id(), space=space,
                          shape=shape)
        with ctx as sp:
            tflops = self._measure(space, cfg, inputs)
            sp.attrs["backend"] = self.mode
            sp.attrs["tflops"] = round(tflops, 3)
        return tflops

    def _measure(self, space: str, cfg: Mapping[str, int],
                 inputs: Mapping[str, int]) -> float:
        tflops = float(self.backend.measure(space, cfg, inputs))
        self.counts[self.mode] += 1
        get_registry().counter(
            "tunedb_measurements_total",
            "serving-path kernel measurements by backend").inc(
                backend=self.mode)
        return tflops

    def stats(self) -> Dict[str, object]:
        return {"mode": self.mode, "counts": dict(self.counts)}


class MeasureQueue:
    """Thread-safe backlog of deferred §6 top-k re-measurements.

    ``push`` comes from ``ModelSet.predict`` (the dispatch path: one lock,
    one dedupe probe, one append; a full queue drops the push and counts
    it).  ``process`` runs in the idle gap after a decode tick."""

    def __init__(self, maxlen: int = 256) -> None:
        self._lock = threading.Lock()
        self._items: Deque[tuple] = deque()
        self._queued: set = set()
        self.maxlen = maxlen
        self.pushed = 0
        self.processed = 0
        self.dropped = 0                # pushes refused by a full queue
        self.upgrades = 0               # measured winner beat the argmax

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def push(self, space: str, backend: Optional[str],
             inputs: Mapping[str, int],
             candidates: List[Dict[str, int]]) -> bool:
        key = (space, backend, tuple(sorted(inputs.items())))
        with self._lock:
            if key in self._queued:
                return False
            if len(self._items) >= self.maxlen:
                self.dropped += 1
                return False
            self._queued.add(key)
            self._items.append((key, space, backend, dict(inputs),
                                [dict(c) for c in candidates]))
            self.pushed += 1
        return True

    def _pop(self) -> Optional[tuple]:
        with self._lock:
            if not self._items:
                return None
            item = self._items.popleft()
            self._queued.discard(item[0])
            return item

    def process(self, measurer, *, models=None, max_items: int = 2) -> int:
        """Re-measure up to ``max_items`` pending shapes; commit each
        measured winner into ``models``' memo and the live plan's overlay.
        A candidate the gate rejects is skipped; a shape whose candidates
        are all rejected keeps the model's argmax.  Returns the shapes
        processed."""
        done = 0
        while done < max_items:
            item = self._pop()
            if item is None:
                break
            _key, space, backend, inputs, candidates = item
            measured: List[Tuple[Dict[str, int], float]] = []
            for cfg in candidates:
                try:
                    measured.append((cfg,
                                     float(measurer(space, cfg, inputs))))
                except ConfigRejected:
                    continue
            done += 1
            self.processed += 1
            if not measured:
                continue
            cfg, tflops = max(measured, key=lambda t: t[1])
            if candidates and cfg != candidates[0]:
                self.upgrades += 1
            if models is not None:
                models.apply_measurement(space, backend, inputs, cfg, tflops)
            self._promote_plan(space, inputs, cfg)
        return done

    @staticmethod
    def _promote_plan(space: str, inputs: Mapping[str, int],
                      cfg: Mapping[str, int]) -> None:
        """Write the measured winner into the shape's plan-overlay entry
        (tier ``model``), so the frozen fast path serves it from the next
        call on; only while the plan belongs to the live store state (a
        stood-aside plan is recompiled at the next install)."""
        state = serving_state()
        plan, store = state.plan, state.store
        if plan is None:
            return
        if store is not None and store.version != plan.store_version:
            return
        plan.promote(space, shape_key(normalize_inputs(inputs)), cfg, "model")

    def stats(self) -> Dict[str, object]:
        with self._lock:
            backlog = len(self._items)
        return {"backlog": backlog, "pushed": self.pushed,
                "processed": self.processed, "dropped": self.dropped,
                "upgrades": self.upgrades, "maxlen": self.maxlen}
