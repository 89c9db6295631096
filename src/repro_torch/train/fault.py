"""Fault tolerance: preemption handling, straggler mitigation, auto-resume
(the port's copy of ``repro.train.fault``, which imports no JAX).

On a real 1000+-node cluster the failure model is: (a) planned preemptions
(maintenance) delivered as SIGTERM with a grace window, (b) hard node loss
(job restarts from the latest checkpoint; the elastic loader reshards), and
(c) stragglers (a slow chip stretches every synchronous step).  This module
implements the coordinator-side machinery for (a) and (c); (b) is covered by
checkpoint.py + the trainer's auto-resume (trainer.py).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, List, Optional


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful "checkpoint now, then exit" flag.

    Usage:
        handler = PreemptionHandler()
        for step in ...:
            train_step(...)
            if handler.should_stop:
                save_checkpoint(...); break
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:          # non-main thread (tests)
                pass

    def _handle(self, signum, frame):
        self.should_stop = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step deadline tracking with an EWMA baseline.

    A synchronous SPMD step runs at the speed of the slowest chip; the
    monitor detects when recent steps exceed `threshold` x the EWMA baseline
    and invokes `on_straggler` — on a real cluster that callback triggers
    hot-spare swap / topology rebalance; the default callback records the
    event so the trainer can surface it in metrics and logs.
    """

    threshold: float = 2.0
    ewma_alpha: float = 0.1
    grace_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def __post_init__(self):
        self._ewma: Optional[float] = None
        self._seen = 0
        self.events: List[dict] = []
        self._t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._ewma is None:
            self._ewma = dt
        if self._seen > self.grace_steps and dt > self.threshold * self._ewma:
            evt = {"step": step, "step_time": dt, "baseline": self._ewma}
            self.events.append(evt)
            if self.on_straggler:
                self.on_straggler(step, dt, self._ewma)
        else:
            # only healthy steps update the baseline (a straggler must not
            # poison its own detector)
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * dt
        return dt
