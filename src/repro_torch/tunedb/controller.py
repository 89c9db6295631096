"""Continuous retuning: the telemetry -> tune -> train -> serve loop, closed.

A port of ``repro.tunedb.controller``.  A :class:`RetuneController` keeps
an epoch baseline snapshot of the global
:class:`~repro_torch.tunedb.telemetry.ShapeTelemetry` and, on every
``maybe_retune()`` poll (the serving engine polls every
``ServeConfig.retune_interval`` decode ticks):

  1. **detect**: ``telemetry.diff(baseline)`` gives each space's drift (the
     total-variation distance between the baseline's hot-shape mass and
     the window's since it) and the window's shapes; the controller adds
     the *untuned mass*, the share of window calls on shapes with no
     record under the pinned fingerprint.
  2. **tune**: when drift or untuned mass crosses its threshold (and the
     window has ``min_calls`` calls), a
     :class:`~repro_torch.tunedb.session.TuningSession` tunes the window's
     novel hot shapes and commits ``source="retune"`` records (and the
     measured top-k as samples).  On the card the tuner's backend is
     ``CheckedBackend(CudaEventBackend)``: the gate, then the kernels
     timed.
  3. **train**: the affected ``(space, backend)`` regressors retrain from
     the grown log (``train_models``); the others are carried over.
  4. **swap**: ``install_serving`` flips store and models to a new
     generation in one assignment (gated by a
     :class:`~repro_torch.tunedb.obs.sentry.RegressionSentry` when
     ``RetuneConfig.sentry`` is set) and the baseline advances.  The port's
     engine captures its CUDA graphs again at a new generation, so the
     swap reaches the device at its next tick and at each prompt length's
     next prefill.

A triggered epoch runs **inline** on the polling thread (the tick that
trips it pays for it) or, with ``async_mode``, on a daemon thread: the poll
submits and returns, and the first poll after the swap returns the
report.  A background epoch older than ``session_window_s`` is flagged by
a watchdog that sets its cancel event.  Admission is budgeted:
``cooldown_ticks`` spaces epochs along the engine's tick clock,
``max_sessions_per_window`` caps them per wall-clock window, and
``min_gain`` skips epochs whose projected gain (the model's best predicted
TFLOPS over what the nearest record serves) is too small.

With ``fleet_dir`` the epoch runs through the fleet instead (always on a
background thread): its shapes are published as lease-file jobs (each
carrying its telemetry count and the epoch's trace id), worker processes
(``python -m repro_torch.tunedb fleet worker``) tune them on the card, a
:class:`~repro_torch.tunedb.fleet.Coordinator` requeues crashed workers'
jobs and merges their shards into the store, and only then does the epoch
retrain and swap.  The store must have a file behind it (the workers'
shards live beside it): an in-memory store is refused with a warning, and
the epoch runs as an in-process async session.  ``RetuneConfig.publish``
names a plan registry each swapped generation's plan is published to, for
follower replicas (``tunedb.plans.PlanFollower``).

With tracing on, an async epoch's submit-to-swap window is one detached
``retune.epoch`` span, begun on the submitting thread (in its open trace,
else in an always-kept trace of its own) and ended by the epoch's thread
at the swap, as in the reference; a fleet epoch's final merge is a
``fleet.merge`` span under it, and the workers' ``fleet.job`` roots carry
its trace id.  An inline epoch runs inside the polling tick's
``engine.tick`` root and opens no span of its own.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple

from .obs import trace as _trace
from .obs.metrics import get_registry
from .session import SessionReport, TuningSession, backend_fingerprint
from .store import RecordStore, input_key, install_serving, serving_state
from .telemetry import ShapeTelemetry, SpaceDrift, get_telemetry

log = logging.getLogger(__name__)

HISTORY_CAP = 64        # epochs kept in the history

def _tracer():
    """The process-global tracer, ``None`` while tracing is off: one module
    attribute read per epoch, so the retune path makes no instrument call
    then."""
    return _trace._TRACER


def _default_tuner_factory(space_name: str, device=None):
    """Train an input-aware tuner for ``space_name`` at the reference's
    sizes (4000 samples, hidden (32, 64, 32), 12 epochs), labelled on
    ``device`` (the card by default) by ``CheckedBackend(
    CudaEventBackend)``: the port has no simulator, so every label is a
    gated timing of the port's own kernel (on the CPU, of its plain
    version at a shrunken instance).
    That takes minutes a space on an H100 (chip_smoke's tune phase labels
    320 gated GEMM samples in 15–20 s: 190–250 s for 4000), so a serving
    process should pass its tuners in (``Engine(retune_tuners=)``); every
    caller in this repository does."""
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    from repro_torch.core.space import SPACES
    from repro_torch.core.tuner import InputAwareTuner
    return InputAwareTuner.train(
        SPACES[space_name], n_samples=4000, hidden=(32, 64, 32), epochs=12,
        backend=CheckedBackend(CudaEventBackend(device=device)), seed=0)


@dataclasses.dataclass(frozen=True)
class RetuneConfig:
    """Thresholds and session/retrain knobs for the retune loop."""

    drift_threshold: float = 0.25        # TV distance that counts as a shift
    untuned_mass_threshold: float = 0.5  # window mass on record-less shapes
    min_calls: int = 32                  # window calls before a space is judged
    top_k_shapes: int = 4                # novel hot shapes per session
    workers: int = 2
    remeasure: bool = True               # session top-k re-measurement (§6)
    retrain: bool = True                 # retrain regressors after a session
    min_train_samples: int = 24
    train_epochs: int = 20
    seed: int = 0
    # engine ticks a retune blocks the next trigger for (0: no cooldown;
    # needs the caller's tick clock)
    cooldown_ticks: int = 0
    # sessions allowed per session_window_s of wall clock (0: unlimited);
    # session_window_s is also the async watchdog's limit
    max_sessions_per_window: int = 0
    session_window_s: float = 600.0
    # skip an epoch whose projected relative gain is below this (0: tune
    # whenever triggered); a shape nothing serves or projects counts as
    # unbounded gain
    min_gain: float = 0.0
    # the regression sentry's noise margin gating the epoch's swap (None:
    # no gate); a refused swap counts in stats()["sentry_blocked"]
    sentry: Optional[float] = None
    # a plan registry (tunedb.plans.PlanRegistry) each swapped generation's
    # plan is published to for follower replicas; None keeps retunes
    # process-local.  A failed publish warns and counts in
    # stats()["publish_failed"]; the local swap stays
    publish: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SpaceDecision:
    """One space's verdict for one poll."""

    space: str
    drift: float
    untuned_mass: float
    window_calls: int
    novel_shapes: List[Dict[str, int]]   # hot window shapes with no record
    trigger: bool
    reason: str                          # "drift" | "untuned" | ""
    # best (model-predicted - nearest-served) / nearest-served over the
    # novel shapes; None when no shape has both sides (unbounded gain)
    projected_gain: Optional[float] = None


@dataclasses.dataclass
class RetuneReport:
    """What one triggered retune epoch did."""

    epoch: int                           # the epoch number this retune opened
    generation: int                      # the serving generation after it
    decisions: Dict[str, SpaceDecision]
    sessions: Dict[str, object]          # space -> SessionReport
    retrained: List[str]                 # "space/backend" regressors replaced
    wall_s: float = 0.0
    mode: str = "inline"                 # inline | async | fleet
    retrain_s: float = 0.0               # the wall of the retrain ...
    install_s: float = 0.0               # ... of the swap
    publish_s: float = 0.0               # ... and of the plan's publish

    @property
    def tuned(self) -> int:
        return sum(r.tuned for r in self.sessions.values())

    @property
    def session_s(self) -> float:
        return sum(r.wall_s for r in self.sessions.values())


class RetuneController:
    """Drift-triggered sessions, retrain and an atomic serving hot-swap.

    ``tuners`` maps a space name to a trained tuner (``.search`` /
    ``.backend`` / ``.space``: ``InputAwareTuner``); a space without one is
    trained once by ``tuner_factory`` (:func:`_default_tuner_factory`).
    ``store`` is where sessions commit: normally the installed serving
    store.  ``models_dir``, when set, receives every retrained model set.
    ``async_mode`` runs triggered epochs on a daemon thread; ``fleet_dir``
    (which implies it) runs them through a fleet directory's workers,
    whose leases expire after ``fleet_lease_timeout_s``, the epoch waiting
    at most ``fleet_timeout_s`` for them, polling every ``fleet_poll_s``.
    ``measurer`` / ``measure_queue`` are the engine's deferred §6
    re-measurement, drained by :meth:`process_measurements`.
    """

    def __init__(self, store: RecordStore, *,
                 telemetry: Optional[ShapeTelemetry] = None,
                 tuners: Optional[Mapping[str, object]] = None,
                 tuner_factory: Optional[Callable[[str], object]] = None,
                 models_dir=None,
                 cfg: Optional[RetuneConfig] = None,
                 baseline=None,
                 async_mode: bool = False,
                 fleet_dir=None,
                 fleet_lease_timeout_s: float = 30.0,
                 fleet_timeout_s: float = 600.0,
                 fleet_poll_s: float = 0.25,
                 measurer=None,
                 measure_queue=None,
                 verbose: bool = False):
        self.cfg = cfg or RetuneConfig()
        self.store = store
        self.measurer = measurer
        self.measure_queue = measure_queue
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        self.models_dir = models_dir
        self.verbose = verbose
        self.async_mode = async_mode or fleet_dir is not None
        self.fleet_dir = fleet_dir
        self.fleet_lease_timeout_s = fleet_lease_timeout_s
        self.fleet_timeout_s = fleet_timeout_s
        self.fleet_poll_s = fleet_poll_s
        self._tuners: Dict[str, object] = dict(tuners or {})
        self._tuner_factory = tuner_factory or _default_tuner_factory
        self._lock = threading.Lock()        # one retune at a time
        self.epoch = 0
        self.checks = 0                      # polls (triggered or not)
        self.retunes = 0                     # epochs that swapped
        self.sentry_blocked = 0              # swaps the sentry refused
        self.published_plans = 0             # generations published
        self.publish_failed = 0              # publishes refused or failed
        self.last_report: Optional[RetuneReport] = None
        self.history: collections.deque = collections.deque(
            maxlen=HISTORY_CAP)
        # async state: at most one background epoch in flight
        self._async: Optional[threading.Thread] = None
        self._async_report: Optional[RetuneReport] = None
        self.async_submits = 0
        self.async_submit_t: Optional[float] = None   # perf_counter stamps
        self.async_done_t: Optional[float] = None
        # every background epoch's [submit, done] perf_counter window
        self.async_windows: List[List[Optional[float]]] = []
        # the watchdog's cancel event (set when an epoch outlives
        # session_window_s); a tuner may watch it
        self._async_cancel = threading.Event()
        self.watchdog_cancels = 0
        self._last_retune_tick: Optional[int] = None
        self._session_starts: List[float] = []
        # (space, key, generation) -> projected gain (min_gain's memo)
        self._gain_memo: Dict[tuple, Optional[float]] = {}
        # (space, key) pairs a session worked on: a shape whose record can
        # never serve (a fingerprint pin the session backend does not
        # match) must not trigger again at every poll
        self._attempted: set = set()
        self._warned_pins: set = set()
        # a saved baseline resumes an epoch across processes (the CLI);
        # in-process callers start at "now"
        self._baseline = (baseline if baseline is not None
                          else self.telemetry.snapshot())

    # -- detection ------------------------------------------------------------
    def _projected_gain(self, space: str, novel: List[Dict[str, int]],
                        fingerprint: Optional[str]) -> Optional[float]:
        """The best relative win a session could buy over the novel
        shapes: the model's predicted TFLOPS against what the nearest
        record serves.  None when a shape has no record or no prediction:
        an epoch that cannot be projected is unbounded upside."""
        state = serving_state()
        models = state.models
        best: Optional[float] = None
        for inputs in novel:
            memo_key = (space, input_key(space, inputs), state.generation)
            if memo_key in self._gain_memo:
                gain = self._gain_memo[memo_key]
            else:
                gain = None
                near = self.store.nearest(space, inputs, backend=fingerprint,
                                          count=False)
                pm = (models.resolve_model(space, fingerprint)
                      if models is not None else None)
                if near is not None and near.tflops > 0 and pm is not None:
                    try:
                        res = pm.predict_config(inputs, top_k=1)
                        gain = ((float(res.predicted_tflops) - near.tflops)
                                / near.tflops)
                    except Exception:   # noqa: BLE001 — no legal config
                        gain = None
                if len(self._gain_memo) > 1024:
                    self._gain_memo.clear()
                self._gain_memo[memo_key] = gain
            if gain is None:
                return None
            if best is None or gain > best:
                best = gain
        return best

    def _decide(self, drift: SpaceDrift, fingerprint: Optional[str]
                ) -> SpaceDecision:
        cfg = self.cfg
        untuned_calls = 0
        novel: List[Dict[str, int]] = []
        for inputs, count in drift.window_shapes:
            if not self.store.contains(drift.space, inputs,
                                       backend=fingerprint):
                untuned_calls += count      # the honest mass, attempted or not
                if (len(novel) < cfg.top_k_shapes
                        and (drift.space, input_key(drift.space, inputs))
                        not in self._attempted):
                    novel.append(dict(inputs))
        mass = (untuned_calls / drift.window_calls
                if drift.window_calls else 0.0)
        reason = ""
        if drift.window_calls >= cfg.min_calls and novel:
            if drift.drift >= cfg.drift_threshold:
                reason = "drift"
            elif mass >= cfg.untuned_mass_threshold:
                reason = "untuned"
        gain: Optional[float] = None
        if reason and cfg.min_gain > 0:
            gain = self._projected_gain(drift.space, novel, fingerprint)
            if gain is not None and gain < cfg.min_gain:
                log.debug("retune[%s]: skipping %s epoch, projected gain "
                          "%.3f < min_gain %.3f over %d novel shape(s)",
                          drift.space, reason, gain, cfg.min_gain,
                          len(novel))
                reason = ""
        return SpaceDecision(
            space=drift.space, drift=drift.drift, untuned_mass=mass,
            window_calls=drift.window_calls, novel_shapes=novel,
            trigger=bool(reason), reason=reason, projected_gain=gain)

    def reset_baseline(self) -> None:
        """Open a fresh epoch at "now" without retuning."""
        self._baseline = self.telemetry.snapshot()

    def check(self) -> Dict[str, SpaceDecision]:
        """Detection only: no session, no swap, the baseline untouched.
        Publishes each space's drift and untuned mass as gauges."""
        self.checks += 1
        fp = serving_state().fingerprint
        decisions = {space: self._decide(drift, fp) for space, drift
                     in self.telemetry.diff(self._baseline).items()}
        reg = get_registry()
        drift_g = reg.gauge("tunedb_drift_score",
                            "telemetry TV-distance per space vs the epoch "
                            "baseline")
        mass_g = reg.gauge("tunedb_untuned_mass",
                           "window traffic fraction on record-less shapes "
                           "per space")
        for space, d in decisions.items():
            drift_g.set(d.drift, space=space)
            mass_g.set(d.untuned_mass, space=space)
        return decisions

    # -- the loop -------------------------------------------------------------
    def _tuner_for(self, space: str):
        tuner = self._tuners.get(space)
        if tuner is None:
            tuner = self._tuners[space] = self._tuner_factory(space)
        return tuner

    def tuners(self) -> Dict[str, object]:
        """The per-space tuner cache, factory-trained ones included (the
        CLI's watch loop carries it across its per-poll controllers)."""
        return dict(self._tuners)

    def _budget_blocks(self, tick: Optional[int]) -> Optional[str]:
        """Why the budget refuses a retune now (None: go ahead)."""
        cfg = self.cfg
        if (cfg.cooldown_ticks > 0 and tick is not None
                and self._last_retune_tick is not None
                and tick - self._last_retune_tick < cfg.cooldown_ticks):
            return (f"cooldown: {tick - self._last_retune_tick} of "
                    f"{cfg.cooldown_ticks} ticks since the last retune")
        if cfg.max_sessions_per_window > 0:
            horizon = time.time() - cfg.session_window_s
            self._session_starts = [t for t in self._session_starts
                                    if t >= horizon]
            if len(self._session_starts) >= cfg.max_sessions_per_window:
                return (f"budget: {len(self._session_starts)} sessions in "
                        f"the last {cfg.session_window_s:.0f}s "
                        f"(cap {cfg.max_sessions_per_window})")
        return None

    def _note_session_start(self, tick: Optional[int]) -> None:
        self._session_starts.append(time.time())
        if tick is not None:
            self._last_retune_tick = tick

    def process_measurements(self, max_items: int = 2) -> int:
        """Drain up to ``max_items`` deferred §6 re-measurements (the
        engine's idle gap after a tick); the shapes processed."""
        q, m = self.measure_queue, self.measurer
        if q is None or m is None or not len(q):
            return 0
        return q.process(m, models=serving_state().models,
                         max_items=max_items)

    # -- async ----------------------------------------------------------------
    def async_active(self) -> bool:
        """True while a submitted background epoch is still running."""
        th = self._async
        return th is not None and th.is_alive()

    def wait_async(self, timeout: Optional[float] = None
                   ) -> Optional[RetuneReport]:
        """Block until the background epoch (if any) ends; its report,
        taken once."""
        th = self._async
        if th is None:
            return None
        th.join(timeout)
        if th.is_alive():
            return None
        self._async = None
        report, self._async_report = self._async_report, None
        return report

    def _submit_async(self, decisions: Dict[str, SpaceDecision],
                      triggered: Dict[str, SpaceDecision], t0: float,
                      tick: Optional[int]) -> None:
        """Run the epoch on a daemon thread; the poll returns at once.  Its
        swap is the same single ``install_serving`` flip as inline.  A
        fleet epoch needs a store with a file behind it: an in-memory one
        is refused (one warning) and the epoch runs in-process."""
        fleet_dir = self.fleet_dir
        if fleet_dir is not None and self.store.path is None:
            if "fleet-store" not in self._warned_pins:
                self._warned_pins.add("fleet-store")
                warnings.warn(
                    "fleet retunes need a disk-backed store (workers shard "
                    "next to it); falling back to the in-process async "
                    "session", RuntimeWarning, stacklevel=3)
            fleet_dir = None
        self._note_session_start(tick)
        self.async_submits += 1
        self.async_submit_t = time.perf_counter()
        self.async_done_t = None
        self._async_cancel.clear()
        window: List[Optional[float]] = [self.async_submit_t, None]
        self.async_windows.append(window)
        # the submit-to-swap window as one detached span: begun here, on the
        # polling thread, ended by the epoch's thread at the swap
        tr = _tracer()
        epoch_span = None
        trace_id = ""
        if tr is not None:
            trace_id = tr.current_trace_id() or _trace.new_trace_id()
            epoch_span = tr.begin(
                "retune.epoch", trace_id=trace_id,
                spaces=",".join(sorted(triggered)),
                mode="fleet" if fleet_dir is not None else "async")

        def body():
            try:
                with self._lock:
                    if fleet_dir is not None:
                        self._async_report = self._retune_fleet(
                            decisions, triggered, t0, fleet_dir,
                            trace_id=trace_id,
                            parent_id=(epoch_span.span_id
                                       if epoch_span is not None else ""))
                    else:
                        report = self._retune(decisions, triggered, t0)
                        report.mode = "async"
                        self._async_report = report
            except Exception:   # noqa: BLE001 — a dead thread must be seen
                log.exception("async retune epoch failed")
                self._async_report = None
            finally:
                self.async_done_t = window[1] = time.perf_counter()
                if tr is not None:
                    rep = self._async_report
                    tr.end(epoch_span,
                           outcome="failed" if rep is None else "swapped",
                           tuned=0 if rep is None else rep.tuned)

        th = threading.Thread(target=body, name="tunedb-retune", daemon=True)
        self._async = th
        th.start()

    def maybe_retune(self, decisions: Optional[Dict[str, SpaceDecision]]
                     = None, *, tick: Optional[int] = None
                     ) -> Optional[RetuneReport]:
        """One poll: detect, and when triggered, tune, retrain and swap.

        Returns the :class:`RetuneReport` of an epoch that ran, else
        ``None``.  ``decisions`` skips a detection the caller already ran;
        ``tick`` is the caller's tick clock (the cooldown's).  In async mode
        a triggered poll submits the epoch and returns ``None``; the first
        poll after it ends returns its report.  One epoch at a time.
        """
        if self.async_mode:
            if self.async_active():
                if (self.async_submit_t is not None
                        and not self._async_cancel.is_set()
                        and time.perf_counter() - self.async_submit_t
                        > self.cfg.session_window_s):
                    self._async_cancel.set()
                    self.watchdog_cancels += 1
                    log.warning("retune watchdog: background epoch exceeded "
                                "session_window_s=%.0fs, cancelling it",
                                self.cfg.session_window_s)
                    get_registry().counter(
                        "tunedb_retune_watchdog_cancels_total",
                        "async retune epochs cancelled for exceeding "
                        "session_window_s").inc()
                return None
            done = self.wait_async()
            if done is not None:
                return done              # reaped exactly once
        blocked = self._budget_blocks(tick)
        if blocked is not None:
            log.debug("retune poll skipped (%s)", blocked)
            return None
        t0 = time.time()
        if decisions is None:
            decisions = self.check()
        triggered = {s: d for s, d in decisions.items() if d.trigger}
        if not triggered:
            return None
        if self.async_mode:
            self._submit_async(decisions, triggered, t0, tick)
            return None
        with self._lock:
            self._note_session_start(tick)
            return self._retune(decisions, triggered, t0)

    def force_retune(self, decisions: Optional[Dict[str, SpaceDecision]]
                     = None) -> Optional[RetuneReport]:
        """Retune every space with novel hot window shapes, whatever the
        thresholds (the CLI's ``retune --force``).  Always inline."""
        with self._lock:
            t0 = time.time()
            if decisions is None:
                decisions = self.check()
            forced = {s: d for s, d in decisions.items() if d.novel_shapes}
            if not forced:
                return None
            self._note_session_start(None)
            return self._retune(decisions, forced, t0)

    def _retune(self, decisions: Dict[str, SpaceDecision],
                triggered: Dict[str, SpaceDecision], t0: float
                ) -> RetuneReport:
        cfg = self.cfg
        state = serving_state()
        sessions: Dict[str, object] = {}
        affected: Set[Tuple[str, str]] = set()
        for space, dec in triggered.items():
            tuner = self._tuner_for(space)
            session_fp = backend_fingerprint(tuner.backend)
            if (state.fingerprint is not None
                    and session_fp != state.fingerprint
                    and (space, session_fp) not in self._warned_pins):
                self._warned_pins.add((space, session_fp))
                warnings.warn(
                    f"retune session for {space!r} commits records under "
                    f"backend {session_fp!r}, which the active fingerprint "
                    f"pin {state.fingerprint!r} will never serve from the "
                    "exact tier; give the controller a tuner measuring "
                    "under the pinned backend", RuntimeWarning, stacklevel=3)
            session = TuningSession(
                tuner, self.store, None, workers=cfg.workers,
                remeasure=cfg.remeasure, skip_existing=True,
                collect_samples=True, source="retune")
            report = session.run(shapes=dec.novel_shapes,
                                 verbose=self.verbose)
            sessions[space] = report
            # never plan these shapes again: if their records cannot serve
            # (a pin mismatch) or their jobs keep failing, triggering at
            # every poll would churn generations and change nothing
            for inputs in dec.novel_shapes:
                self._attempted.add((space, input_key(space, inputs)))
            affected.add((space, session_fp))
            if self.verbose:
                print(f"[retune:{space}] {dec.reason}: drift {dec.drift:.2f}, "
                      f"untuned mass {dec.untuned_mass:.2f} -> "
                      f"{report.tuned} tuned, {report.failed} failed")
        return self._finish_epoch(decisions, sessions, affected, t0, state,
                                  "inline")

    def _retune_fleet(self, decisions: Dict[str, SpaceDecision],
                      triggered: Dict[str, SpaceDecision], t0: float,
                      fleet_dir, trace_id: str = "",
                      parent_id: str = "") -> RetuneReport:
        """One triggered epoch through the fleet bus: the novel shapes
        published as jobs for worker processes; the coordinator requeues
        crashed workers' leases and merges the finished shards into the
        store; then (merge done) the retrain and the swap.  A fleet that
        does not finish within ``fleet_timeout_s`` still swaps in what
        landed; its stragglers stay queued, and count as novel again."""
        from .fleet import Coordinator, FleetJob

        state = serving_state()
        coord = Coordinator(fleet_dir, self.store,
                            lease_timeout_s=self.fleet_lease_timeout_s)
        # markers of earlier runs of this directory are not this epoch's
        stale_done = {m.name for m in coord.fleet.done.glob("*.json")}
        stale_failed = {m.name for m in coord.fleet.failed.glob("*.json")}
        jobs: List[FleetJob] = []
        for space, dec in triggered.items():
            for inputs in dec.novel_shapes:
                # the count lets workers claim the hottest shapes first; the
                # trace id links their fleet.job spans to this epoch
                jobs.append(FleetJob(space=space, inputs=dict(inputs),
                                     count=self.telemetry.count(space, inputs),
                                     source="retune", trace_id=trace_id))
                self._attempted.add((space, input_key(space, inputs)))
        published = coord.publish(jobs)
        if self.verbose:
            print(f"[retune:fleet] published {published} job(s) "
                  f"-> {fleet_dir}")
        finished = coord.wait(timeout_s=self.fleet_timeout_s,
                              poll_s=self.fleet_poll_s,
                              verbose=self.verbose,
                              cancel=self._async_cancel)
        if not finished:
            warnings.warn(
                f"fleet retune timed out after {self.fleet_timeout_s:.0f}s "
                f"with {coord.outstanding()} job(s) outstanding; publishing "
                "the records that did land", RuntimeWarning, stacklevel=2)
            done_now = {m.name for m in coord.fleet.done.glob("*.json")}
            fail_now = {m.name for m in coord.fleet.failed.glob("*.json")}
            for job in jobs:
                name = f"{job.job_id}.json"
                if name not in done_now and name not in fail_now:
                    self._attempted.discard(
                        (job.space, input_key(job.space, job.inputs)))
        tr = _tracer()
        merge_span = (tr.begin("fleet.merge", trace_id=trace_id,
                               parent_id=parent_id, jobs=published)
                      if tr is not None and trace_id else None)
        coord.poll()                     # the final merge
        if merge_span is not None:
            tr.end(merge_span, outstanding=coord.outstanding())
        if (state.fingerprint is not None and coord.affected
                and all(b != state.fingerprint for _, b in coord.affected)
                and ("fleet", state.fingerprint) not in self._warned_pins):
            self._warned_pins.add(("fleet", state.fingerprint))
            warnings.warn(
                f"fleet workers committed records under backends "
                f"{sorted({b for _, b in coord.affected})}, none matching "
                f"the active fingerprint pin {state.fingerprint!r}; the "
                "exact tier will not serve them", RuntimeWarning,
                stacklevel=2)
        # per-space session reports from this epoch's markers, so a fleet
        # report reads as an in-process one does
        done_ids = {p.stem for p in coord.fleet.done.glob("*.json")
                    if p.name not in stale_done}
        failed_ids = {p.stem for p in coord.fleet.failed.glob("*.json")
                      if p.name not in stale_failed}
        sessions: Dict[str, object] = {}
        for space, dec in triggered.items():
            ids = [j.job_id for j in jobs if j.space == space]
            sessions[space] = SessionReport(
                space=space, jobs=len(ids),
                tuned=sum(1 for i in ids if i in done_ids),
                skipped=len(dec.novel_shapes) - len(ids),
                failed=sum(1 for i in ids if i in failed_ids),
                wall_s=time.time() - t0)
        report = self._finish_epoch(decisions, sessions, set(coord.affected),
                                    t0, state, "fleet")
        coord.report(retrained=report.retrained, wall_s=report.wall_s)
        return report

    def _finish_epoch(self, decisions: Dict[str, SpaceDecision],
                      sessions: Dict[str, object],
                      affected: Set[Tuple[str, str]], t0: float,
                      entry_state, mode: str) -> RetuneReport:
        cfg = self.cfg
        if not any(r.tuned for r in sessions.values()):
            # nothing landed: no serving change, so no generation flip
            # (that would drop every memo and graph for nothing); the
            # window is spent all the same
            self._baseline = self.telemetry.snapshot()
            self.epoch += 1
            self.last_report = RetuneReport(
                epoch=self.epoch, generation=entry_state.generation,
                decisions=decisions, sessions=sessions, retrained=[],
                wall_s=time.time() - t0, mode=mode)
            self._observe_epoch(self.last_report)
            return self.last_report

        t_train = time.perf_counter()
        fresh = None
        retrained: List[str] = []
        if cfg.retrain:
            from .model import train_models
            for space, fp in sorted(affected):
                part = train_models(
                    self.store, space=space, backend=fp,
                    min_samples=cfg.min_train_samples,
                    epochs=cfg.train_epochs, seed=cfg.seed)
                fresh = part if fresh is None else fresh.merged_with(part)
            if fresh is not None and not len(fresh):
                fresh = None
            if fresh is not None:
                retrained = [f"{s}/{b}" for s, b in sorted(fresh.models)]
        retrain_s = time.perf_counter() - t_train

        # one generation flip, store and models; the fingerprint pin stays.
        # Read the state current at swap time, not the entry snapshot: an
        # install made meanwhile (a new engine retargeting the store) must
        # not be reverted by this read-modify-write
        t_install = time.perf_counter()
        cur = serving_state()
        if cur.store is not None and cur.store is not self.store:
            warnings.warn(
                "serving was retargeted to a different store during the "
                "retune; skipping the hot-swap (the session results stay in "
                "the controller's store)", RuntimeWarning, stacklevel=3)
            new_state = cur
        else:
            new_models = cur.models
            if fresh is not None:
                new_models = (cur.models.merged_with(fresh)
                              if cur.models is not None else fresh)
                if self.models_dir:
                    new_models.save(self.models_dir)
            sentry = None
            if cfg.sentry is not None:
                from .obs.sentry import RegressionSentry
                sentry = RegressionSentry(noise_margin=cfg.sentry)
            new_state = install_serving(store=self.store, models=new_models,
                                        sentry=sentry)
            if new_state.generation == cur.generation:
                # the sentry refused: the records stay in the store (a
                # later, faster measurement supersedes them), the previous
                # generation keeps serving
                self.sentry_blocked += 1
            else:
                self.retunes += 1
        install_s = time.perf_counter() - t_install
        t_publish = time.perf_counter()
        if (cfg.publish and new_state.plan is not None
                and new_state.generation != cur.generation):
            self._publish_plan(new_state.plan)
        publish_s = time.perf_counter() - t_publish
        self._baseline = self.telemetry.snapshot()
        self.epoch += 1
        self.last_report = RetuneReport(
            epoch=self.epoch, generation=new_state.generation,
            decisions=decisions, sessions=sessions, retrained=retrained,
            wall_s=time.time() - t0, mode=mode, retrain_s=retrain_s,
            install_s=install_s, publish_s=publish_s)
        self._observe_epoch(self.last_report)
        return self.last_report

    def _publish_plan(self, plan) -> None:
        """Publish the swapped generation's plan to ``cfg.publish`` for
        follower replicas.  The local swap already happened: a refused or
        failed publish (a racing append made the plan stale, a registry
        that cannot be written) warns and counts, and the next epoch
        publishes again."""
        try:
            from .plans import PlanRegistry
            manifest = PlanRegistry(self.cfg.publish).publish(
                plan, store=self.store)
            self.published_plans += 1
            if self.verbose:
                print(f"[retune] published plan generation "
                      f"{manifest.generation} ({manifest.n_entries} "
                      f"entries) -> {self.cfg.publish}")
        except Exception as e:  # noqa: BLE001 — warned and counted
            self.publish_failed += 1
            warnings.warn(f"plan publish to {self.cfg.publish} failed: {e}",
                          RuntimeWarning, stacklevel=3)

    # -- reporting ------------------------------------------------------------
    def _observe_epoch(self, report: RetuneReport) -> None:
        """Append to the bounded history and publish the epoch's metrics.
        The latency is submit to swap: an async epoch's perf_counter
        window, an inline epoch's own wall."""
        tuned = [s for s, r in report.sessions.items()
                 if getattr(r, "tuned", 0)]
        latency = report.wall_s
        if (self.async_submit_t is not None and self.async_done_t is not None
                and self.async_done_t >= self.async_submit_t):
            latency = self.async_done_t - self.async_submit_t
        self.history.append({
            "epoch": report.epoch,
            "generation": report.generation,
            "mode": report.mode,
            "tuned": tuned,
            "retrained": list(report.retrained),
            "wall_s": report.wall_s,
            "latency_s": latency,
            "sentry_blocked": self.sentry_blocked,
            "t": time.time(),
        })
        reg = get_registry()
        reg.counter("tunedb_retune_epochs_total",
                    "controller epochs closed (tuned or not)").inc(
                        mode=report.mode)
        if tuned:
            reg.counter("tunedb_retunes_total",
                        "epochs that committed new tuning records").inc(
                            mode=report.mode)
            reg.histogram("tunedb_retune_latency_seconds",
                          "retune submit->swap latency").observe(latency)
        reg.gauge("tunedb_retune_sentry_blocked",
                  "serving swaps refused by the regression sentry").set(
                      self.sentry_blocked)

    def stats(self) -> Dict[str, object]:
        return {
            "epoch": self.epoch,
            "checks": self.checks,
            "retunes": self.retunes,
            "telemetry_scope": getattr(self.telemetry, "scope", "process"),
            "sentry_blocked": self.sentry_blocked,
            "published_plans": self.published_plans,
            "publish_failed": self.publish_failed,
            "history": list(self.history),
            "generation": serving_state().generation,
            "config": dataclasses.asdict(self.cfg),
            "measure": (None if self.measurer is None else {
                **self.measurer.stats(),
                "queue": (None if self.measure_queue is None
                          else self.measure_queue.stats()),
            }),
            "async": {
                "enabled": self.async_mode,
                "fleet_dir": (None if self.fleet_dir is None
                              else str(self.fleet_dir)),
                "submits": self.async_submits,
                "in_flight": self.async_active(),
                "watchdog_cancels": self.watchdog_cancels,
            },
            "last": None if self.last_report is None else {
                "epoch": self.last_report.epoch,
                "tuned": self.last_report.tuned,
                "retrained": list(self.last_report.retrained),
                "wall_s": self.last_report.wall_s,
                "mode": self.last_report.mode,
            },
        }
