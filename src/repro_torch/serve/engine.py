"""Batched serving engine: slot-based continuous batching over a shared
decode cache (port of ``repro.serve.engine``).  The cache is the model's: K/V rows per attention layer,
conv and SSM state per Mamba-2 layer; the engine walks its tree and never
names a leaf.

Requests are admitted into free slots (prefill fills the slot's part of
every cache leaf), every decode tick advances all slots together at their
own cache positions, and finished requests (EOS or length budget) free
their slot.  Inactive slots decode too, on token 0 at position 0, and
their output is discarded — the batch keeps one shape, as in the
reference; a slot's next prefill replaces whatever state they left.

On CUDA every decode tick and every prefill replays a captured CUDA graph,
the port's counterparts of the reference's ``jax.jit`` of ``decode_step``
and of its per-prompt-length ``_prefill_fns``.  The tick is captured once
for the engine's fixed (slots, max_len) batch, with static token and
position buffers that are filled before each replay.  Each prompt length
``n`` is captured at its first prefill into one static single-slot cache
shared by all lengths (zeroed inside the graph, as the reference's prefill
starts from a fresh cache), with a static ``(1, n)`` token buffer; after
each replay the single-slot cache is copied into the slot (the
reference's ``merge``), so the slot's rows at ``n`` and beyond are zero.
A tick's capture runs it once eagerly first; the recurrent leaves are
restored after that warm-up, so the replay advances them once
(:meth:`Engine._capture`).
The prefill graphs share one memory pool (each one's logits are read
before the next replay); the tick's graph keeps its own.  Dispatch
resolves every config at capture, as the reference's does at trace time.
A new serving generation (``serving_state().generation``: another store,
model set or plan installed) drops every graph, which are captured again
at their next use; a promotion into the plan's overlay does not, so a
graph keeps the configs it was captured with.  The graphs keep their
node lists (:attr:`Engine.graph`, :attr:`Engine.prefill_graphs`), so a
caller can count the kernels a replay gives the device.  A capture or
replay that fails raises; it never falls back to the eager prefill or
tick, which stay methods (:meth:`Engine.prefill_eager`,
:meth:`Engine.decode_eager`) for comparison.  On the CPU both run eager.

The engine's install carries the store, the model artifacts and a
dispatch plan in one generation: compiled from them, or loaded from a
plan artifact (``ServeConfig.plan_dir``; a rejected artifact warns and a
plan is compiled instead; without a store the engine serves plan-only).
With ``ServeConfig.measure="wallclock"`` the installed model set gets a
``tunedb.measure.ServingMeasurer`` and a ``MeasureQueue``: a shape the
model tier resolves is served the model's argmax and its top-k are
re-measured on the card after a later tick (:meth:`Engine.maybe_retune`),
the winner going into the model set's memo and the plan's overlay.

With ``ServeConfig.retune`` the engine closes the loop in-process: a
``tunedb.controller.RetuneController`` (tuners from ``retune_tuners``)
is polled every ``retune_interval`` ticks, tunes the window's untuned or
drifted hot shapes on the card, retrains and swaps in a new generation;
the next tick and each prompt length's next prefill are captured again
under it, so the swap reaches the device at once (the reference's jitted
programs keep the configs they were traced with).  Without a configured
store the engine installs an in-memory one.  A capture holds
``core.backend.DEVICE_LOCK``, which every timing measurement holds too,
so an async epoch's measurements never overlap a capture.  While an
async epoch runs, its timer captures graphs on its own thread: code on
other threads synchronises its stream (``torch.cuda.current_stream().
synchronize()``), or takes ``DEVICE_LOCK`` before synchronising the whole
device, which a capture in progress refuses.  A generation that moves
during a capture leaves the graph marked with the generation read before
it, so it is captured again at its next use.

Shape telemetry counts executions of the served program: eager prefills
and eager ticks record through dispatch as they run; a graph's shapes are
collected once at capture (neither the capture pass nor its warm-up
counts) and counted on every replay.  Every layer's call counts, as the
device runs them: the reference under its defaults (layers under
``lax.scan``) counts a scanned layer body once a forward, so each of its
counts is the port's over the layer count, and the two agree call for
call with its ``unroll_scan=True, remat=False``.  Under
``admission="store"`` (:class:`StoreAwareAdmission`) pending requests are
ranked by how many of their length's prefill shapes the plan or the store
covers (each length's shapes are kept at its capture on CUDA, and at its
first prefill on the CPU).

Graceful degradation follows the reference: ``request_deadline_s``
rejects an overdue pending request unserved and retires an overdue active
one with the tokens it has, and ``shed_threshold`` sheds the newest
pending requests while the backlog exceeds it (:meth:`Engine._health`
says so).  An encoder-decoder config is refused at construction, as
the reference's launcher refuses it; a vision-frontend config is served
on tokens only, as the reference's engine serves it.

Observability follows the reference.  ``ServeConfig.trace_sample`` > 0
installs the process's span tracer (``tunedb.obs.trace``) before anything
else runs: each admission opens an ``engine.admit`` root with an
``engine.prefill`` span inside, each decode tick an ``engine.tick`` root,
and dispatch's resolutions, the idle gap's measurements and an async
retune's ``retune.epoch`` nest under whichever trace is open.  On CUDA a
replayed tick resolves nothing on the host, so ``dispatch.resolve`` spans
come from captures and their warm-ups, and an ``engine.tick`` root spans
the replay and the sampling's copy of the logits to the host.  With
``trace_sample=0`` the loop reads one attribute and calls no tracer.
``ServeConfig.status_port`` starts a ``tunedb.obs.StatusServer``
(``/metrics``, ``/status``, ``/plan``, ``/trace``, ``/healthz``, the
last answering 503 while the engine sheds load) on its own thread; it
reads host state only, so it never synchronises the card under a
capture.

The fleet follows the reference.  ``ServeConfig.retune_fleet`` runs the
retune loop's epochs through a fleet directory: the controller publishes
the epoch's shapes as lease-file jobs, worker processes (``python -m
repro_torch.tunedb fleet worker``) tune them on the card, and the swap
comes after the coordinator merged their shards into the store.
``telemetry_export_s`` (with ``retune_fleet``) dumps this process's
telemetry onto the bus and hands the controller the fleet-global view
(``tunedb.telemetry.FleetTelemetryView``, its own dump left out).
``retune_publish`` publishes each swapped generation's plan to a registry;
``follow`` starts a ``tunedb.plans.PlanFollower`` that installs each
generation published there (its install reads host state only, so it may
land during a capture: the graph is captured again at its next use).
``router`` registers this engine as the first replica of a
``serve.router`` router; each admission asks it for a replica with the
length's prefill shapes (kept at the length's first prefill), a
``request.route`` span when traced.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import pathlib
import time
import warnings
from typing import (Any, Deque, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.backend import DEVICE_LOCK, H100_SXM, Peaks
from repro_torch.core.space import gemm_input
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import (ModelConfig, decode_step, init_cache, prefill,
                                recurrent_leaves, tree_leaves, tree_map)
from repro_torch.tunedb.controller import (RetuneConfig, RetuneController,
                                           _default_tuner_factory)
from repro_torch.tunedb.measure import MeasureQueue, ServingMeasurer
from repro_torch.tunedb.model import ModelSet, default_models_dir
from repro_torch.tunedb.obs import StatusServer, enable_tracing, get_registry
from repro_torch.tunedb.obs.trace import new_trace_id
from repro_torch.tunedb.plans import (PlanArtifactError, check_freshness,
                                      load_plan, read_manifest)
from repro_torch.tunedb.store import (RecordStore, install_serving,
                                      serving_state, shape_key)
from repro_torch.tunedb.telemetry import (FleetTelemetryView,
                                          TelemetryExporter, get_telemetry)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    slots: int = 8                  # concurrent sequences
    eos_token: int = -1             # -1: never emitted (synthetic tokens)
    temperature: float = 0.0        # 0 => greedy
    seed: int = 0
    tunedb: Optional[str] = None    # warm-start: tuning-record store path
    # model artifacts dir for the model tier; None finds `<tunedb>.models/`
    # beside the store, "" turns the tier off
    tunedb_models: Optional[str] = None
    # pin dispatch lookups to one backend fingerprint; None = any backend
    tunedb_backend: Optional[str] = None
    # the model tier's confidence gates (tunedb.model.ModelSet): decline
    # when the top-1 beats the top-2 by less than this relative margin
    # (0 trusts every argmax) ...
    tunedb_margin: float = 0.0
    # ... or when an input feature lies more than this many training
    # standard deviations off (0 turns the gate off)
    tunedb_max_z: float = 6.0
    # a plan artifact directory (``tunedb plan export``) to serve from
    # instead of compiling a plan at install; a rejected artifact warns
    # and a plan is compiled from the store instead
    plan_dir: Optional[str] = None
    # "fifo" admits pending requests in arrival order; "store" prefers
    # those whose prompt length's prefill shapes the plan or the store
    # covers and groups equal lengths (every request is still served)
    admission: str = "fifo"
    # keep (start perf_counter, wall seconds, thread-CPU seconds) of each
    # decode tick, the idle-gap re-measurement included
    record_tick_times: bool = False
    tick_times_cap: int = 4096      # newest ticks kept; 0 keeps all
    # graceful degradation, checked at admit and tick boundaries: a request
    # older than this (seconds) is rejected unserved while pending and
    # retires with the tokens it has while active; None turns it off
    request_deadline_s: Optional[float] = None
    # admission backlog cap: while active + pending requests exceed it, the
    # newest pending ones are shed (rejected unserved); None turns it off
    shed_threshold: Optional[int] = None
    # the model tier's §6 re-measurement on the card: "wallclock" re-times
    # the model's top-k candidates of a shape it resolved, in the idle gap
    # after a decode tick (tunedb.measure); None turns it off
    measure: Optional[str] = None
    # -- continuous retuning (tunedb.controller.RetuneController) ------------
    retune: bool = False            # close the telemetry->tune->serve loop
    retune_interval: int = 64       # decode ticks between controller polls
    retune_drift: float = 0.25      # hot-shape mass TV distance trigger
    retune_untuned_mass: float = 0.5   # untuned fraction of window trigger
    retune_min_calls: int = 32      # window calls before a space is judged
    retune_top_k: int = 4           # novel hot shapes tuned per session
    retune_train: bool = True       # retrain and swap the regressors too
    # run a triggered epoch on a background thread (the poll submits and
    # returns) instead of inline on the tick that tripped it
    retune_async: bool = False
    # the epoch budget: ticks between epochs, epochs per window of seconds
    retune_cooldown_ticks: int = 0
    retune_max_sessions: int = 0    # per retune_window_s (0 = unlimited)
    retune_window_s: float = 600.0
    # skip epochs whose projected gain over the nearest-record tier is small
    retune_min_gain: float = 0.0
    # the regression sentry's noise margin gating each retune's swap (None
    # turns the gate off; tunedb.obs.sentry.RegressionSentry)
    retune_sentry: Optional[float] = None
    # -- the fleet (tunedb.fleet, tunedb.plans, serve.router) ----------------
    # a fleet directory the retune epochs publish their shapes to, as jobs
    # for `fleet worker` processes (implies async epochs and retune)
    retune_fleet: Optional[str] = None
    # > 0 (with retune_fleet): dump this engine's telemetry onto the fleet
    # bus every this many seconds, and retune off the fleet-global view
    telemetry_export_s: float = 0.0
    # a request-router policy ("affinity", "round_robin", "random"); the
    # engine is the first replica, peers join through router.add_replica
    router: Optional[str] = None
    # a plan registry to follow: each published generation is pulled,
    # verified and installed by a PlanFollower thread
    follow: Optional[str] = None
    follow_interval_s: float = 2.0  # seconds between registry polls
    # the follower's sentry margin for a coverage loss (None: no gate)
    follow_sentry: Optional[float] = 0.10
    # a plan registry each successful retune swap publishes its plan to
    retune_publish: Optional[str] = None
    # -- observability (tunedb.obs) ------------------------------------------
    # run a StatusServer (/metrics, /status, /plan, /trace, /healthz) inside
    # this engine on this port; 0 binds an ephemeral one
    # (Engine.status_server.port says which), None turns it off
    status_port: Optional[int] = None
    # the share of trace roots (admissions, decode ticks) the span tracer
    # keeps; 0 leaves tracing as it is (off unless enabled elsewhere), and
    # the loop then calls no tracer
    trace_sample: float = 0.0


def _ceil_div(x: int, t: int) -> int:
    return -(-x // t)


def _roofline_time_s(space: str, cfg: Mapping[str, int],
                     inputs: Mapping[str, int], peaks: Peaks
                     ) -> Optional[float]:
    """``max(compute, memory)`` time of ``cfg`` at ``inputs`` at the
    chip's ``peaks``, the block schedule charged as the reference charges
    it: compute over the ceil-padded grid, A/B traffic in whole blocks per
    grid step, the output unpadded.  ``None`` for spaces without a
    roofline (conv, SSD)."""
    bits = int(inputs.get("dtype_bits", 16))
    bpe = max(bits // 8, 1)
    peak = (peaks.bf16_tflops if bits <= 16 else peaks.fp32_tflops) * 1e12
    hbm = peaks.hbm_gbps * 1e9
    if space == "gemm":
        m, n, k = int(inputs["M"]), int(inputs["N"]), int(inputs["K"])
        bm = int(cfg.get("bm") or m)
        bn = int(cfg.get("bn") or n)
        bk = int(cfg.get("bk") or k)
        mp = _ceil_div(m, bm) * bm
        np_ = _ceil_div(n, bn) * bn
        kp = _ceil_div(k, bk) * bk
        t_c = 2.0 * mp * np_ * kp / peak
        a_bytes = _ceil_div(n, bn) * mp * kp * bpe      # A slab per N step
        b_bytes = _ceil_div(m, bm) * kp * np_ * bpe     # B slab per M step
        out_bytes = m * n * bpe
        return max(t_c, (a_bytes + b_bytes + out_bytes) / hbm)
    if space == "attention":
        b = int(inputs.get("B", 1))
        hq = int(inputs.get("Hq", 1))
        hkv = int(inputs.get("Hkv", hq))
        lq, lkv = int(inputs["Lq"]), int(inputs["Lkv"])
        d = int(inputs.get("D", 64))
        frac = 0.5 if inputs.get("causal") else 1.0
        bq = int(cfg.get("b_q") or lq)
        bkv = int(cfg.get("b_kv") or lkv)
        lqp = _ceil_div(lq, bq) * bq
        lkvp = _ceil_div(lkv, bkv) * bkv
        t_c = 4.0 * b * hq * lqp * lkvp * d * frac / peak
        qo_bytes = 2 * b * hq * lq * d * bpe            # Q read + O write
        kv_bytes = 2 * b * hkv * lkv * d * bpe
        return max(t_c, (qo_bytes + kv_bytes) / hbm)
    return None


def _useful_flops(space: str, inputs: Mapping[str, int]) -> Optional[float]:
    if space == "gemm":
        return 2.0 * inputs["M"] * inputs["N"] * inputs["K"]
    if space == "attention":
        frac = 0.5 if inputs.get("causal") else 1.0
        return (4.0 * inputs.get("B", 1) * inputs.get("Hq", 1)
                * inputs["Lq"] * inputs["Lkv"] * inputs.get("D", 64) * frac)
    return None


def _roofline_floor(space: str, near, inputs: Mapping[str, int],
                    peaks: Peaks) -> float:
    """Projected TFLOP/s of the nearest record's config at this shape: the
    record's measured number scaled by the roofline's ratio of useful
    throughput here to at the record's own shape (the recorded number
    itself where the space has no roofline)."""
    t_q = _roofline_time_s(space, near.config, inputs, peaks)
    t_r = _roofline_time_s(space, near.config, near.inputs, peaks)
    u_q = _useful_flops(space, inputs)
    u_r = _useful_flops(space, near.inputs)
    if not t_q or not t_r or not u_q or not u_r:
        return near.tflops
    return near.tflops * (u_q / t_q) / (u_r / t_r)


def _count_admission(space: str, decision: str) -> None:
    """One :meth:`StoreAwareAdmission.bucket` decision, in the metrics
    registry's ``tunedb_admission_decisions_total{space, decision}``."""
    get_registry().counter(
        "tunedb_admission_decisions_total",
        "store-aware admission bucket outcomes").inc(
            space=space, decision=decision)


def _count_degraded(kind: str, n: int = 1) -> None:
    """Requests shed (``kind="shed"``) into
    ``tunedb_requests_shed_total``, or rejected or retired by the deadline
    into ``tunedb_request_deadline_exceeded_total{state=kind}``."""
    reg = get_registry()
    if kind == "shed":
        reg.counter("tunedb_requests_shed_total",
                    "requests rejected unserved by admission load "
                    "shedding").inc(n)
    else:
        reg.counter("tunedb_request_deadline_exceeded_total",
                    "requests cut short or rejected by "
                    "request_deadline_s").inc(n, state=kind)


_NULL_CTX = contextlib.nullcontext()

# installed shapes a traced engine resolves at start (``dispatch.probe``)
PROBE_SHAPES = 8

# the dims admission may pad up to a tuned record's (padding M is exact),
# and the most relative extra work a padded shape may cost
_PAD_DIMS = ("M",)
_MAX_PAD = 1.0


class StoreAwareAdmission:
    """Store-aware admission: prefer shapes the dispatch plan serves.

    Both decisions come from recorded numbers only (no measurement on the
    admission path), as in the reference:

    * :meth:`bucket`: for one work shape, whether to pad its
      :data:`_PAD_DIMS` up to a tuned record's shape.  Padding a GEMM's M
      is exact, so the question is throughput: the padded run delivers
      the record's TFLOP/s times the useful fraction; the exact shape gets
      its nearest record's config at the roofline floor
      (:func:`_roofline_floor`, divided by ``peaks``).  Never past
      :data:`_MAX_PAD` relative extra work.
    * :meth:`pick`: which pending request to admit next.  Prompt lengths
      whose captured prefill shapes the plan or the store covers score
      highest, the last admitted length gets a bonus (plan entries reused
      back to back), unknown lengths sit in the middle; arrival order
      breaks ties.  Every request is still served.

    ``peaks`` defaults to the H100 SXM's (``core.backend.H100_SXM``); the
    counters ``hits`` / ``exact`` / ``padded`` count :meth:`bucket`'s
    decisions, as does the metrics registry's
    ``tunedb_admission_decisions_total{space, decision}``.
    """

    def __init__(self, *, peaks: Peaks = H100_SXM):
        self.peaks = peaks
        self.hits = 0
        self.padded = 0
        self.exact = 0
        self._score_memo: Dict[tuple, float] = {}

    def bucket(self, space: str, inputs: Mapping[str, int]
               ) -> Tuple[Dict[str, int], str]:
        """(dispatch shape, "hit" | "exact" | "padded") for one work item."""
        state = serving_state()
        store = state.store
        if store is None:
            return dict(inputs), "exact"
        fp = state.fingerprint
        if store.contains(space, inputs, backend=fp):
            self.hits += 1
            _count_admission(space, "hit")
            return dict(inputs), "hit"
        floor = 0.0
        near = store.nearest(space, inputs, backend=fp, count=False)
        if near is not None:
            floor = _roofline_floor(space, near, inputs, self.peaks)
        best_rec, best_eff = None, floor
        for rec in store.neighbors(space, inputs):
            if fp is not None and rec.backend != fp:
                continue
            work, ok = 1.0, True
            for k, v in inputs.items():
                rv = rec.inputs[k]
                if k in _PAD_DIMS:
                    if rv < v:
                        ok = False
                        break
                    work *= v / rv
                elif rv != v:
                    ok = False
                    break
            if not ok or work * (1.0 + _MAX_PAD) < 1.0:
                continue
            eff = rec.tflops * work       # recorded TFLOP/s, usefully spent
            if eff > best_eff:
                best_rec, best_eff = rec, eff
        if best_rec is None:
            self.exact += 1
            _count_admission(space, "exact")
            return dict(inputs), "exact"
        self.padded += 1
        _count_admission(space, "padded")
        return dict(best_rec.inputs), "padded"

    def _length_score(self, n: int, prefill_shapes: Mapping[int, list],
                      state) -> float:
        shapes = prefill_shapes.get(n)
        if not shapes:
            return 0.5                    # unknown length
        memo_key = (state.generation, n)
        score = self._score_memo.get(memo_key)
        if score is not None:
            return score
        hits = 0
        for space, inputs in shapes:
            entry = (state.plan.lookup(space, shape_key(inputs))
                     if state.plan is not None else None)
            if entry is not None or (
                    state.store is not None
                    and state.store.contains(space, inputs,
                                             backend=state.fingerprint)):
                hits += 1
        score = hits / len(shapes)
        if len(self._score_memo) > 1024:
            self._score_memo.clear()
        self._score_memo[memo_key] = score
        return score

    def pick(self, pending: Sequence, prefill_shapes: Mapping[int, list],
             last_len: Optional[int] = None) -> int:
        """Index into ``pending`` of the request to admit next."""
        state = serving_state()
        best_i, best_score = 0, -1.0
        for i, req in enumerate(pending):
            n = len(req.prompt)
            score = self._length_score(n, prefill_shapes, state)
            if last_len is not None and n == last_len:
                score += 0.25             # plan-entry reuse
            if score > best_score + 1e-9:  # stable: arrival order
                best_i, best_score = i, score
        return best_i


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (len,) int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    arrived_at: float = 0.0         # time.monotonic() at generate's start
    shed: bool = False              # rejected unserved by load shedding
    deadline_exceeded: bool = False  # cut short or rejected by the deadline


# an encoder-decoder is served at the model level (``encode``, ``prefill``
# with ``encoder_embeds``, ``decode_step(memory=)``): the engine's prefill
# and tick carry tokens only, as the reference's do, and the reference's
# launcher refuses it with this message
ENCDEC_REFUSED = ("enc-dec serving is exercised via the dry-run decode "
                  "cells; the engine serves LM archs")

# the calibration measurement an engine with ``measure`` runs at start:
# one GEMM under the ops default, as the reference's (256^3, 128^3 tiles)
CALIBRATION_GEMM = (dict(ops.DEFAULT_GEMM), gemm_input(256, 256, 256, 16))


class Engine:
    def __init__(self, cfg: ModelConfig, params: Any, serve_cfg: ServeConfig,
                 *, device: DeviceLike = None,
                 retune_tuners: Optional[Dict[str, Any]] = None):
        cfg.check_supported()
        if cfg.is_encdec:
            raise ValueError(ENCDEC_REFUSED)
        self.device = resolve_device(device)
        self.cfg, self.sc = cfg, serve_cfg
        if serve_cfg.admission not in ("fifo", "store"):
            raise ValueError(f"admission {serve_cfg.admission!r}: want "
                             "'fifo' or 'store'")
        # the process's span tracer, installed (or its sampling retuned)
        # before anything below runs, so the install, the calibration
        # measurement and the first prefill land in one trace stream
        self.tracer = None
        if serve_cfg.trace_sample > 0:
            self.tracer = enable_tracing(serve_cfg.trace_sample)
        # refused before anything is installed ("sim" is not ported)
        self.measurer: Optional[ServingMeasurer] = None
        self.measure_queue: Optional[MeasureQueue] = None
        if serve_cfg.measure is not None:
            self.measurer = ServingMeasurer(serve_cfg.measure,
                                            device=self.device)
            self.measure_queue = MeasureQueue()
        self.params = _to_device(params, self.device)
        # warm start: the store and its model artifacts become the port's
        # process-wide dispatch state, pinned to tunedb_backend, in one
        # install; a missing file serves on the heuristics tier (dispatch
        # warns once).  The models are installed even when there are none
        # (None), so an earlier engine's regressors never serve this
        # store's traffic.
        self.tunedb_store: Optional[RecordStore] = None
        self.tunedb_models: Optional[ModelSet] = None
        self._models_dir = None
        if serve_cfg.tunedb or serve_cfg.tunedb_models or serve_cfg.plan_dir:
            swap = {"fingerprint": serve_cfg.tunedb_backend}
            models_dir = serve_cfg.tunedb_models
            if serve_cfg.tunedb:
                path = pathlib.Path(serve_cfg.tunedb)
                if not path.exists():
                    warnings.warn(f"tunedb store {path} does not exist; "
                                  "serving starts with an empty store "
                                  "(heuristics fallback)", RuntimeWarning,
                                  stacklevel=2)
                self.tunedb_store = swap["store"] = RecordStore.open(path)
                if models_dir is None:
                    models_dir = default_models_dir(path)
            self._models_dir = models_dir or None
            models = ModelSet.load(models_dir) if models_dir else ModelSet()
            models.margin_threshold = serve_cfg.tunedb_margin
            models.max_feature_z = serve_cfg.tunedb_max_z
            if len(models):
                self.tunedb_models = models
            if serve_cfg.plan_dir is not None:
                # one install carries the store (none: plan-only), the
                # models and the artifact's plan
                swap["store"] = self.tunedb_store
                swap["plan"] = self._load_plan(serve_cfg.plan_dir)
            install_serving(models=self.tunedb_models, **swap)
        # §6 re-measurement on the card: the live model tier serves its
        # argmax and queues the top-k, which maybe_retune drains after each
        # tick.  One calibration GEMM proves the measuring path before
        # traffic arrives; a failure warns (serving goes on), and
        # calibration_tflops stays None.
        self.calibration_tflops: Optional[float] = None
        if self.measurer is not None:
            live = serving_state().models
            if live is not None:
                live.measurer = self.measurer
                live.measure_queue = self.measure_queue
            try:
                self.calibration_tflops = self.measurer("gemm",
                                                        *CALIBRATION_GEMM)
            except Exception as e:      # noqa: BLE001 — warned, not hidden
                warnings.warn(f"measure: the calibration GEMM failed "
                              f"({type(e).__name__}: {e}); re-measurements "
                              "of the model tier's picks may fail too",
                              RuntimeWarning, stacklevel=2)
        # each installed shape resolved once through dispatch under a
        # dispatch.probe root, so a trace shows each tuned shape's tier
        # from the start
        if self.tracer is not None and (serve_cfg.tunedb
                                        or serve_cfg.plan_dir):
            self._probe_dispatch()
        self.cache = init_cache(cfg, serve_cfg.slots, serve_cfg.max_len,
                                self.device)
        self.lengths = np.zeros(serve_cfg.slots, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * serve_cfg.slots
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(serve_cfg.seed)
        self.ticks = 0
        self.prefills = 0
        # the decode graph (CUDA), its static inputs and output, and the
        # store generation its configs were resolved under
        self.captures = 0
        self.replays = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_gen = -1
        self._static: Optional[Tuple[torch.Tensor, ...]] = None
        # the prefill graphs (CUDA): per prompt length (graph, static
        # tokens, static logits), the generation they were captured under,
        # their shared memory pool and the static single-slot cache
        self.prefill_captures = 0
        self.prefill_replays = 0
        self._prefill_graphs: Dict[int, Tuple[torch.cuda.CUDAGraph,
                                              torch.Tensor,
                                              torch.Tensor]] = {}
        self._prefill_gen = -1
        self._prefill_pool = None
        self._single: Optional[Dict[str, Any]] = None
        # the prefill and the tick generate runs: graphs on CUDA, eager on
        # the CPU
        cuda = self.device.type == "cuda"
        self.prefill = self.prefill_graph if cuda else self.prefill_eager
        self.decode = self.decode_graph if cuda else self.decode_eager
        cap = serve_cfg.tick_times_cap
        self.tick_times: Deque[Tuple[float, float, float]] = \
            collections.deque(maxlen=cap if cap > 0 else None)
        # the shapes a captured decode tick runs (counted once a replay)
        # and each prompt length's prefill (on CUDA every length's, kept at
        # its capture; on the CPU under store-aware admission or a router,
        # its first prefill's)
        self._decode_shapes: List[Tuple[str, Dict[str, int]]] = []
        self._prefill_shapes: Dict[int, List[Tuple[str, Dict[str, int]]]] = {}
        self.admission = (StoreAwareAdmission()
                          if serve_cfg.admission == "store" else None)
        self._last_admit_len: Optional[int] = None
        # the last generate's prompt lengths in the order it admitted them
        self.admitted: List[int] = []
        # graceful degradation: requests shed, requests the deadline
        # rejected or retired, and whether the backlog is over
        # shed_threshold
        self.shed_requests = 0
        self.deadline_retired = 0
        self.shedding = False
        # the tick count at the decode graph's latest capture
        self.last_capture_tick: Optional[int] = None
        # the fleet-global telemetry: this engine's counters dumped onto
        # the bus, and every other replica's dumps aggregated for the
        # controller (its own dump left out: its live counts fold in once)
        self.exporter: Optional[TelemetryExporter] = None
        self._fleet_view: Optional[FleetTelemetryView] = None
        if serve_cfg.retune_fleet and serve_cfg.telemetry_export_s > 0:
            from repro_torch.tunedb.fleet import FleetDir
            tel_dir = FleetDir(serve_cfg.retune_fleet).telemetry_dir()
            self.exporter = TelemetryExporter(
                get_telemetry(), tel_dir,
                interval_s=serve_cfg.telemetry_export_s).start()
            self._fleet_view = FleetTelemetryView(
                tel_dir, exclude={self.exporter.worker_id},
                refresh_s=serve_cfg.telemetry_export_s)
        self.controller: Optional[RetuneController] = None
        self._next_retune_tick = 0
        if serve_cfg.retune or serve_cfg.retune_fleet:
            self._init_controller(retune_tuners)
        # the request router: this engine is its first replica (its live
        # plan, its active slots as the load)
        self.router = None
        if serve_cfg.router:
            from .router import make_router
            self.router = make_router(serve_cfg.router)
            self.router.add_replica(
                "local", plan=lambda: serving_state().plan,
                load=lambda: sum(r is not None for r in self.slot_req))
        # the plan follower: a daemon thread installing each generation
        # published to the registry, verified and sentry-diffed
        self.follower = None
        if serve_cfg.follow:
            from repro_torch.tunedb.obs import RegressionSentry
            from repro_torch.tunedb.plans import PlanFollower
            follow_sentry = None
            if serve_cfg.follow_sentry is not None:
                follow_sentry = RegressionSentry(
                    noise_margin=serve_cfg.follow_sentry)
            self.follower = PlanFollower(
                serve_cfg.follow, store=self.tunedb_store,
                fingerprint=serve_cfg.tunedb_backend,
                poll_s=serve_cfg.follow_interval_s,
                sentry=follow_sentry).start()
        # the status endpoint reads the live serving state, this engine's
        # controller, fleet bus, follower, router and tracer, and its
        # shedding for /healthz
        self.status_server: Optional[StatusServer] = None
        if serve_cfg.status_port is not None:
            self.status_server = StatusServer(
                port=serve_cfg.status_port, controller=self.controller,
                fleet=serve_cfg.retune_fleet, follower=self.follower,
                router=self.router, tracer=self.tracer,
                health=self._health).start()

    def _probe_dispatch(self) -> None:
        """Resolve the store's first :data:`PROBE_SHAPES` shapes through
        dispatch under an always-kept ``dispatch.probe`` root; the configs
        are discarded.  Host code only: nothing runs on the card."""
        from repro_torch.kernels.dispatch import _tuned_cfg
        store = serving_state().store
        if store is None:
            return
        seen = set()
        with self.tracer.root("dispatch.probe", trace_id=new_trace_id()):
            for rec in store.records():
                key = (rec.space, shape_key(rec.inputs))
                if key in seen:
                    continue
                seen.add(key)
                _tuned_cfg(rec.space, rec.inputs)
                if len(seen) >= PROBE_SHAPES:
                    break

    def _init_controller(self, retune_tuners: Optional[Dict[str, Any]]
                         ) -> None:
        """Close the loop in-process: drift-triggered sessions and the
        hot-swap.  Sessions commit into the configured store, else into
        the installed one, else into a fresh in-memory store installed
        now (pinned to ``tunedb_backend``), kept as ``tunedb_store``."""
        sc = self.sc
        store = self.tunedb_store
        if store is None:
            store = serving_state().store
        if store is None:
            store = RecordStore()
            install_serving(store=store, fingerprint=sc.tunedb_backend)
        self.tunedb_store = store
        self.controller = RetuneController(
            store, telemetry=self._fleet_view, tuners=retune_tuners,
            tuner_factory=functools.partial(_default_tuner_factory,
                                            device=self.device),
            models_dir=self._models_dir,
            async_mode=sc.retune_async, fleet_dir=sc.retune_fleet,
            measurer=self.measurer,
            measure_queue=self.measure_queue,
            cfg=RetuneConfig(
                drift_threshold=sc.retune_drift,
                untuned_mass_threshold=sc.retune_untuned_mass,
                min_calls=sc.retune_min_calls,
                top_k_shapes=sc.retune_top_k,
                retrain=sc.retune_train,
                cooldown_ticks=sc.retune_cooldown_ticks,
                max_sessions_per_window=sc.retune_max_sessions,
                session_window_s=sc.retune_window_s,
                min_gain=sc.retune_min_gain,
                sentry=sc.retune_sentry,
                publish=sc.retune_publish))
        self._next_retune_tick = sc.retune_interval

    def _load_plan(self, plan_dir: str):
        """The artifact's plan, or None (and a warning) when it is
        rejected: the install then compiles one."""
        try:
            plan = load_plan(plan_dir)
            note = check_freshness(read_manifest(plan_dir), self.tunedb_store)
            if note:
                warnings.warn(f"plan artifact {plan_dir}: {note}",
                              RuntimeWarning, stacklevel=3)
            return plan
        except PlanArtifactError as e:
            warnings.warn(f"plan artifact {plan_dir} rejected ({e}); "
                          "compiling a plan from the store instead",
                          RuntimeWarning, stacklevel=3)
            return None

    def _health(self):
        """Readiness: ``(False, reason)`` while this engine sheds load,
        else ``True`` (what the reference's ``/healthz`` probe reads)."""
        if self.shedding:
            return (False, "shedding load: admission backlog over "
                           "shed_threshold")
        return True

    def maybe_retune(self):
        """The idle gap after each decode tick: drain up to two pending §6
        re-measurements (``MeasureQueue.process``) into the installed model
        set's memo and the plan's overlay, through the controller when one
        runs; then, every ``retune_interval`` ticks, poll the retune
        controller.  Returns its ``RetuneReport`` when an epoch ended at
        this poll (inline: ran; async: was reaped), else ``None``."""
        q = self.measure_queue
        if q is not None and len(q):
            if self.controller is not None:
                self.controller.process_measurements()
            else:
                q.process(self.measurer, models=serving_state().models)
        if self.controller is None or self.ticks < self._next_retune_tick:
            return None
        self._next_retune_tick = self.ticks + self.sc.retune_interval
        return self.controller.maybe_retune(tick=self.ticks)

    # -- prefill ---------------------------------------------------------------
    def _prefill_one(self, slot: int, req: Request) -> None:
        tokens = torch.as_tensor(req.prompt[None], dtype=torch.long,
                                 device=self.device)
        logits = self.prefill(slot, tokens)
        self.prefills += 1
        self.lengths[slot] = len(req.prompt)
        self.slot_req[slot] = req
        req.out.append(int(self._sample(logits[:, : self.cfg.vocab])[0]))

    def prefill_eager(self, slot: int, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill ``tokens`` (1, n) op by op straight into the slot's
        part of every cache leaf (zeroed first, as the reference replaces
        the slot with a fresh cache: K/V rows, and the conv and SSM state
        the prefill starts from); returns the last position's logits
        (1, V)."""
        for t in tree_leaves(self.cache):
            t[:, slot].zero_()
        single = tree_map(lambda t: t[:, slot:slot + 1], self.cache)
        n = tokens.shape[1]
        if (self.admission is None and self.router is None) \
                or n in self._prefill_shapes:
            return prefill(self.params, self.cfg, {"tokens": tokens},
                           single)[0]
        # the length's first prefill under store-aware admission or a
        # router: counted as it runs, and its shapes kept for pick / route
        with get_telemetry().capture() as cap:
            logits = prefill(self.params, self.cfg, {"tokens": tokens},
                             single)[0]
        self._prefill_shapes[n] = cap.shapes
        return logits

    def prefill_graph(self, slot: int, tokens: torch.Tensor) -> torch.Tensor:
        """The same prefill replayed from the length's CUDA graph (captured
        at the length's first prefill of this generation), then the
        single-slot cache copied into the slot.  The returned logits are
        the graph's static output: read them before the next prefill."""
        gen = serving_state().generation
        if self._prefill_gen != gen:
            # a new generation: every length is captured again, into a
            # fresh pool (the old one goes with its graphs)
            self._prefill_graphs = {}
            self._prefill_pool = None
            self._prefill_gen = gen
        n = tokens.shape[1]
        if n not in self._prefill_graphs:
            self._capture_prefill(tokens)
        graph, s_tokens, logits = self._prefill_graphs[n]
        s_tokens.copy_(tokens)
        graph.replay()
        self.prefill_replays += 1
        get_telemetry().record_ticks(self._prefill_shapes[n])
        # the reference's merge: every leaf of the single-slot cache into
        # the slot
        for big, one in zip(tree_leaves(self.cache),
                            tree_leaves(self._single)):
            big[:, slot].copy_(one[:, 0])
        return logits

    def _capture_prefill(self, tokens: torch.Tensor) -> None:
        """Capture the prefill of ``tokens``' length on a static token
        buffer into the static single-slot cache, every leaf zeroed inside
        the graph (a longer length's replay leaves K/V rows past ``n``
        behind, any replay leaves conv and SSM state, which a prefill
        reads as its start), in the prefill graphs' shared pool
        (:meth:`_captured`).  The capture's shapes are counted on each
        replay."""
        if self._single is None:
            self._single = init_cache(self.cfg, 1, self.sc.max_len,
                                      self.device)
        if self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()
        single, s_tokens = self._single, tokens.clone()
        leaves = tree_leaves(single)

        def run() -> torch.Tensor:
            for t in leaves:
                t.zero_()
            return prefill(self.params, self.cfg, {"tokens": s_tokens},
                           single)[0]

        graph, logits, shapes = self._captured(run, pool=self._prefill_pool)
        n = tokens.shape[1]
        self._prefill_graphs[n] = (graph, s_tokens, logits)
        self._prefill_shapes[n] = shapes
        self.prefill_captures += 1

    def _captured(self, fn, pool=None, keep: Sequence[torch.Tensor] = ()
                  ) -> tuple:
        """``(graph, output, shapes)``: ``fn()`` captured in a CUDA graph
        that keeps its ``cudaGraph_t``, after one eager warm-up on a side
        stream (lazy library state must exist before capture), and the
        shapes the capture dispatched.  Neither pass counts in the
        telemetry.  The tensors in ``keep`` hold after the warm-up what
        they held before it (a copy is restored): capturing runs nothing,
        so the graph's first replay then starts where the warm-up did.
        The garbage collector is off while capturing: a dead engine's
        graphs (an engine is a reference cycle) freed mid-capture would
        invalidate it (``CUDAGraph.reset`` is not permitted then).  The
        warm-up and the capture hold ``DEVICE_LOCK``: no timing
        measurement (an async retune's, on another thread) runs meanwhile.
        """
        tel = get_telemetry()
        with DEVICE_LOCK:
            saved = [t.clone() for t in keep]
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), tel.capture(count=False):
                fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            for t, s in zip(keep, saved):
                t.copy_(s)
            del saved
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with tel.capture(count=False) as cap:
                    with torch.cuda.graph(graph, pool=pool):
                        out = fn()
            finally:
                if collecting:
                    gc.enable()
            graph.instantiate()
        return graph, out, cap.shapes

    @property
    def prefill_graphs(self) -> Dict[int, torch.cuda.CUDAGraph]:
        """This generation's captured prefill graph of each prompt length
        (empty on the CPU), each keeping its ``cudaGraph_t`` as
        :attr:`graph` does."""
        return {n: g for n, (g, _, _) in self._prefill_graphs.items()}

    def prefill_pool_segments(self) -> List[dict]:
        """The prefill graphs' shared memory pool: its segments in the
        caching allocator's snapshot (each with its ``blocks``)."""
        if self._prefill_pool is None:
            return []
        pool = tuple(self._prefill_pool)
        return [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == pool]

    def prefill_graph_bytes(self) -> int:
        """Device bytes the prefill graphs' shared memory pool holds."""
        return sum(seg["total_size"] for seg in self.prefill_pool_segments())

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.sc.temperature <= 0:
            return logits.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].cpu(
            ).numpy()

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The captured decode tick (None before the first CUDA tick).  It
        keeps its ``cudaGraph_t`` (``raw_cuda_graph()``): the kernels each
        replay gives the device can be read from its nodes.  Serving itself
        needs only the instantiated graph; the kept ``cudaGraph_t`` (a
        second host copy per capture) is there for that exact count of the
        replayed kernels, which chip_smoke.py's serve phase checks."""
        return self._graph

    # -- decode tick -------------------------------------------------------------
    def decode_eager(self, last: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
        """One decode tick, op by op: last (slots, 1) tokens at positions
        idx (slots,) -> logits (slots, V)."""
        return decode_step(self.params, self.cfg, last, self.cache, idx)[0]

    def decode_graph(self, last: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
        """The same tick replayed from a CUDA graph.  The returned logits
        are the graph's static output: read them before the next tick."""
        gen = serving_state().generation
        if self._graph is None or self._graph_gen != gen:
            self._capture(last, idx)
            self._graph_gen = gen
        s_last, s_idx, logits = self._static
        s_last.copy_(last)
        s_idx.copy_(idx)
        self._graph.replay()
        self.replays += 1
        get_telemetry().record_ticks(self._decode_shapes)
        return logits

    def _capture(self, last: torch.Tensor, idx: torch.Tensor) -> None:
        """Capture :meth:`decode_eager` on static buffers holding this
        tick's inputs (:meth:`_captured`), at the first tick and again at
        the first tick of every new generation, mid-serve.  The warm-up
        runs this tick on the live cache before the replay runs it again:
        that is harmless for K/V rows (the replay writes the same values
        again) but not for a recurrent cache (conv and SSM state advance
        on every run, ``models.recurrent_leaves``), so those leaves are
        restored after the warm-up, and the replay advances them once.
        The capture's shapes are counted on each replay."""
        self._graph = self._static = None
        s_last, s_idx = last.clone(), idx.clone()
        graph, logits, shapes = self._captured(
            lambda: self.decode_eager(s_last, s_idx),
            keep=recurrent_leaves(self.cache))
        self._graph, self._static = graph, (s_last, s_idx, logits)
        self._decode_shapes = shapes
        self.captures += 1
        self.last_capture_tick = self.ticks

    # -- main loop --------------------------------------------------------------
    def generate(self, prompts: List[np.ndarray], max_new: int = 32
                 ) -> List[List[int]]:
        """Continuous-batching loop: shed and expire -> admit -> decode
        tick -> drain re-measurements in the gap -> retire.  Each admission
        and each tick opens a trace root when a tracer is on (sampled per
        ``trace_sample``); ``tr`` None is the untraced path."""
        sc = self.sc
        tel = get_telemetry()
        tr = self.tracer
        t_arrive = time.monotonic()
        queue = [Request(np.asarray(p, np.int64), max_new,
                         arrived_at=t_arrive) for p in prompts]
        pending = list(queue)
        self.admitted = []
        active = 0
        while pending or active:
            # graceful degradation at the admit boundary: overdue pending
            # requests are rejected unserved, and while the backlog is over
            # shed_threshold the newest pending ones are shed
            if sc.request_deadline_s is not None and pending:
                now = time.monotonic()
                expired = [r for r in pending
                           if now - r.arrived_at > sc.request_deadline_s]
                if expired:
                    for req in expired:
                        req.deadline_exceeded = True
                    pending = [r for r in pending if not r.deadline_exceeded]
                    self.deadline_retired += len(expired)
                    _count_degraded("rejected", len(expired))
            if sc.shed_threshold is not None:
                shed_now = 0
                while active + len(pending) > sc.shed_threshold:
                    req = pending.pop()          # the newest goes first
                    req.shed = True
                    shed_now += 1
                if shed_now:
                    self.shed_requests += shed_now
                    self.shedding = True
                    _count_degraded("shed", shed_now)
                elif active + len(pending) < sc.shed_threshold:
                    self.shedding = False        # backlog drained
            while pending:                       # admit into free slots
                slot = next((i for i, r in enumerate(self.slot_req)
                             if r is None), None)
                if slot is None:
                    break
                nxt = 0
                if self.admission is not None and len(pending) > 1:
                    nxt = self.admission.pick(pending, self._prefill_shapes,
                                              last_len=self._last_admit_len)
                req = pending.pop(nxt)
                n = len(req.prompt)
                self._last_admit_len = n
                self.admitted.append(n)
                with (tr.root("engine.admit", prompt_len=n)
                      if tr is not None else _NULL_CTX):
                    if self.router is not None:
                        # one process, one replica: the decision is made and
                        # counted all the same; a front-end holding this
                        # router over several engines places by it
                        self.router.route(self._prefill_shapes.get(n, []))
                    with (tr.span("engine.prefill", prompt_len=n)
                          if tr is not None else _NULL_CTX):
                        self._prefill_one(slot, req)
                active += 1
            if active == 0:
                break

            if sc.record_tick_times:
                t_tick, c_tick = time.perf_counter(), time.thread_time()
            with (tr.root("engine.tick", tick=self.ticks)
                  if tr is not None else _NULL_CTX):
                last = torch.as_tensor(
                    [[r.out[-1] if r is not None and r.out else 0]
                     for r in self.slot_req], dtype=torch.long,
                    device=self.device)
                idx = torch.as_tensor(self.lengths, dtype=torch.long,
                                      device=self.device)
                logits = self.decode(last, idx)
                toks = self._sample(logits[:, : self.cfg.vocab])
                self.ticks += 1
                tel.drain_pending()          # one fold of the rings a tick
                self.maybe_retune()

            now = (time.monotonic()
                   if sc.request_deadline_s is not None else 0.0)
            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                self.lengths[s] += 1
                tok = int(toks[s])
                req.out.append(tok)
                overdue = (sc.request_deadline_s is not None
                           and now - req.arrived_at > sc.request_deadline_s)
                if overdue:
                    # the deadline at the tick boundary: the request
                    # retires with the tokens it has
                    req.deadline_exceeded = True
                    self.deadline_retired += 1
                    _count_degraded("retired", 1)
                if (overdue or tok == sc.eos_token
                        or len(req.out) >= req.max_new
                        or self.lengths[s] + 1 >= sc.max_len):
                    self.slot_req[s] = None
                    self.lengths[s] = 0
                    active -= 1
            if sc.record_tick_times:
                self.tick_times.append((t_tick, time.perf_counter() - t_tick,
                                        time.thread_time() - c_tick))
        return [r.out for r in queue]


def _to_device(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda t: t.to(device), tree)
