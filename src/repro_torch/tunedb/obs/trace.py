"""Request tracing: spans, sampling, Chrome trace-event export.

A port of ``repro.tunedb.obs.trace``.  The metrics registry answers *how
much*; this module answers *where did this request's time go*: spans that
follow one request through admission and prefill, the decode ticks, the
dispatch tier resolutions, the retune submit-to-swap window and the
serving path's kernel measurements, all on one ``time.perf_counter``
clock.  The export is Chrome trace-event JSON (Perfetto,
``chrome://tracing``).

Design rules, as in the reference:

1. **Disabled costs zero instrument calls.**  The module global
   :data:`_TRACER` is ``None`` until :func:`enable_tracing` runs; every
   instrumented call site reads that one attribute and, finding ``None``,
   runs the untraced path.
2. **Sampling is decided once, at the trace root.**  ``sample=0.01`` keeps
   every 100th root (a deterministic stride); an unsampled root pushes no
   context, so every child ``span()`` under it returns the shared
   :data:`_NULL_SPAN`.  A root opened with an explicit ``trace_id`` is
   always kept.
3. **Finished spans ride the telemetry's ``_Ring``.**  Completing a span
   appends to the calling thread's single-producer ring; :meth:`Tracer.drain`
   folds the rings into a bounded deque at export or scrape time.  A full
   ring falls back to the locked store; only the retention cap
   (``max_spans``) evicts, counted in ``overflow``.

A span reads the host clock only: it never touches the card.  On CUDA the
engine replays each prefill and tick from a CUDA graph, so an
``engine.tick`` root spans the replay and the sampling's copy to the host
(the device's time included), and ``dispatch.resolve`` spans come only
from graph captures, their eager warm-ups and eager paths: a replay
resolves nothing on the host.  This module imports no ``torch``.

A fleet worker process dumps its finished spans to
``<fleet>/traces/<worker>.jsonl`` (:meth:`Tracer.export_jsonl`), and
:func:`collect_fleet_spans` merges them back (a torn file or line is
skipped): a worker's ``fleet.job`` roots carry the trace id of the retune
epoch that published the job, so one trace holds the epoch's submit to
its swap across processes.  The reference writes the dumps through its
fault-injection shim (ROADMAP A6.4); the port writes the lines plainly.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time
import uuid
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from ..telemetry import _Ring

__all__ = [
    "Span", "Tracer", "chrome_trace", "collect_fleet_spans",
    "enable_tracing", "get_tracer", "load_span_file", "new_trace_id",
    "reset_tracing", "summarize_spans",
]

TRACE_SCHEMA_VERSION = 1
SPAN_RING_SIZE = 2048       # finished spans buffered per writer thread
MAX_SPANS = 20000           # retained finished spans (process-wide cap)
FLEET_TRACE_DIR = "traces"  # <fleet>/traces/<worker>.jsonl span dumps

# Span-name taxonomy (the reference's):
#   request.route     router decision            engine.admit      admission
#   engine.prefill    prefill compile+run        engine.tick       decode tick
#   dispatch.resolve  tier resolution            retune.epoch      submit->swap
#   fleet.job         worker tuning session      fleet.merge       coordinator
#   plan.install      follower install attempt   measure.*         wall-clock /
#                                                                  sim measure
SPAN_DISPATCH = "dispatch.resolve"


def new_trace_id() -> str:
    """Mint a trace id.  Opening a root with an explicit id bypasses
    sampling — used for spans that must always be kept (measurements,
    adopted fleet-job traces)."""
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation.  ``t0``/``dur`` are ``time.perf_counter``
    seconds — every span in a process shares that clock, which is the
    whole point of putting serving ticks and tuner measurements in one
    Perfetto view."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "tid",
                 "t0", "dur", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str = "", tid: int = 0) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid or threading.get_ident()
        self.t0 = 0.0
        self.dur = 0.0
        self.attrs: Dict[str, object] = {}

    def set(self, **attrs: object) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_json(self) -> Dict[str, object]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "tid": self.tid, "t0": self.t0, "dur": self.dur,
                "attrs": dict(self.attrs)}

    @classmethod
    def from_json(cls, d: Dict) -> "Span":
        sp = cls(str(d["name"]), str(d["trace_id"]), str(d["span_id"]),
                 str(d.get("parent_id", "")), int(d.get("tid", 0)))
        sp.t0 = float(d["t0"])
        sp.dur = float(d["dur"])
        attrs = d.get("attrs") or {}
        if not isinstance(attrs, dict):
            raise ValueError("span attrs must be a dict")
        sp.attrs = attrs
        return sp


class _NullSpan:
    """Shared reusable no-op context manager: what ``span()`` returns when
    there is no sampled trace on the thread.  One module-level instance —
    the unsampled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager that pushes a live span on the thread stack,
    stamps ``t0`` on enter and ``dur`` on exit, then hands the finished
    span to the tracer's ring."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        self._span.t0 = time.perf_counter()
        return self._span

    def __exit__(self, et, ev, tb) -> bool:
        sp = self._span
        sp.dur = time.perf_counter() - sp.t0
        if et is not None:
            sp.attrs.setdefault("error", et.__name__)
        self._tracer._finish(sp)
        return False


class Tracer:
    """Process-wide span recorder with stride sampling and ring buffers."""

    def __init__(self, sample: float = 1.0,
                 max_spans: int = MAX_SPANS) -> None:
        self._lock = threading.Lock()
        self._drain_lock = threading.Lock()     # nests drain -> lock
        self._spans: Deque[Span] = deque(maxlen=max_spans)
        self.max_spans = max_spans
        self.sampled = 0        # roots kept
        self.dropped = 0        # roots skipped by sampling
        self.overflow = 0       # finished spans evicted by the cap
        self._roots = 0         # stride counter
        self._next_id = 0
        self._tls = threading.local()
        self._rings: List[Tuple[object, _Ring]] = []
        self.sample = 1.0
        self._stride = 1
        self.set_sample(sample)

    # -- sampling ---------------------------------------------------------
    def set_sample(self, sample: float) -> None:
        sample = min(max(float(sample), 0.0), 1.0)
        self.sample = sample
        self._stride = int(round(1.0 / sample)) if sample > 0 else 0

    # -- thread context ---------------------------------------------------
    def current_trace_id(self) -> Optional[str]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1].trace_id if stack else None

    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _new_span_id(self) -> str:
        with self._lock:
            self._next_id += 1
            return f"s{self._next_id:x}"

    # -- span lifecycle ---------------------------------------------------
    def root(self, name: str, trace_id: Optional[str] = None,
             **attrs: object):
        """Open a new trace.  ``trace_id=None`` mints an id and applies
        the sampling stride; an explicit id adopts an upstream-sampled
        trace and is always kept."""
        if trace_id is None:
            with self._lock:
                self._roots += 1
                keep = self._stride > 0 and self._roots % self._stride == 0
                if keep:
                    self.sampled += 1
                else:
                    self.dropped += 1
            if not keep:
                return _NULL_SPAN
            trace_id = uuid.uuid4().hex[:16]
        else:
            with self._lock:
                self.sampled += 1
        sp = Span(name, trace_id, self._new_span_id())
        sp.attrs.update(attrs)
        return _SpanCtx(self, sp)

    def span(self, name: str, **attrs: object):
        """Child span under the thread's current trace; no-op (shared
        :data:`_NULL_SPAN`) when no sampled trace is open here."""
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return _NULL_SPAN
        parent = stack[-1]
        sp = Span(name, parent.trace_id, self._new_span_id(),
                  parent_id=parent.span_id)
        sp.attrs.update(attrs)
        return _SpanCtx(self, sp)

    def begin(self, name: str, trace_id: Optional[str] = None,
              parent_id: str = "", **attrs: object) -> Optional[Span]:
        """Start a *detached* span — finished later (possibly from another
        thread) with :meth:`end`.  Used for windows that outlive the
        opening frame, like the retune submit→swap window.  Does not touch
        the thread context.  Returns ``None`` when sampling drops it."""
        if trace_id is None:
            with self._lock:
                self._roots += 1
                keep = self._stride > 0 and self._roots % self._stride == 0
                if keep:
                    self.sampled += 1
                else:
                    self.dropped += 1
            if not keep:
                return None
            trace_id = uuid.uuid4().hex[:16]
        sp = Span(name, trace_id, self._new_span_id(), parent_id=parent_id)
        sp.attrs.update(attrs)
        sp.t0 = time.perf_counter()
        return sp

    def end(self, span: Optional[Span], **attrs: object) -> None:
        """Finish a detached span from :meth:`begin` (None-safe).  The
        finisher may be any thread, so this takes the locked store path
        rather than a ring — detached windows are rare by construction."""
        if span is None:
            return
        span.dur = time.perf_counter() - span.t0
        span.attrs.update(attrs)
        with self._lock:
            self._store_locked(span)

    def _finish(self, span: Span) -> None:
        """Owner-thread completion: pop the context stack, publish the
        finished span to this thread's lock-free ring."""
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack:                                 # tolerate misnesting
            try:
                stack.remove(span)
            except ValueError:
                pass
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            import weakref
            ring = self._tls.ring = _Ring(SPAN_RING_SIZE)
            with self._lock:
                self._rings.append(
                    (weakref.ref(threading.current_thread()), ring))
        if ring.head - ring.tail >= len(ring.buf):  # drain-starved
            with self._lock:
                self._store_locked(span)
            return
        ring.buf[ring.head % len(ring.buf)] = span
        ring.head += 1

    def _store_locked(self, span: Span) -> None:
        if len(self._spans) >= self.max_spans:
            self.overflow += 1
        self._spans.append(span)

    # -- draining / reading ----------------------------------------------
    def drain(self) -> int:
        """Fold every thread's pending ring into the retained deque;
        prune rings whose owner thread died.  Returns spans folded."""
        drained = 0
        with self._drain_lock:
            with self._lock:
                rings = list(self._rings)
            batch: List[Span] = []
            for _ref, ring in rings:
                head = ring.head                    # snapshot the publish
                size = len(ring.buf)
                while ring.tail < head:
                    batch.append(ring.buf[ring.tail % size])
                    ring.tail += 1
            with self._lock:
                for sp in batch:
                    self._store_locked(sp)
                self._rings = [(r, ring) for r, ring in self._rings
                               if r() is not None and r().is_alive()
                               or ring.head > ring.tail]
            drained = len(batch)
        return drained

    def buffered(self) -> int:
        """Spans sitting in per-thread rings, not yet drained."""
        with self._lock:
            rings = list(self._rings)
        return sum(max(0, ring.head - ring.tail) for _ref, ring in rings)

    def spans(self) -> List[Span]:
        self.drain()
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        self.drain()
        with self._lock:
            self._spans.clear()

    # -- reporting --------------------------------------------------------
    def tier_latency(self) -> Dict[str, Dict[str, float]]:
        """Per-tier dispatch resolution latency attribution, from the
        retained ``dispatch.resolve`` spans (sampled traffic only)."""
        out: Dict[str, Dict[str, float]] = {}
        for sp in self.spans():
            if sp.name != SPAN_DISPATCH:
                continue
            tier = str(sp.attrs.get("tier", "unknown"))
            ent = out.setdefault(tier, {"count": 0, "total_us": 0.0})
            ent["count"] += 1
            ent["total_us"] += sp.dur * 1e6
        for ent in out.values():
            ent["mean_us"] = (ent["total_us"] / ent["count"]
                              if ent["count"] else 0.0)
        return out

    def stats(self) -> Dict[str, object]:
        """The ``trace`` section of ``status_snapshot()``."""
        buffered = self.buffered()
        with self._lock:
            retained = len(self._spans)
            sampled, dropped = self.sampled, self.dropped
            overflow = self.overflow
        return {"enabled": True, "sample": self.sample,
                "sampled": sampled, "dropped": dropped,
                "spans": retained, "buffered": buffered,
                "overflow": overflow, "max_spans": self.max_spans,
                "tiers": self.tier_latency()}

    # -- export -----------------------------------------------------------
    def export(self, path) -> int:
        """Write retained spans as Chrome trace-event JSON (atomic
        tmp+rename).  Returns the event count."""
        spans = self.spans()
        doc = chrome_trace(spans)
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(doc))
        tmp.replace(path)
        return len(spans)

    def export_jsonl(self, path) -> int:
        """Append retained spans as one-JSON-per-line records (the fleet
        bus dump format), then drop them from retention so repeated dumps
        don't duplicate.  A reader tolerates a torn final line."""
        spans = self.spans()
        if not spans:
            return 0
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        buf = "".join(json.dumps(sp.to_json()) + "\n" for sp in spans)
        from .. import chaos               # obs is imported by tunedb: lazy
        io = chaos._IO
        with open(path, "a") as f:
            if io is None:
                f.write(buf)
            else:                          # a torn dump is a torn last
                io.file_write(f, buf, "trace.export")  # line: read past
        with self._lock:
            self._spans.clear()
        return len(spans)


# ---------------------------------------------------------------------------
# Chrome trace-event assembly + torn-tolerant loading

def chrome_trace(spans: Iterable[Span], pid: Optional[int] = None) -> Dict:
    """Spans → the Chrome trace-event JSON object Perfetto loads.

    Every span becomes one complete ("ph": "X") event; trace/span/parent
    ids ride in ``args`` so linked spans stay linked across process
    merges."""
    events = []
    for sp in spans:
        events.append({
            "name": sp.name, "cat": "tunedb", "ph": "X",
            "ts": sp.t0 * 1e6, "dur": max(sp.dur, 0.0) * 1e6,
            "pid": int(pid if pid is not None else os.getpid()),
            "tid": int(sp.tid),
            "args": {"trace_id": sp.trace_id, "span_id": sp.span_id,
                     "parent_id": sp.parent_id, **sp.attrs},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA_VERSION}}


def _span_from_event(ev: Dict) -> Span:
    args = ev.get("args") or {}
    sp = Span(str(ev["name"]), str(args.get("trace_id", "")),
              str(args.get("span_id", "")),
              str(args.get("parent_id", "")), int(ev.get("tid", 0)))
    sp.t0 = float(ev["ts"]) / 1e6
    sp.dur = float(ev.get("dur", 0.0)) / 1e6
    sp.attrs = {k: v for k, v in args.items()
                if k not in ("trace_id", "span_id", "parent_id")}
    return sp


def load_span_file(path) -> List[Span]:
    """Read spans from a ``.jsonl`` dump or a Chrome trace JSON file.

    Torn, partial, or junk content — a worker died mid-write, a file is
    mid-rename — is SKIPPED, never raised: a bad line drops that line, an
    unparseable whole-file document drops that file.  The fleet exporter
    must survive any bytes the bus can contain."""
    path = pathlib.Path(path)
    try:
        text = path.read_text()
    except OSError:
        return []
    spans: List[Span] = []
    # Chrome trace document?  Both formats open with "{", so decide by
    # whether the WHOLE text parses to a dict carrying traceEvents — a
    # multi-line JSONL dump fails that parse and falls through below.
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return []
        for ev in events:
            try:
                spans.append(_span_from_event(ev))
            except (KeyError, TypeError, ValueError):
                continue                            # bad event: skip it
        return spans
    for line in text.splitlines():                  # span JSONL dump
        line = line.strip()
        if not line:
            continue
        try:
            spans.append(Span.from_json(json.loads(line)))
        except (KeyError, TypeError, ValueError):
            continue                                # torn line: skip it
    return spans


def collect_fleet_spans(fleet_dir) -> List[Span]:
    """Every worker span dump under ``<fleet>/traces/`` (and any Chrome
    export dropped there) merged, unreadable files skipped."""
    root = pathlib.Path(fleet_dir) / FLEET_TRACE_DIR
    spans: List[Span] = []
    if not root.is_dir():
        return spans
    for p in sorted(root.iterdir()):
        if p.suffix in (".jsonl", ".json"):
            spans.extend(load_span_file(p))
    return spans


def summarize_spans(spans: Iterable[Span]) -> Dict[str, object]:
    """Per-name counts/latencies + per-tier dispatch attribution — the
    ``tunedb trace summary`` payload."""
    names: Dict[str, Dict[str, float]] = {}
    tiers: Dict[str, Dict[str, float]] = {}
    traces = set()
    n = 0
    for sp in spans:
        n += 1
        traces.add(sp.trace_id)
        ent = names.setdefault(sp.name, {"count": 0, "total_us": 0.0,
                                         "max_us": 0.0})
        us = sp.dur * 1e6
        ent["count"] += 1
        ent["total_us"] += us
        ent["max_us"] = max(ent["max_us"], us)
        if sp.name == SPAN_DISPATCH:
            tier = str(sp.attrs.get("tier", "unknown"))
            t = tiers.setdefault(tier, {"count": 0, "total_us": 0.0})
            t["count"] += 1
            t["total_us"] += us
    for ent in names.values():
        ent["mean_us"] = ent["total_us"] / ent["count"]
    for ent in tiers.values():
        ent["mean_us"] = ent["total_us"] / ent["count"]
    return {"spans": n, "traces": len(traces), "names": names,
            "tiers": tiers}


# ---------------------------------------------------------------------------
# process-global tracer.  None == disabled: instrumented call sites read
# this single attribute (``trace._TRACER``) and take the untraced path —
# no method call, no allocation (the E18 zero-instrument-call gate).

_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enable_tracing(sample: float = 1.0,
                   max_spans: int = MAX_SPANS) -> Tracer:
    """Install (or retune the sampling of) the process-global tracer."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = Tracer(sample=sample, max_spans=max_spans)
        else:
            _TRACER.set_sample(sample)
    return _TRACER


def reset_tracing() -> None:
    """Disable tracing and discard the tracer (tests / benchmarks)."""
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = None
