"""Shape telemetry: which input shapes does traffic actually hit?

A port of ``repro.tunedb.telemetry``'s process-local counter.
:class:`ShapeTelemetry` is the thread-safe frequency map from ``(space,
inputs)`` to hit count that the kernel dispatcher feeds on every
``matmul`` / ``matmul2`` / ``conv2d`` / ``flash_attention`` / ``ssd_scan``
call and every decode split-count lookup.  ``hot_shapes`` mines the top-K
per space: the set an install compiles into its dispatch plan
(``store.compile_plan``).  ``save`` / ``load`` / ``merge`` move telemetry
between processes in the reference's file format, so a dump written by
either package loads in the other.

The record path is one lock-free append to the calling thread's
:class:`_Ring`; pending entries fold into the counters at the next
:meth:`ShapeTelemetry.drain_pending` (the serving engine drains once per
decode tick, and every mining or snapshot entry point drains first), so
no reader sees a stale count and no count is lost (a full ring falls back
to the locked path).

Counting semantics: counts are executions of the served program.  An
eager call records as it runs.  A program that runs without Python
(a replayed CUDA graph, the port's counterpart of the reference's jitted
decode) is counted with two hooks:

  * ``capture()`` collects every ``(space, inputs)`` recorded inside its
    block.  ``capture(count=False)`` collects without counting: the CUDA
    graph's capture pass, and the eager warm-up before it, trace the tick
    without it being a served tick.
  * ``record_ticks(shapes, n=1)`` bumps each captured shape by ``n`` per
    later execution: the engine calls it once per graph replay.

So a graph run and an eager run of the same requests count the same
shapes the same number of times, and the reference's engine (which counts
its compiling call as the first execution) reaches the same totals.

``snapshot()`` freezes the counters into a :class:`TelemetrySnapshot`;
``diff(prev)`` gives per-space :class:`SpaceDrift`: the total-variation
distance between the window's hot-shape mass and the mass ``prev`` had
accumulated, and the window's shape counts.

Fleet scope: :class:`TelemetryExporter` dumps one process's counters,
cumulatively, onto the fleet bus every few seconds, and
:class:`FleetTelemetryView` reads the fleet-global view: its own
process's live counters merged with every other process's latest dump.

The reference's dump writes go through its fault-injection shim
(``chaos.retry_io``); the port writes atomically (a temporary file,
fsync, ``os.replace``) without it (ROADMAP A6.4).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import socket
import threading
import time
import weakref
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from .store import normalize_inputs, shape_key

TELEMETRY_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """An immutable epoch snapshot of one telemetry's counters."""

    seq: int                            # monotonic per-telemetry epoch number
    # space -> shape-key -> (inputs, count); counts are cumulative
    counts: Dict[str, Dict[tuple, Tuple[Dict[str, int], int]]]

    def total(self, space: Optional[str] = None) -> int:
        spaces = [space] if space is not None else list(self.counts)
        return sum(c for s in spaces
                   for _, c in self.counts.get(s, {}).values())


@dataclasses.dataclass(frozen=True)
class SpaceDrift:
    """How one space's traffic moved between two telemetry epochs."""

    space: str
    drift: float                  # TV distance: prev mass vs window mass
    window_calls: int             # calls recorded since the prev snapshot
    prev_calls: int               # calls the prev snapshot had accumulated
    # (inputs, window count) for every shape hit in the window, hottest first
    window_shapes: List[Tuple[Dict[str, int], int]]


class _Capture:
    """The (space, inputs) pairs recorded during a capture()."""

    def __init__(self) -> None:
        self.shapes: List[Tuple[str, Dict[str, int]]] = []


RING_SIZE = 4096        # pending shapes per writer thread before fallback


class _Ring:
    """One thread's lock-free pending-shape buffer (single producer, single
    consumer).  The owning thread alone writes ``head`` and the slots; the
    drainer (serialised by the drain lock) alone writes ``tail``.  A full
    ring falls back to the locked path: counts are never dropped."""

    __slots__ = ("buf", "head", "tail")

    def __init__(self, size: int = RING_SIZE) -> None:
        self.buf: List = [None] * size
        self.head = 0           # owner-thread writes only
        self.tail = 0           # drainer writes only (under drain lock)


class ShapeTelemetry:
    """Thread-safe (space, input-shape) frequency counter with epochs.

    :meth:`record` is the locked direct upsert (tick replay, loads,
    capture attribution); :meth:`record_buffered` is the dispatch hot
    path, one append to the calling thread's ring.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # serialises drainers; the two locks nest drain -> lock only
        self._drain_lock = threading.Lock()
        # space -> shape-key tuple -> (inputs, count)
        self._counts: Dict[str, Dict[tuple, Tuple[Dict[str, int], int]]] = {}
        self._ticks: Dict[str, int] = {}     # space -> engine tick bumps
        self._seq = 0                        # snapshot epoch counter
        self._captures: List[_Capture] = []
        self._tls = threading.local()
        # every writer thread's ring with a weakref to its owner, so a
        # drain prunes the rings of threads that have ended
        self._rings: List[Tuple[object, _Ring]] = []

    # -- hot path -------------------------------------------------------------
    def _record_locked(self, space: str, inputs: Mapping[str, int],
                       n: int, feed_captures: bool = True) -> None:
        # an existing bucket is a plain dict hit on the raw key; only a
        # first-seen (or string-valued) shape pays normalize_inputs
        key = shape_key(inputs)
        per_space = self._counts.setdefault(space, {})
        cur = per_space.get(key)
        if cur is None:
            ninputs = normalize_inputs(inputs)
            key = shape_key(ninputs)
            cur = per_space.get(key, (ninputs, 0))
        per_space[key] = (cur[0], cur[1] + n)
        if feed_captures:
            for cap in self._captures:
                cap.shapes.append((space, dict(cur[0])))

    def record(self, space: str, inputs: Mapping[str, int], n: int = 1) -> None:
        with self._lock:
            if getattr(self._tls, "uncounted", 0):
                # inside capture(count=False) on this thread: collected
                # by the captures, not counted
                ninputs = normalize_inputs(inputs)
                for cap in self._captures:
                    cap.shapes.append((space, dict(ninputs)))
            else:
                self._record_locked(space, inputs, n)

    def record_buffered(self, space: str, inputs: Mapping[str, int]) -> None:
        """Lock-free single-call record: append to this thread's ring.  An
        active capture() takes the locked path, so the capture sees the
        record on its own thread."""
        if self._captures:
            self.record(space, inputs)
            return
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = self._tls.ring = _Ring()
            with self._lock:
                self._rings.append(
                    (weakref.ref(threading.current_thread()), ring))
        if ring.head - ring.tail >= len(ring.buf):
            self.record(space, inputs)      # drain-starved: locked fallback
            return
        ring.buf[ring.head % len(ring.buf)] = (space, inputs)
        ring.head += 1

    def drain_pending(self) -> int:
        """Fold every thread's pending ring entries into the counters; the
        entries were recorded outside any capture, so the fold does not
        feed captures.  Returns the entries folded."""
        drained = 0
        with self._drain_lock:
            with self._lock:
                rings = list(self._rings)
            dead = []
            for entry in rings:
                owner_ref, ring = entry
                head = ring.head            # consume up to here
                if head != ring.tail:
                    size = len(ring.buf)
                    items = [ring.buf[i % size]
                             for i in range(ring.tail, head)]
                    ring.tail = head
                    with self._lock:
                        for space, inputs in items:
                            self._record_locked(space, inputs, 1,
                                                feed_captures=False)
                    drained += len(items)
                if owner_ref() is None and ring.head == ring.tail:
                    dead.append(entry)
            if dead:
                with self._lock:
                    self._rings = [e for e in self._rings if e not in dead]
        return drained

    # -- tick hooks -----------------------------------------------------------
    @contextlib.contextmanager
    def capture(self, *, count: bool = True):
        """Collect every shape recorded inside the block.  With
        ``count=False`` the records made on this thread inside it are
        collected and not counted: the block traces a program that is not
        a served execution (a CUDA graph's capture pass and its warm-up);
        :meth:`record_ticks` then counts each execution."""
        cap = _Capture()
        self.drain_pending()            # the backlog before it is not ours
        with self._lock:
            self._captures.append(cap)
        if not count:
            self._tls.uncounted = getattr(self._tls, "uncounted", 0) + 1
        try:
            yield cap
        finally:
            if not count:
                self._tls.uncounted -= 1
            with self._lock:
                self._captures.remove(cap)

    def record_ticks(self, shapes: Iterable[Tuple[str, Mapping[str, int]]],
                     n: int = 1) -> None:
        """Bump each captured (space, inputs) by ``n`` executed ticks, under
        one lock acquire for the whole batch."""
        per_space: Dict[str, int] = {}
        with self._lock:
            for space, inputs in shapes:
                self._record_locked(space, inputs, n)
                per_space[space] = per_space.get(space, 0) + n
            for space, k in per_space.items():
                self._ticks[space] = self._ticks.get(space, 0) + k

    # -- mining ---------------------------------------------------------------
    def count(self, space: str, inputs: Mapping[str, int]) -> int:
        self.drain_pending()
        key = shape_key(normalize_inputs(inputs))
        with self._lock:
            cur = self._counts.get(space, {}).get(key)
            return 0 if cur is None else cur[1]

    def total(self, space: Optional[str] = None) -> int:
        self.drain_pending()
        with self._lock:
            spaces = [space] if space is not None else list(self._counts)
            return sum(c for s in spaces
                       for _, c in self._counts.get(s, {}).values())

    def hot_shapes(self, space: str, top_k: int = 8
                   ) -> List[Tuple[Dict[str, int], int]]:
        """Top-K (inputs, count) for one space, most frequent first (ties
        by the sorted inputs)."""
        self.drain_pending()
        with self._lock:
            items = list(self._counts.get(space, {}).values())
        items.sort(key=lambda t: (-t[1], sorted(t[0].items())))
        return [(dict(i), c) for i, c in items[:top_k]]

    def spaces(self) -> List[str]:
        self.drain_pending()
        with self._lock:
            return sorted(self._counts)

    def clear(self) -> None:
        with self._drain_lock:          # pending entries are discarded too
            with self._lock:
                rings = list(self._rings)
                self._counts.clear()
                self._ticks.clear()
                self._seq = 0
            for _owner, ring in rings:
                ring.tail = ring.head

    # -- epochs ---------------------------------------------------------------
    def snapshot(self) -> TelemetrySnapshot:
        """Freeze the current counters into an immutable epoch snapshot."""
        self.drain_pending()
        with self._lock:
            self._seq += 1
            return TelemetrySnapshot(
                seq=self._seq,
                counts={s: dict(per_space)
                        for s, per_space in self._counts.items()})

    def diff(self, prev: TelemetrySnapshot) -> Dict[str, SpaceDrift]:
        """Per-space drift of the window since ``prev``: the
        total-variation distance between the mass ``prev`` had accumulated
        and the window's mass (0 for an empty window, 1 where ``prev``
        saw nothing)."""
        cur = self.snapshot()
        out: Dict[str, SpaceDrift] = {}
        for space in sorted(set(cur.counts) | set(prev.counts)):
            now = cur.counts.get(space, {})
            old = prev.counts.get(space, {})
            window: Dict[tuple, Tuple[Dict[str, int], int]] = {}
            for key, (inputs, c) in now.items():
                gained = c - old.get(key, (None, 0))[1]
                if gained > 0:
                    window[key] = (inputs, gained)
            wtot = sum(c for _, c in window.values())
            otot = sum(c for _, c in old.values())
            if wtot == 0:
                drift = 0.0
            elif otot == 0:
                drift = 1.0
            else:
                keys = set(window) | set(old)
                drift = 0.5 * sum(
                    abs(window.get(k, (None, 0))[1] / wtot
                        - old.get(k, (None, 0))[1] / otot) for k in keys)
            shapes = sorted(window.values(),
                            key=lambda t: (-t[1], sorted(t[0].items())))
            out[space] = SpaceDrift(
                space=space, drift=drift, window_calls=wtot, prev_calls=otot,
                window_shapes=[(dict(i), c) for i, c in shapes])
        return out

    # -- persistence -----------------------------------------------------------
    def save(self, path: os.PathLike) -> None:
        """Write the counters as the reference's JSON dump, atomically."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.drain_pending()
        with self._lock:
            payload = {
                "version": TELEMETRY_VERSION,
                "counts": {
                    s: [{"inputs": i, "count": c}
                        for i, c in per_space.values()]
                    for s, per_space in self._counts.items()},
                "ticks": dict(self._ticks),
            }
        tmp = path.with_name(path.name + ".tmp")
        with tmp.open("w", encoding="utf-8") as fh:
            fh.write(json.dumps(payload, sort_keys=True))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: os.PathLike) -> "ShapeTelemetry":
        t = cls()
        payload = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
        for space, entries in payload.get("counts", {}).items():
            for e in entries:
                t.record(space, e["inputs"], n=int(e["count"]))
        with t._lock:
            t._ticks.update({s: int(n) for s, n
                             in payload.get("ticks", {}).items()})
        return t

    def merge(self, other: "ShapeTelemetry") -> None:
        other.drain_pending()
        with other._lock:
            items = [(space, list(per_space.values()))
                     for space, per_space in other._counts.items()]
            ticks = dict(other._ticks)
        for space, values in items:
            for inputs, count in values:
                self.record(space, inputs, n=count)
        with self._lock:
            for space, n in ticks.items():
                self._ticks[space] = self._ticks.get(space, 0) + n

    def stats(self) -> Dict[str, object]:
        self.drain_pending()
        with self._lock:
            return {
                "spaces": {s: {"shapes": len(m),
                               "calls": sum(c for _, c in m.values())}
                           for s, m in self._counts.items()},
                "ticks": dict(self._ticks),
                "epoch": self._seq,
            }


# ---------------------------------------------------------------------------
# Fleet scope: periodic cumulative dumps and the aggregated global view.
# ---------------------------------------------------------------------------

def _count_dump(worker_id: str) -> None:
    from .obs.metrics import get_registry       # obs imports telemetry
    get_registry().counter(
        "tunedb_telemetry_dumps_total",
        "cumulative telemetry dumps exported to the fleet bus",
    ).inc(worker=worker_id)


class TelemetryExporter:
    """Periodic export of one process's telemetry to the fleet bus.

    Every ``interval_s`` a daemon thread writes a cumulative dump of
    ``telemetry`` to ``<out_dir>/<worker_id>/<epoch>.json``
    (:meth:`ShapeTelemetry.save`: a temporary file, then a rename), the
    epoch in the name bumped each time.  Cumulative dumps make the
    aggregation idempotent: a reader folds only each worker's latest
    epoch, so a torn read or a missed interval never counts a call twice.
    The last ``keep`` epochs are kept, so the directory stays
    O(workers).
    """

    def __init__(self, telemetry: ShapeTelemetry, out_dir: os.PathLike, *,
                 worker_id: Optional[str] = None, interval_s: float = 5.0,
                 keep: int = 2) -> None:
        self.telemetry = telemetry
        self.out_dir = pathlib.Path(out_dir)
        self.worker_id = worker_id or (
            f"{socket.gethostname()}-{os.getpid()}")
        self.interval_s = float(interval_s)
        self.keep = max(1, int(keep))
        self.exports = 0
        self._epoch = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def export_once(self) -> pathlib.Path:
        """Write one cumulative dump; returns its path."""
        self._epoch += 1
        dest = self.out_dir / self.worker_id / f"{self._epoch:08d}.json"
        self.telemetry.save(dest)
        self.exports += 1
        _count_dump(self.worker_id)
        for p in sorted(dest.parent.glob("*.json"))[:-self.keep]:
            try:
                p.unlink()
            except OSError:              # a concurrent reader won the race
                pass
        return dest

    def start(self) -> "TelemetryExporter":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.export_once()
                except OSError:          # the next interval tries again
                    pass

        self._thread = threading.Thread(
            target=loop, name=f"telemetry-export-{self.worker_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, *, final_export: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_export:
            try:                         # the window's tail lands too
                self.export_once()
            except OSError:
                pass

    def stats(self) -> Dict[str, object]:
        return {"worker_id": self.worker_id, "epoch": self._epoch,
                "exports": self.exports, "interval_s": self.interval_s,
                "out_dir": str(self.out_dir)}


class FleetTelemetryView:
    """Fleet-global telemetry: local counters merged with every worker's
    latest dump.

    Reads as a :class:`ShapeTelemetry` does (``snapshot`` / ``diff`` /
    ``count`` / ``hot_shapes`` / ``spaces`` / ``total`` / ``stats`` /
    ``drain_pending``), so the retune controller and the coordinator's
    planning consume the global view unchanged.  Each :meth:`refresh`
    rebuilds a merged :class:`ShapeTelemetry` from ``local`` and the
    latest readable dump of every worker under ``dump_root`` (a torn or
    pruned one falls back to the worker's previous epoch); ``exclude``
    names the worker directories to skip (a process that exports and
    aggregates leaves its own dump out, so its live counts fold in once).
    Reads are throttled to ``refresh_s``; ``snapshot`` / ``diff`` /
    ``stats`` always rebuild.
    """

    scope = "fleet"

    def __init__(self, dump_root: os.PathLike, *,
                 local: Optional[ShapeTelemetry] = None,
                 refresh_s: float = 2.0,
                 exclude: Iterable[str] = ()) -> None:
        self.dump_root = pathlib.Path(dump_root)
        self.local = local if local is not None else get_telemetry()
        self.refresh_s = float(refresh_s)
        self.exclude = frozenset(exclude)
        self.refreshes = 0
        self._lock = threading.Lock()
        self._merged = ShapeTelemetry()
        self._replicas: Dict[str, Dict[str, object]] = {}
        self._last_refresh: Optional[float] = None

    def refresh(self, force: bool = False) -> ShapeTelemetry:
        """The merged view, rebuilt unless the throttle window holds."""
        now = time.monotonic()
        with self._lock:
            if (not force and self._last_refresh is not None
                    and now - self._last_refresh < self.refresh_s):
                return self._merged
            merged = ShapeTelemetry()
            merged.merge(self.local)
            replicas: Dict[str, Dict[str, object]] = {}
            if self.dump_root.is_dir():
                for wdir in sorted(self.dump_root.iterdir()):
                    if not wdir.is_dir() or wdir.name in self.exclude:
                        continue
                    prov = self._merge_worker(merged, wdir)
                    if prov is not None:
                        replicas[wdir.name] = prov
            self._merged = merged
            self._replicas = replicas
            self._last_refresh = now
            self.refreshes += 1
            return merged

    @staticmethod
    def _merge_worker(merged: ShapeTelemetry,
                      wdir: pathlib.Path) -> Optional[Dict[str, object]]:
        """Fold one worker's latest readable dump; its provenance, or
        None."""
        for latest in sorted(wdir.glob("*.json"), reverse=True):
            try:
                dump = ShapeTelemetry.load(latest)
                age_s = max(0.0, time.time() - latest.stat().st_mtime)
            except (OSError, ValueError):    # pruned or torn: an older one
                continue
            merged.merge(dump)
            try:
                epoch = int(latest.stem)
            except ValueError:
                epoch = -1
            from .obs.metrics import get_registry
            get_registry().gauge(
                "tunedb_fleet_telemetry_lag_seconds",
                "age of the newest readable telemetry dump per worker",
            ).set(age_s, worker=wdir.name)
            return {"epoch": epoch, "calls": dump.total(), "age_s": age_s}
        return None

    def replicas(self) -> Dict[str, Dict[str, object]]:
        """Per-replica provenance: worker -> {epoch, calls, age_s}."""
        self.refresh()
        with self._lock:
            return {w: dict(p) for w, p in self._replicas.items()}

    # -- the ShapeTelemetry read surface ---------------------------------------
    def snapshot(self) -> TelemetrySnapshot:
        return self.refresh(force=True).snapshot()

    def diff(self, prev: TelemetrySnapshot) -> Dict[str, SpaceDrift]:
        return self.refresh(force=True).diff(prev)

    def count(self, space: str, inputs: Mapping[str, int]) -> int:
        return self.refresh().count(space, inputs)

    def hot_shapes(self, space: str, top_k: int = 8
                   ) -> List[Tuple[Dict[str, int], int]]:
        return self.refresh().hot_shapes(space, top_k)

    def spaces(self) -> List[str]:
        return self.refresh().spaces()

    def total(self, space: Optional[str] = None) -> int:
        return self.refresh().total(space)

    def drain_pending(self) -> int:
        return self.local.drain_pending()

    def stats(self) -> Dict[str, object]:
        out = self.refresh(force=True).stats()
        with self._lock:
            out["scope"] = self.scope
            out["replicas"] = {w: dict(p) for w, p in self._replicas.items()}
        return out


# the process-global telemetry the dispatcher feeds
_TELEMETRY = ShapeTelemetry()


def get_telemetry() -> ShapeTelemetry:
    return _TELEMETRY


def record_shape(space: str, inputs: Mapping[str, int]) -> None:
    """Dispatcher entry point: one lock-free ring append per call."""
    _TELEMETRY.record_buffered(space, inputs)


def clear_telemetry() -> None:
    _TELEMETRY.clear()
