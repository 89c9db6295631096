"""Process-wide metrics registry: counters, gauges, ring-buffer histograms.

A port of ``repro.tunedb.obs.metrics``.  The dispatch hot path keeps its
own integer counters (``DispatchPlan.hits``, ``RecordStore.hits``, ...);
the registry reads them at scrape time through *collectors*, so a
dispatch is byte for byte the same with metrics on or off.  Events off
the hot path (degradations, sentry refusals, retune epochs) increment real
instruments:

* :class:`Counter` keeps one shard dict per writer thread.  The owning
  thread is the only mutator of its shard (a dict item write is atomic
  under the GIL) and readers merge ``list(shard.items())`` snapshots, so no
  increment is lost and the write side takes no lock.  A dead thread's
  shard folds into a base total at the next read.
* :class:`Gauge` is last-write-wins per label set, under a small lock.
* :class:`Histogram` keeps a per-thread ring (telemetry's ``_Ring``) of the
  last :data:`HIST_RING_SIZE` observations plus an exact count and sum;
  quantiles are computed at scrape time over the merged rings.

:meth:`MetricsRegistry.render_prometheus` writes the Prometheus text
format (a histogram as a ``summary`` with quantile labels);
:meth:`MetricsRegistry.snapshot` gives the same data as JSON-able dicts.
The plan followers' state is read at scrape time too (the
``tunedb_follower_*`` families), so their poll path makes no instrument
call.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

from ..telemetry import _Ring

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Sample",
    "get_registry", "reset_metrics",
]

LabelKey = Tuple[Tuple[str, str], ...]

HIST_RING_SIZE = 1024       # recent observations kept per writer thread
QUANTILES = (0.5, 0.9, 0.99)


def _label_key(labels: Mapping[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Sample:
    """One exported time-series point: ``name{labels} value``."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey, value: float) -> None:
        self.name = name
        self.labels = labels
        self.value = value


class _Metric:
    """Name, help text and Prometheus type of one instrument."""

    kind = "untyped"

    def __init__(self, name: str, help: str) -> None:
        self.name = name
        self.help = help

    def samples(self) -> List[Sample]:  # pragma: no cover - interface
        raise NotImplementedError


def _owner_alive(ref: weakref.ref) -> bool:
    thread = ref()
    return thread is not None and thread.is_alive()


class Counter(_Metric):
    """Monotonic counter with lock-free per-thread shards."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._tls = threading.local()
        self._lock = threading.Lock()               # the shard list only
        self._shards: List[Tuple[weakref.ref, Dict[LabelKey, float]]] = []
        self._base: Dict[LabelKey, float] = {}      # dead threads' shards

    def inc(self, n: float = 1.0, **labels: str) -> None:
        shard = getattr(self._tls, "shard", None)
        if shard is None:
            shard = self._tls.shard = {}
            with self._lock:
                self._shards.append((weakref.ref(threading.current_thread()),
                                     shard))
        key = _label_key(labels)
        shard[key] = shard.get(key, 0.0) + n        # owner thread only

    def value(self, **labels: str) -> float:
        key = _label_key(labels)
        return {s.labels: s.value for s in self.samples()}.get(key, 0.0)

    def samples(self) -> List[Sample]:
        with self._lock:
            totals = dict(self._base)
            live = []
            for ref, shard in self._shards:
                for key, val in list(shard.items()):  # one C call: no tear
                    totals[key] = totals.get(key, 0.0) + val
                if _owner_alive(ref):
                    live.append((ref, shard))
                else:
                    # the owner is gone: fold a fresh snapshot (it may
                    # have written after the one above, before it ended)
                    for key, val in list(shard.items()):
                        self._base[key] = self._base.get(key, 0.0) + val
            self._shards = live
        return [Sample(self.name, k, v) for k, v in sorted(totals.items())]


class Gauge(_Metric):
    """Last-write-wins value per label set (set from control paths)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels: str) -> Optional[float]:
        with self._lock:
            return self._values.get(_label_key(labels))

    def samples(self) -> List[Sample]:
        with self._lock:
            items = sorted(self._values.items())
        return [Sample(self.name, k, v) for k, v in items]


class _HistShard:
    """One writer thread's slice of a histogram: a ring of recent
    observations plus owner-written count and sum."""

    __slots__ = ("ring", "count", "total")

    def __init__(self) -> None:
        self.ring = _Ring(HIST_RING_SIZE)
        self.count = 0
        self.total = 0.0


class Histogram(_Metric):
    """Observations with ring-buffer quantiles, rendered as a Prometheus
    ``summary``: ``name{quantile="0.5"}`` over the last
    :data:`HIST_RING_SIZE` observations of each writer thread, and exact
    ``name_count`` / ``name_sum``."""

    kind = "summary"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._shards: List[Tuple[weakref.ref, _HistShard]] = []
        self._base_count = 0
        self._base_total = 0.0

    def observe(self, value: float) -> None:
        shard = getattr(self._tls, "shard", None)
        if shard is None:
            shard = self._tls.shard = _HistShard()
            with self._lock:
                self._shards.append((weakref.ref(threading.current_thread()),
                                     shard))
        ring = shard.ring
        ring.buf[ring.head % len(ring.buf)] = float(value)
        ring.head += 1                              # publish after the slot
        shard.count += 1
        shard.total += value

    def _window(self) -> List[float]:
        out: List[float] = []
        with self._lock:
            shards = list(self._shards)
        for _ref, shard in shards:
            ring = shard.ring
            head, size = ring.head, len(ring.buf)
            for i in range(max(0, head - size), head):
                v = ring.buf[i % size]
                if v is not None:
                    out.append(v)
        return out

    def quantiles(self, qs: Iterable[float] = QUANTILES) -> Dict[float, float]:
        window = sorted(self._window())
        if not window:
            return {q: 0.0 for q in qs}
        last = len(window) - 1
        return {q: window[min(last, int(round(q * last)))] for q in qs}

    def stats(self) -> Tuple[int, float]:
        """(count, sum) of every observation so far."""
        count, total = self._base_count, self._base_total
        with self._lock:
            live = []
            for ref, shard in self._shards:
                count += shard.count
                total += shard.total
                if _owner_alive(ref):
                    live.append((ref, shard))
                else:
                    self._base_count += shard.count
                    self._base_total += shard.total
            self._shards = live
        return count, total

    def samples(self) -> List[Sample]:
        count, total = self.stats()
        out = [Sample(self.name, (("quantile", f"{q:g}"),), v)
               for q, v in sorted(self.quantiles().items())]
        out.append(Sample(self.name + "_count", (), float(count)))
        out.append(Sample(self.name + "_sum", (), total))
        return out


Collector = Callable[[], Iterable[Tuple[str, str, Mapping[str, str], float]]]
"""A collector yields ``(name, kind, labels, value)`` tuples at scrape time."""


class MetricsRegistry:
    """Named instruments and scrape-time collectors, one per process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Collector] = []

    def _get(self, cls, name: str, help: str) -> _Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help)
            elif not isinstance(metric, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(metric).__name__}")
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)       # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)         # type: ignore[return-value]

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)     # type: ignore[return-value]

    def register_collector(self, fn: Collector) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _collected(self) -> List[Tuple[str, str, LabelKey, float]]:
        with self._lock:
            collectors = list(self._collectors)
        out: List[Tuple[str, str, LabelKey, float]] = []
        for fn in collectors:
            try:
                for name, kind, labels, value in fn():
                    out.append((name, kind, _label_key(labels), float(value)))
            except Exception:       # noqa: BLE001 — a broken collector
                continue            # never breaks the scrape
        return out

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able view: ``{name: {"kind", "help", "samples": [...]}}``."""
        out: Dict[str, Dict] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            out[metric.name] = {
                "kind": metric.kind,
                "help": metric.help,
                "samples": [{"labels": dict(s.labels), "value": s.value}
                            for s in metric.samples()],
            }
        for name, kind, labels, value in self._collected():
            entry = out.setdefault(name, {"kind": kind, "help": "",
                                          "samples": []})
            entry["samples"].append({"labels": dict(labels), "value": value})
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        seen: set = set()

        def emit(name: str, kind: str, help: str, labels: LabelKey,
                 value: float) -> None:
            family = name[:-6] if name.endswith("_count") else (
                name[:-4] if name.endswith("_sum") else name)
            if family not in seen:
                seen.add(family)
                if help:
                    lines.append(f"# HELP {family} {help}")
                lines.append(f"# TYPE {family} {kind}")
            if labels:
                body = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
                lines.append(f"{name}{{{body}}} {_fmt(value)}")
            else:
                lines.append(f"{name} {_fmt(value)}")

        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            for s in metric.samples():
                emit(s.name, metric.kind, metric.help, s.labels, s.value)
        for name, kind, labels, value in self._collected():
            emit(name, kind, "", labels, value)
        return "\n".join(lines) + "\n"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _serving_collector():
    """The serving stack's own counters at scrape time: the generation,
    the store's lookups, the model tier's, the plan's and the telemetry's.
    Imports are lazy so ``obs`` never forms an import cycle with the store
    or the telemetry."""
    from ..store import serving_state
    from ..telemetry import get_telemetry

    state = serving_state()
    out = [("tunedb_serving_generation", "gauge", {},
            float(state.generation))]
    store = state.store
    if store is not None:
        for tier, n in (("exact", store.hits),
                        ("nearest", store.nearest_hits),
                        ("miss", store.misses)):
            out.append(("tunedb_store_lookups_total", "counter",
                        {"tier": tier}, float(n)))
        out.append(("tunedb_store_records", "gauge", {}, float(len(store))))
        out.append(("tunedb_store_version", "gauge", {},
                    float(store.version)))
    models = state.models
    if models is not None:
        for attr, result in (("hits", "hit"), ("misses", "miss"),
                             ("gated", "gated")):
            out.append(("tunedb_model_lookups_total", "counter",
                        {"result": result}, float(getattr(models, attr, 0))))
    plan = state.plan
    if plan is not None:
        ps = plan.stats()
        out.append(("tunedb_plan_source", "gauge",
                    {"source": str(ps["source"])}, 1.0))
        out.append(("tunedb_plan_lookups_total", "counter",
                    {"result": "hit"}, float(ps["hits"])))
        out.append(("tunedb_plan_lookups_total", "counter",
                    {"result": "miss"}, float(ps["misses"])))
        out.append(("tunedb_plan_entries", "gauge", {"origin": "built"},
                    float(ps["built"])))
        out.append(("tunedb_plan_entries", "gauge", {"origin": "promoted"},
                    float(ps["promoted"])))
        out.append(("tunedb_plan_generation", "gauge", {},
                    float(ps["generation"])))
        out.append(("tunedb_plan_store_version", "gauge", {},
                    float(plan.store_version)))
        for tier, n in ps["tiers"].items():
            out.append(("tunedb_plan_tier_entries", "gauge",
                        {"tier": str(tier)}, float(n)))
    ts = get_telemetry().stats()
    out.append(("tunedb_telemetry_epoch", "gauge", {}, float(ts["epoch"])))
    for space, ticks in ts["ticks"].items():
        out.append(("tunedb_telemetry_ticks_total", "counter",
                    {"space": space}, float(ticks)))
    for space, info in ts["spaces"].items():
        out.append(("tunedb_telemetry_calls_total", "counter",
                    {"space": space}, float(info["calls"])))
        out.append(("tunedb_telemetry_shapes", "gauge",
                    {"space": space}, float(info["shapes"])))
    return out


def _follower_collector():
    """Each live plan follower's (``tunedb.plans.PlanFollower``) state:
    its generation, how far it lags the registry (one ``CURRENT`` read a
    follower a scrape), its polls, installs and refusals."""
    from ..plans import active_followers

    out = []
    for f in active_followers():
        labels = {"follower": f.name}
        out.append(("tunedb_follower_generation", "gauge", labels,
                    float(f.generation)))
        out.append(("tunedb_follower_lag_generations", "gauge", labels,
                    float(f.lag_generations())))
        if f.lag_s is not None:
            out.append(("tunedb_follower_lag_seconds", "gauge", labels,
                        float(f.lag_s)))
        out.append(("tunedb_follower_polls_total", "counter", labels,
                    float(f.polls)))
        out.append(("tunedb_follower_installs_total", "counter", labels,
                    float(f.installs)))
        for reason, n in (("digest", f.refused_digest),
                          ("stale", f.refused_stale),
                          ("sentry", f.refused_sentry)):
            out.append(("tunedb_follower_refusals_total", "counter",
                        {**labels, "reason": reason}, float(n)))
    return out


_REGISTRY = MetricsRegistry()
_REGISTRY_LOCK = threading.Lock()


def _register_default_collectors(registry: MetricsRegistry) -> None:
    registry.register_collector(_serving_collector)
    registry.register_collector(_follower_collector)


_register_default_collectors(_REGISTRY)


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def reset_metrics() -> MetricsRegistry:
    """A fresh registry (tests, benchmarks), the default collectors
    registered on it again."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
        _register_default_collectors(_REGISTRY)
    return _REGISTRY
