"""Append-only tuning-record store, in the reference's JSONL format, and
the frozen dispatch plans compiled from it.

A port of ``repro.tunedb.store``: the same :class:`TuneRecord` lines
(sorted-key JSON with a CRC32 field), so a store written by either package
opens in the other.  The in-memory index is keyed by cheap shape tuples
instead of sha1 digests; lookups are exact per ``(backend, space, shape)``
or nearest by L2 distance over log2 input dims.  ``merge`` / ``export``
combine stores into one file, byte for byte as the reference writes it.

Records of source ``"sample"`` (a tuning session's measured losers and
``tunedb.model.collect_samples``' labellings, training data for the
performance models) are kept in the file but never indexed, so serving
never resolves them; :meth:`RecordStore.training_records` reads them back
for ``tunedb.model.harvest``.

:func:`install_serving` swaps the port's serving state (store, models,
fingerprint pin and a :class:`DispatchPlan`) in one generation; it touches
nothing of the reference's dispatcher.  The plan is the install-time
compilation of that state (:func:`compile_plan`): one flat ``(space,
shape) -> (config, tier)`` table that dispatch probes first.  Every plan
entry is a config the port's kernel can launch (``core.space.FITS``).
Every ``add`` that replaces the record behind a ``(backend, space,
shape)`` slot logs a :class:`Supersession` (a bounded deque, load-time
replays not logged): ``install_serving(sentry=)`` replays it to refuse a
generation that would serve a slower record (``tunedb.obs.sentry``).
The reference's quarantine, ``repair`` and fsck are not ported.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import math
import os
import pathlib
import threading
import time
import warnings
import zlib
from typing import (Callable, Deque, Dict, Iterator, List, Mapping,
                    Optional, Tuple)

from repro_torch.core.space import FITS

SCHEMA_VERSION = 1

# records of this source are model-training samples, never served
SAMPLE_SOURCE = "sample"

# input parameters that must match exactly for a nearest-shape neighbor
EXACT_MATCH_PARAMS = frozenset(
    {"dtype_bits", "trans_a", "trans_b", "causal", "R", "S"})

ShapeKey = Tuple[Tuple[str, int], ...]


def normalize_config(cfg: Mapping[str, object]) -> Dict[str, int]:
    return {str(k): int(v) for k, v in cfg.items()}


def normalize_inputs(inputs: Mapping[str, object]) -> Dict[str, int]:
    return {str(k): int(v) for k, v in inputs.items()}


def input_key(space: str, inputs: Mapping[str, object]) -> str:
    """Stable 16-hex key for a (space, inputs) pair (the reference's)."""
    blob = json.dumps(
        {"s": space, "i": dict(sorted(normalize_inputs(inputs).items()))},
        sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def shape_key(inputs: Mapping[str, int]) -> ShapeKey:
    """Hashable key for an input dict: its sorted items."""
    return tuple(sorted(inputs.items()))


def _crc(d: Mapping[str, object]) -> int:
    return zlib.crc32(json.dumps(d, sort_keys=True).encode("utf-8"))


@dataclasses.dataclass(frozen=True)
class TuneRecord:
    """One measured tuning outcome for one input shape (reference format)."""

    space: str
    inputs: Dict[str, int]
    config: Dict[str, int]
    tflops: float
    latency_us: Optional[float] = None
    backend: str = "unknown"
    source: str = "tuner"
    created_at: float = 0.0
    merged_from: Optional[str] = None
    schema_version: int = SCHEMA_VERSION

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["merged_from"] is None:
            del d["merged_from"]
        d["crc"] = _crc(d)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "TuneRecord":
        d = json.loads(line)
        if not isinstance(d, dict) or "space" not in d or "config" not in d:
            raise ValueError(f"not a TuneRecord: {line[:80]!r}")
        if int(d.get("schema_version", 1)) > SCHEMA_VERSION:
            raise ValueError(
                f"record schema v{d['schema_version']} > v{SCHEMA_VERSION}")
        crc = d.pop("crc", None)
        if crc is not None and int(crc) != _crc(d):
            raise ValueError(f"record CRC mismatch (line says {crc}, content "
                             f"recomputes {_crc(d)})")
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d["inputs"] = normalize_inputs(d.get("inputs", {}))
        d["config"] = normalize_config(d["config"])
        return cls(**d)


def _log2_dist(a: Mapping[str, int], b: Mapping[str, int]) -> Optional[float]:
    """L2 distance over log2(1+|dim|); None if the shapes are incomparable."""
    if set(a) != set(b):
        return None
    d = 0.0
    for k, va in a.items():
        vb = b[k]
        if k in EXACT_MATCH_PARAMS:
            if va != vb:
                return None
            continue
        d += (math.log2(1 + abs(va)) - math.log2(1 + abs(vb))) ** 2
    return math.sqrt(d)


SUPERSESSION_CAP = 4096     # bounded like the plan overlay and the memos


@dataclasses.dataclass(frozen=True)
class Supersession:
    """One serving-index replacement: at store ``version``, record ``new``
    took over the ``(backend, space, shape)`` slot from ``old``.  The
    regression sentry replays these to audit an in-place generation before
    an install freezes it into a plan."""

    version: int
    old: TuneRecord
    new: TuneRecord


_MEMO_MISS = object()


class RecordStore:
    """Append-only JSONL store of :class:`TuneRecord`, indexed in memory.

    ``path=None`` keeps the store in memory, with every record added (the
    training log).  Lines that do not parse (a torn tail, a CRC mismatch)
    are skipped and counted in ``n_skipped``.  ``fsync=False`` drops the
    per-append durability barrier: a fleet worker's shard store (whose
    jobs lease expiry requeues) is opened so, and the fleet's merge calls
    :meth:`sync` once a batch instead.
    """

    def __init__(self, path: Optional[os.PathLike] = None, *,
                 fsync: bool = True):
        self.path = pathlib.Path(path) if path is not None else None
        self.fsync = fsync
        self._lock = threading.Lock()
        # (backend, space, shape) -> latest record
        self._index: Dict[Tuple[str, str, ShapeKey], TuneRecord] = {}
        # (space, shape) -> latest record of any backend
        self._latest: Dict[Tuple[str, ShapeKey], TuneRecord] = {}
        self._nearest_memo: Dict[tuple, Optional[TuneRecord]] = {}
        # an in-memory store's training log: every record added, in order
        self._all: List[TuneRecord] = []
        # bumped on every add: an installed DispatchPlan stands aside while
        # the store is past the version it was compiled from
        self.version = 0
        self.n_lines = 0
        self.n_skipped = 0
        self.n_samples = 0
        # exact hits / misses (get) and served neighbours (nearest)
        self.hits = 0
        self.nearest_hits = 0
        self.misses = 0
        self._needs_newline = False
        # every add() that replaced a served record, newest last
        self.supersessions: Deque[Supersession] = collections.deque(
            maxlen=SUPERSESSION_CAP)
        if self.path is not None and self.path.exists():
            self._load()

    @classmethod
    def open(cls, path: os.PathLike) -> "RecordStore":
        return cls(path)

    def _parse(self) -> Iterator[Optional[TuneRecord]]:
        """The file's records in order; ``None`` for a line that does not
        parse (a torn tail, a CRC mismatch)."""
        with self.path.open("r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield TuneRecord.from_json(line)
                except (ValueError, TypeError, KeyError):
                    yield None

    def _load(self) -> None:
        for rec in self._parse():
            if rec is None:
                self.n_skipped += 1
                continue
            self.n_lines += 1
            self._admit(rec)
        with self.path.open("rb") as fh:
            fh.seek(0, os.SEEK_END)
            if fh.tell():
                fh.seek(-1, os.SEEK_END)
                self._needs_newline = fh.read(1) != b"\n"

    def _admit(self, rec: TuneRecord) -> Optional[TuneRecord]:
        """Index one record; returns the served record it replaced."""
        if rec.source == SAMPLE_SOURCE:
            self.n_samples += 1
            return None
        sk = shape_key(rec.inputs)
        bk = (rec.backend, rec.space, sk)
        replaced = None
        cur = self._index.get(bk)
        if cur is None or rec.created_at >= cur.created_at:
            self._index[bk] = rec
            replaced = cur
        lk = (rec.space, sk)
        cur = self._latest.get(lk)
        if cur is None or rec.created_at >= cur.created_at:
            self._latest[lk] = rec
        return replaced

    def add(self, rec: TuneRecord) -> TuneRecord:
        """Append one record (stamping created_at if unset)."""
        if rec.created_at <= 0:
            rec = dataclasses.replace(rec, created_at=time.time())
        rec = dataclasses.replace(rec, inputs=normalize_inputs(rec.inputs),
                                  config=normalize_config(rec.config))
        with self._lock:
            self._nearest_memo.clear()
            self.version += 1
            if self.path is not None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with self.path.open("a", encoding="utf-8") as fh:
                    if self._needs_newline:
                        fh.write("\n")
                        self._needs_newline = False
                    fh.write(rec.to_json() + "\n")
                    fh.flush()
                    if self.fsync:
                        os.fsync(fh.fileno())
                self.n_lines += 1
            else:
                self._all.append(rec)
            replaced = self._admit(rec)
            if replaced is not None:
                self.supersessions.append(Supersession(
                    version=self.version, old=replaced, new=rec))
        return rec

    def sync(self) -> None:
        """The durability barrier of an ``fsync=False`` store: flush what
        was appended to the disk now (the fleet's merge calls it once a
        pass, not once a record)."""
        if self.path is None or not self.path.exists():
            return
        with self.path.open("rb") as fh:
            os.fsync(fh.fileno())

    def _exact(self, space: str, sk: ShapeKey, backend: Optional[str]
               ) -> Optional[TuneRecord]:
        if backend is not None:
            return self._index.get((backend, space, sk))
        return self._latest.get((space, sk))

    def get(self, space: str, inputs: Mapping[str, int], *,
            backend: Optional[str] = None) -> Optional[TuneRecord]:
        """Latest record for exactly this (space, inputs[, backend]),
        counted as a hit or a miss."""
        rec = self._exact(space, shape_key(inputs), backend)
        if rec is not None:
            self.hits += 1
        else:
            self.misses += 1
        return rec

    def contains(self, space: str, inputs: Mapping[str, int], *,
                 backend: Optional[str] = None) -> bool:
        """Is there a served (non-sample) record for exactly this shape?
        Not counted: planning checks are not serving lookups."""
        return self._exact(space, shape_key(normalize_inputs(inputs)),
                           backend) is not None

    def __len__(self) -> int:
        return len(self._index)

    def records(self, *, backend: Optional[str] = None) -> List[TuneRecord]:
        """The latest served record per (backend, space, shape), most
        recent first (the reference's order)."""
        with self._lock:
            recs = [r for (b, _, _), r in self._index.items()
                    if backend is None or b == backend]
        return sorted(recs, key=lambda r: -r.created_at)

    def neighbors(self, space: str, inputs: Mapping[str, int]
                  ) -> List[TuneRecord]:
        """Every served record comparable to ``inputs``: the same space,
        the same input names and the same exact-match values (dtype,
        layout flags), in index order: the candidates store-aware
        admission scans."""
        inputs = normalize_inputs(inputs)
        exact = {k: v for k, v in inputs.items() if k in EXACT_MATCH_PARAMS}
        with self._lock:
            recs = list(self._index.values())
        return [r for r in recs if r.space == space
                and set(r.inputs) == set(inputs)
                and all(r.inputs[k] == v for k, v in exact.items())]

    def training_records(self, *, space: Optional[str] = None,
                         backend: Optional[str] = None) -> List[TuneRecord]:
        """The whole measurement log in file order, superseded re-tunes
        and ``sample`` records included: what ``tunedb.model.harvest``
        trains on.  A disk-backed store parses its file again (a serving
        process does not hold the sample log), skipping lines that do not
        parse."""
        def keep(r: TuneRecord) -> bool:
            return ((space is None or r.space == space)
                    and (backend is None or r.backend == backend))

        if self.path is None:
            with self._lock:
                return [r for r in self._all if keep(r)]
        if not self.path.exists():
            return []
        return [r for r in self._parse() if r is not None and keep(r)]

    def backends(self) -> List[str]:
        """The backend fingerprints that have served records."""
        with self._lock:
            return sorted({b for b, _, _ in self._index})

    def invalidate_memos(self) -> None:
        """Drop the nearest-lookup memo (a serving-state install calls
        this)."""
        with self._lock:
            self._nearest_memo.clear()

    def nearest(self, space: str, inputs: Mapping[str, int], *,
                backend: Optional[str] = None,
                max_distance: float = 2.0,
                legal: Optional[Callable[[Mapping[str, int],
                                          Mapping[str, int]], bool]] = None,
                count: bool = True) -> Optional[TuneRecord]:
        """Exact record if present, else the closest tuned shape within
        ``max_distance`` (L2 over log2 numeric dims; dtype and layout flags
        must match exactly).

        ``legal(config, inputs)``, when given, passes over records whose
        config it rejects — the exact one included — so a config the
        kernel cannot launch never stands in for a neighbor that it can.
        An exact record counts as a hit and a neighbour as a nearest hit
        (``count=False``: a planning probe, not counted).
        """
        inputs = normalize_inputs(inputs)
        sk = shape_key(inputs)
        exact = self._exact(space, sk, backend)
        if exact is not None and (legal is None
                                  or legal(exact.config, inputs)):
            if count:
                self.hits += 1
            return exact
        memo_key = (space, backend, sk, max_distance, legal)
        best = self._nearest_memo.get(memo_key, _MEMO_MISS)
        if best is _MEMO_MISS:
            best, best_d = None, max_distance
            with self._lock:
                candidates = list(self._index.values())
            for rec in candidates:
                if rec.space != space or (backend is not None
                                          and rec.backend != backend):
                    continue
                if rec is exact or (legal is not None
                                    and not legal(rec.config, inputs)):
                    continue
                d = _log2_dist(inputs, rec.inputs)
                if d is not None and d <= best_d and (
                        best is None or d < best_d):
                    best, best_d = rec, d
            self._nearest_memo[memo_key] = best
        if best is not None and count:
            self.nearest_hits += 1
        return best

    # -- merge / export / stats ----------------------------------------------
    def merge(self, other: "RecordStore", *,
              lineage: Optional[str] = None) -> int:
        """Append every latest served record of ``other`` that is not
        already newer here, tagged ``merged_from=lineage`` (default: the
        other store's path); the records' ``source`` stays.  Returns the
        records appended."""
        if lineage is None:
            lineage = str(other.path) if other.path is not None else "memory"
        n = 0
        for rec in other.records():
            cur = self._index.get((rec.backend, rec.space,
                                   shape_key(rec.inputs)))
            if cur is None or rec.created_at > cur.created_at:
                self.add(dataclasses.replace(rec, merged_from=lineage))
                n += 1
        return n

    def export(self, path: os.PathLike) -> int:
        """Write a compacted store (the latest served record per key, in
        chronological order) atomically; returns the records written."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        recs = self.records()
        tmp = path.with_name(path.name + ".tmp")
        with tmp.open("w", encoding="utf-8") as fh:
            fh.write("".join(rec.to_json() + "\n" for rec in reversed(recs)))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return len(recs)

    def stats(self) -> Dict[str, object]:
        per_space: Dict[str, int] = {}
        per_backend: Dict[str, int] = {}
        for rec in self.records():
            per_space[rec.space] = per_space.get(rec.space, 0) + 1
            per_backend[rec.backend] = per_backend.get(rec.backend, 0) + 1
        return {
            "path": str(self.path) if self.path else None,
            "schema_version": SCHEMA_VERSION,
            "shapes": len(self._latest),
            "records": len(self._index),
            "lines": self.n_lines,
            "skipped_lines": self.n_skipped,
            "sample_records": self.n_samples,
            "per_space": per_space,
            "per_backend": per_backend,
            "lookups": {"hits": self.hits, "nearest": self.nearest_hits,
                        "misses": self.misses},
        }


# ---------------------------------------------------------------------------
# Frozen dispatch plans: the install-time compilation of a serving
# generation (the reference's DispatchPlan / compile_plan).  The store, the
# model set and the telemetry's hot set compile into one flat
# (space, shape_key) -> (config, tier) table, so a steady-state resolution
# is one dict probe with no store or model traffic.
# ---------------------------------------------------------------------------

PLAN_HOT_K = 32         # telemetry hot shapes pre-resolved per space


def launchable(space: str, cfg: Mapping[str, int],
               inputs: Mapping[str, int]) -> bool:
    """Can the port's kernel of ``space`` launch ``cfg`` at ``inputs``
    (``core.space.FITS``)?  The one legality rule: dispatch's slow path
    and every plan entry (compiled, promoted or loaded) obey it."""
    legal = FITS.get(space)
    return legal is None or bool(legal(cfg, inputs))


class DispatchPlan:
    """One generation's frozen shape -> config table.

    The base ``_table`` is built once and never mutated; the ``_overlay``
    takes slow-path promotions (entries are only added within a
    generation), so a lock-free reader sees a miss or a whole entry.
    ``store_version`` pins the plan to the store state it was compiled
    from: once the store gains a record, dispatch stands the plan aside
    until the next install recompiles.  Each entry keeps the tier that
    produced it (``exact`` | ``model`` | ``nearest``).  A promotion whose
    config the kernel cannot launch is refused.
    """

    __slots__ = ("generation", "fingerprint", "store_version", "hits",
                 "misses", "source", "digest", "compile_ms", "_table",
                 "_overlay", "_lock")

    OVERLAY_CAP = 4096          # runaway-shape backstop, like the memos

    def __init__(self, *, generation: int, fingerprint: Optional[str],
                 store_version: int,
                 table: Dict[tuple, Tuple[Dict[str, int], str]],
                 source: str = "compiled", digest: Optional[str] = None):
        self.generation = generation
        self.fingerprint = fingerprint
        self.store_version = store_version
        self.hits = 0
        self.misses = 0
        self.source = source        # "compiled" (install-time) | "loaded"
        self.digest = digest        # artifact sha256, when source=="loaded"
        self.compile_ms: Optional[float] = None
        self._table = table
        self._overlay: Dict[tuple, Tuple[Dict[str, int], str]] = {}
        self._lock = threading.Lock()

    def lookup(self, space: str, key: tuple
               ) -> Optional[Tuple[Dict[str, int], str]]:
        """(config, tier) for a planned shape, else None.  Lock-free."""
        entry = self._table.get((space, key))
        if entry is None:
            entry = self._overlay.get((space, key))
        return entry

    def promote(self, space: str, key: tuple, cfg: Mapping[str, int],
                tier: str) -> None:
        """Freeze a slow-path resolution so later calls are plan hits."""
        if not launchable(space, cfg, dict(key)):
            return
        with self._lock:
            if len(self._overlay) < self.OVERLAY_CAP:
                self._overlay[(space, key)] = (dict(cfg), tier)

    def drop_unlaunchable(self) -> List[Tuple[str, tuple]]:
        """Remove base entries the kernel cannot launch (an artifact written
        for another chip); returns their (space, key)s."""
        bad = [k for k, (cfg, _) in self._table.items()
               if not launchable(k[0], cfg, dict(k[1]))]
        for k in bad:
            del self._table[k]
        return bad

    def __len__(self) -> int:
        return len(self._table) + len(self._overlay)

    def stats(self) -> Dict[str, object]:
        tiers: Dict[str, int] = {}
        for _, tier in list(self._table.values()):
            tiers[tier] = tiers.get(tier, 0) + 1
        return {"generation": self.generation, "entries": len(self),
                "built": len(self._table), "promoted": len(self._overlay),
                "hits": self.hits, "misses": self.misses, "tiers": tiers,
                "source": self.source, "digest": self.digest,
                "compile_ms": self.compile_ms}


def compile_plan(store: Optional[RecordStore], models, fingerprint:
                 Optional[str], *, telemetry=None, hot_k: int = PLAN_HOT_K,
                 generation: int = 0) -> Optional[DispatchPlan]:
    """Compile a serving generation into a frozen :class:`DispatchPlan`.

    Every served record under ``fingerprint`` (all backends' newest when
    None) becomes an ``exact`` entry, then the telemetry's top ``hot_k``
    shapes per space are pre-resolved as dispatch's slow path would:
    model, then nearest.  Only configs the kernel can launch enter the
    table: a record or a pick it cannot launch is passed over as the slow
    path passes over it, and a shape no tier resolves stays out (the slow
    path keeps its warn-once degradation).  The install-time ``predict``
    calls count in the model set's statistics, as in the reference.
    """
    if store is None and models is None:
        return None
    t0 = time.perf_counter()
    table: Dict[tuple, Tuple[Dict[str, int], str]] = {}
    store_version = -1
    if store is not None:
        store_version = store.version
        with store._lock:
            if fingerprint is None:
                recs = list(store._latest.values())
            else:
                recs = [r for (b, _, _), r in store._index.items()
                        if b == fingerprint]
        for rec in recs:
            if launchable(rec.space, rec.config, rec.inputs):
                table[(rec.space, shape_key(rec.inputs))] = (
                    dict(rec.config), "exact")
    if telemetry is not None and hot_k > 0:
        predict = (getattr(models, "predict", None) if models is not None
                   else None)
        for space in telemetry.spaces():
            legal = functools.partial(launchable, space)
            for inputs, _count in telemetry.hot_shapes(space, hot_k):
                key = (space, shape_key(inputs))
                if key in table:
                    continue
                cfg, tier = None, ""
                if callable(predict):
                    got = predict(space, inputs, backend=fingerprint)
                    if got is not None and legal(got[0], inputs):
                        cfg, tier = got[0], "model"
                if cfg is None and store is not None:
                    rec = store.nearest(space, inputs, backend=fingerprint,
                                        legal=legal, count=False)
                    if rec is not None:
                        cfg, tier = rec.config, "nearest"
                if cfg is not None:
                    table[key] = (dict(cfg), tier)
    plan = DispatchPlan(generation=generation, fingerprint=fingerprint,
                        store_version=store_version, table=table)
    plan.compile_ms = (time.perf_counter() - t0) * 1e3
    return plan


@dataclasses.dataclass(frozen=True)
class ServingState:
    """What dispatch reads, swapped as one object: the store, the
    performance models (``tunedb.model.ModelSet``), the backend fingerprint
    lookups are pinned to (None = any), a generation number that every
    install bumps (dispatch keys its warn-once latches on it, the engine
    re-captures its decode graph on it) and the generation's frozen
    dispatch plan."""

    store: Optional[RecordStore] = None
    models: Optional[object] = None
    fingerprint: Optional[str] = None
    generation: int = 0
    plan: Optional[DispatchPlan] = None


_STATE = ServingState()
_STATE_LOCK = threading.Lock()
_KEEP = object()          # sentinel: leave this field as installed


def serving_state() -> ServingState:
    return _STATE


def install_serving(*, store: object = _KEEP, models: object = _KEEP,
                    fingerprint: object = _KEEP, build_plan: bool = True,
                    plan_hot_k: int = PLAN_HOT_K, sentry: object = None,
                    plan: Optional[DispatchPlan] = None,
                    plan_dir: Optional[os.PathLike] = None) -> ServingState:
    """Swap any subset of the port's serving state in one generation.

    Fields left at the default keep their installed value; the generation
    bumps either way, and the incoming store's and models' memos are
    dropped before anything is compiled, so no resolution of the old
    generation leaks into the new one.

    Unless ``build_plan=False`` the install compiles the incoming store,
    models and the telemetry's hot set into the generation's
    :class:`DispatchPlan` (:func:`compile_plan`).

    ``sentry`` (a :class:`~repro_torch.tunedb.obs.sentry.RegressionSentry`,
    or anything with ``blocks_install(cur_state, new_store)``) gates the
    swap before anything is compiled: when the incoming store would serve
    a record slower than the one it replaces beyond the sentry's margin,
    the install warns and returns the current state unchanged (the caller
    sees the generation it had).  ``plan`` (or
    ``plan_dir``, an artifact directory: ``tunedb.plans``) installs a
    pre-built plan instead; a bad artifact raises
    :class:`~repro_torch.tunedb.plans.PlanArtifactError`.  Such a plan is
    re-pinned to the live store's version (the artifact's counts another
    process's appends), adopts its own fingerprint where none is pinned,
    and loses, with one warning, any entry the kernel cannot launch.  Each
    install counts in the metrics registry's ``tunedb_installs_total
    {planned}`` and sets ``tunedb_plan_built_entries`` to its plan's
    compiled entries.
    """
    global _STATE
    if plan_dir is not None and plan is None:
        from .plans import load_plan
        plan = load_plan(plan_dir)
    preplan = plan
    dropped: List[Tuple[str, tuple]] = []
    if preplan is not None:
        dropped = preplan.drop_unlaunchable()
    while True:
        cur = _STATE
        new_store = cur.store if store is _KEEP else store
        new_models = cur.models if models is _KEEP else models
        new_fp = cur.fingerprint if fingerprint is _KEEP else fingerprint
        if fingerprint is _KEEP and new_fp is None and preplan is not None:
            new_fp = preplan.fingerprint
        if sentry is not None and sentry.blocks_install(cur, new_store):
            return cur              # refused: the generation stays live
        for obj in (new_store, new_models):
            invalidate = getattr(obj, "invalidate_memos", None)
            if callable(invalidate):
                invalidate()
        plan = preplan
        if plan is not None:
            plan.store_version = (new_store.version
                                  if new_store is not None else -1)
        elif build_plan:
            from .telemetry import get_telemetry
            plan = compile_plan(new_store, new_models, new_fp,
                                telemetry=get_telemetry(), hot_k=plan_hot_k)
        with _STATE_LOCK:
            if _STATE is not cur:
                continue            # another install landed: compile again
            generation = cur.generation + 1
            if plan is not None:
                plan.generation = generation
            new = ServingState(store=new_store, models=new_models,
                               fingerprint=new_fp, generation=generation,
                               plan=plan)
            _STATE = new
        break
    if dropped:
        space, key = dropped[0]
        warnings.warn(
            f"tunedb plan: {len(dropped)} plan entries cannot launch on "
            f"sm_90a and are passed over (first: {space} {dict(key)}); "
            "dispatch resolves those shapes on the slow path",
            RuntimeWarning, stacklevel=2)
    from .obs.metrics import get_registry   # obs reads the store: lazy
    reg = get_registry()
    reg.counter("tunedb_installs_total",
                "serving-state swaps (new generations)").inc(
                    planned="yes" if plan is not None else "no")
    if plan is not None:
        reg.gauge("tunedb_plan_built_entries",
                  "entries compiled into the current plan").set(
                      len(plan._table))
    return new


def install_store(store: Optional[RecordStore], *,
                  fingerprint: Optional[str] = None) -> ServingState:
    """Make ``store`` the port's dispatch store (``None`` uninstalls),
    pinned to ``fingerprint``; the installed models stay."""
    return install_serving(store=store, fingerprint=fingerprint)


def clear_store() -> None:
    install_store(None)
