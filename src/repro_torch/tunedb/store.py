"""Append-only tuning-record store, in the reference's JSONL format.

A port of the serving subset of ``repro.tunedb.store``: the same
:class:`TuneRecord` lines (sorted-key JSON with a CRC32 field), so a store
written by either package opens in the other.  The in-memory index is keyed
by cheap shape tuples instead of sha1 digests; lookups are exact per
``(backend, space, shape)`` or nearest by L2 distance over log2 input dims.

The port's serving state (:func:`install_store` / :func:`serving_state`)
is its own: installing a store here touches nothing of the reference's
dispatcher.  Quarantine/fsck, merge/export and dispatch plans are not
ported yet.  Records of source ``"sample"`` (a tuning session's measured
losers and ``tunedb.model.collect_samples``' labellings, training data for
the performance models) are kept in the file but never indexed, so serving
never resolves them; :meth:`RecordStore.training_records` reads them back
for ``tunedb.model.harvest``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pathlib
import threading
import time
import zlib
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

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


_MEMO_MISS = object()


class RecordStore:
    """Append-only JSONL store of :class:`TuneRecord`, indexed in memory.

    ``path=None`` keeps the store in memory, with every record added (the
    training log).  Lines that do not parse (a torn tail, a CRC mismatch)
    are skipped and counted in ``n_skipped``.
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self._lock = threading.Lock()
        # (backend, space, shape) -> latest record
        self._index: Dict[Tuple[str, str, ShapeKey], TuneRecord] = {}
        # (space, shape) -> latest record of any backend
        self._latest: Dict[Tuple[str, ShapeKey], TuneRecord] = {}
        self._nearest_memo: Dict[tuple, Optional[TuneRecord]] = {}
        # an in-memory store's training log: every record added, in order
        self._all: List[TuneRecord] = []
        self.n_lines = 0
        self.n_skipped = 0
        self._needs_newline = False
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

    def _admit(self, rec: TuneRecord) -> None:
        if rec.source == SAMPLE_SOURCE:
            return
        sk = shape_key(rec.inputs)
        bk = (rec.backend, rec.space, sk)
        cur = self._index.get(bk)
        if cur is None or rec.created_at >= cur.created_at:
            self._index[bk] = rec
        lk = (rec.space, sk)
        cur = self._latest.get(lk)
        if cur is None or rec.created_at >= cur.created_at:
            self._latest[lk] = rec

    def add(self, rec: TuneRecord) -> TuneRecord:
        """Append one record (stamping created_at if unset)."""
        if rec.created_at <= 0:
            rec = dataclasses.replace(rec, created_at=time.time())
        rec = dataclasses.replace(rec, inputs=normalize_inputs(rec.inputs),
                                  config=normalize_config(rec.config))
        with self._lock:
            self._nearest_memo.clear()
            if self.path is not None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with self.path.open("a", encoding="utf-8") as fh:
                    if self._needs_newline:
                        fh.write("\n")
                        self._needs_newline = False
                    fh.write(rec.to_json() + "\n")
                    fh.flush()
                    os.fsync(fh.fileno())
                self.n_lines += 1
            else:
                self._all.append(rec)
            self._admit(rec)
        return rec

    def _exact(self, space: str, sk: ShapeKey, backend: Optional[str]
               ) -> Optional[TuneRecord]:
        if backend is not None:
            return self._index.get((backend, space, sk))
        return self._latest.get((space, sk))

    def get(self, space: str, inputs: Mapping[str, int], *,
            backend: Optional[str] = None) -> Optional[TuneRecord]:
        """Latest record for exactly this (space, inputs[, backend])."""
        return self._exact(space, shape_key(inputs), backend)

    def contains(self, space: str, inputs: Mapping[str, int], *,
                 backend: Optional[str] = None) -> bool:
        """Is there a served (non-sample) record for exactly this shape?"""
        return self.get(space, normalize_inputs(inputs),
                        backend=backend) is not None

    def records(self) -> list:
        """The latest served record per (backend, space, shape)."""
        with self._lock:
            return list(self._index.values())

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
                                          Mapping[str, int]], bool]] = None
                ) -> Optional[TuneRecord]:
        """Exact record if present, else the closest tuned shape within
        ``max_distance`` (L2 over log2 numeric dims; dtype and layout flags
        must match exactly).

        ``legal(config, inputs)``, when given, passes over records whose
        config it rejects — the exact one included — so a config the
        kernel cannot launch never stands in for a neighbor that it can.
        """
        inputs = normalize_inputs(inputs)
        sk = shape_key(inputs)
        exact = self._exact(space, sk, backend)
        if exact is not None and (legal is None
                                  or legal(exact.config, inputs)):
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
        return best


@dataclasses.dataclass(frozen=True)
class ServingState:
    """What dispatch reads, swapped as one object: the store, the
    performance models (``tunedb.model.ModelSet``), the backend fingerprint
    lookups are pinned to (None = any), and a generation number that every
    install bumps (dispatch keys its warn-once latches on it, the engine
    re-captures its decode graph on it)."""

    store: Optional[RecordStore] = None
    models: Optional[object] = None
    fingerprint: Optional[str] = None
    generation: int = 0


_STATE = ServingState()
_STATE_LOCK = threading.Lock()
_KEEP = object()          # sentinel: leave this field as installed


def serving_state() -> ServingState:
    return _STATE


def install_serving(*, store: object = _KEEP, models: object = _KEEP,
                    fingerprint: object = _KEEP) -> ServingState:
    """Swap any subset of the port's serving state in one step.  Fields
    left at the default keep their installed value; the generation bumps
    either way, and the incoming store's and models' memos are dropped so
    no resolution of the old generation leaks into the new one."""
    global _STATE
    with _STATE_LOCK:
        cur = _STATE
        new = ServingState(
            store=cur.store if store is _KEEP else store,
            models=cur.models if models is _KEEP else models,
            fingerprint=cur.fingerprint if fingerprint is _KEEP
            else fingerprint,
            generation=cur.generation + 1)
        for obj in (new.store, new.models):
            invalidate = getattr(obj, "invalidate_memos", None)
            if callable(invalidate):
                invalidate()
        _STATE = new
        return new


def install_store(store: Optional[RecordStore], *,
                  fingerprint: Optional[str] = None) -> ServingState:
    """Make ``store`` the port's dispatch store (``None`` uninstalls),
    pinned to ``fingerprint``; the installed models stay."""
    return install_serving(store=store, fingerprint=fingerprint)


def clear_store() -> None:
    install_store(None)
