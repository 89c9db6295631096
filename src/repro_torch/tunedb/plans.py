"""Golden dispatch-plan artifacts: a generation's frozen plan on disk.

A port of the artifact layer of ``repro.tunedb.plans``.  One generation's
:class:`~repro_torch.tunedb.store.DispatchPlan` is written to a directory::

    <store>.plan/<generation>/
        manifest.json     # schema version, generation, fingerprint,
                          # store_version, digest, n_entries, provenance
        entries.jsonl     # one canonical JSON line per (space, shape) entry

The entries blob is byte-deterministic (sorted entries, sorted keys) and
the manifest pins its SHA-256 ``digest``.  :func:`load_plan` refuses a
manifest from a newer schema, a torn file, a digest mismatch or an entry
count that disagrees (:class:`PlanArtifactError`): a plan is verified
whole or not served.  The format is the reference's, so an artifact
exported by either package loads in the other.
``install_serving(plan_dir=...)`` serves from an artifact without
compiling a plan (no model scans at install), and drops any entry the
port's kernel cannot launch.

:func:`export_plan` refuses a stale plan (:class:`StalePlanError`): once
the store has gained records since the compile, the plan no longer
reflects it.  The artifact directory appears whole or not at all (written
under a temporary name, then renamed).

**Registry** (:class:`PlanRegistry`): the fleet's filesystem bus reused
for distribution::

    <registry>/
        generations/<generation>/   # immutable plan artifacts (as above)
        CURRENT.json                # the pointer: {generation, fingerprint,
                                    # digest, path, published_at, ...}

``publish`` writes the artifact (a temporary directory renamed into
``generations/``; a racing publisher takes the next number), then
replaces ``CURRENT.json`` atomically, so a reader sees the previous whole
generation or the new whole one.

**Follower** (:class:`PlanFollower`): the replica side.  A daemon thread
polls ``CURRENT.json``; when the generation advances it pulls the
artifact, verifies its digest against the pointer, optionally diffs its
coverage against the plan it serves through a
:class:`~repro_torch.tunedb.obs.sentry.RegressionSentry`, and installs it
through ``install_serving(plan=...)``.  A torn artifact, a rolled-back
pointer or a coverage loss beyond the margin is counted and refused; the
replica keeps serving what it had.  An install reads host state only (no
copy from the card, no synchronise), so it may land while the engine
captures a graph; the engine captures that graph again at its next use.

Every artifact, pointer and manifest read or write goes through the
fault-injection shim when it is armed (``tunedb.chaos``: ``plan.export.*``,
``plan.pull.*``, ``plan.registry.*``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import threading
import time
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from . import chaos
from .obs import trace as _trace
from .obs.metrics import get_registry
from .store import (_KEEP, DispatchPlan, RecordStore, install_serving,
                    normalize_config, normalize_inputs, serving_state,
                    shape_key)

PLAN_SCHEMA_VERSION = 1

MANIFEST_NAME = "manifest.json"
ENTRIES_NAME = "entries.jsonl"
CURRENT_NAME = "CURRENT.json"
GENERATIONS = "generations"


class PlanArtifactError(RuntimeError):
    """A persisted plan cannot be loaded safely (schema from the future,
    torn manifest or entries, digest mismatch, entry count drift)."""


class StalePlanError(PlanArtifactError):
    """The plan's compiled ``store_version`` is behind the live store:
    exporting it would publish a table that shadows newer records.
    Recompile (``install_serving`` / ``compile_plan``) and export that."""


def default_plan_dir(store_path: os.PathLike) -> pathlib.Path:
    """Where a store's plan artifacts live: ``<store>.plan/`` beside it."""
    p = pathlib.Path(store_path)
    return p.with_name(p.name + ".plan")


def plan_entries(plan: DispatchPlan) -> List[Dict[str, object]]:
    """The plan's whole table (base and overlay) as sorted plain-JSON
    entries; an overlay promotion is exported like a built entry (its
    ``origin`` says which it was) and loads into the base table."""
    out: List[Dict[str, object]] = []
    for origin, table in (("built", plan._table), ("promoted", plan._overlay)):
        for (space, key), (config, tier) in list(table.items()):
            out.append({
                "space": space,
                "inputs": {k: int(v) for k, v in key},
                "config": {k: int(v) for k, v in config.items()},
                "tier": tier,
                "origin": origin,
            })
    out.sort(key=lambda e: (e["space"], sorted(e["inputs"].items())))
    return out


def entries_blob(entries: List[Dict[str, object]]) -> bytes:
    """Canonical JSONL bytes for a list of plan entries."""
    return "".join(json.dumps(e, sort_keys=True) + "\n"
                   for e in entries).encode("utf-8")


def plan_digest(blob: bytes) -> str:
    return "sha256:" + hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass(frozen=True)
class PlanManifest:
    """The verified identity of one exported plan artifact."""

    generation: int
    fingerprint: Optional[str]
    store_version: int
    digest: str
    n_entries: int
    created_at: float
    store_path: Optional[str] = None
    store_records: int = 0
    store_max_created_at: float = 0.0
    plan_schema_version: int = PLAN_SCHEMA_VERSION

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "PlanManifest":
        if not isinstance(d, Mapping) or "digest" not in d \
                or "generation" not in d:
            raise PlanArtifactError(f"not a plan manifest: {d!r:.120}")
        version = int(d.get("plan_schema_version", -1))
        if version > PLAN_SCHEMA_VERSION:
            raise PlanArtifactError(
                f"plan schema v{version} > v{PLAN_SCHEMA_VERSION} "
                "(refusing to misread a newer writer's artifact)")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _write_artifact(plan: DispatchPlan, dest: pathlib.Path, *,
                    generation: int,
                    store: Optional[RecordStore]) -> PlanManifest:
    """Write ``dest/`` (manifest and entries) through a temporary
    directory and one rename; ``dest`` must not exist yet
    (:exc:`FileExistsError` otherwise)."""
    if store is not None and plan.store_version >= 0 \
            and store.version > plan.store_version:
        raise StalePlanError(
            f"plan was compiled at store version {plan.store_version} but "
            f"the store has advanced to {store.version}: "
            f"{store.version - plan.store_version} record(s) appended since "
            "the compile would be silently shadowed; recompile "
            "(install_serving) before exporting")
    entries = plan_entries(plan)
    blob = entries_blob(entries)
    meta: Dict[str, object] = {}
    if store is not None:
        recs = store.records()
        meta = {
            "store_path": str(store.path) if store.path else None,
            "store_records": len(recs),
            "store_max_created_at": max(
                (r.created_at for r in recs), default=0.0),
        }
    manifest = PlanManifest(
        generation=int(generation),
        fingerprint=plan.fingerprint,
        store_version=plan.store_version,
        digest=plan_digest(blob),
        n_entries=len(entries),
        created_at=time.time(),
        **meta)
    dest = pathlib.Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.parent / f".tmp-{dest.name}-{os.getpid()}-{id(plan) & 0xffff}"
    tmp.mkdir(parents=True, exist_ok=True)
    io = chaos._IO
    try:
        if io is None:
            (tmp / ENTRIES_NAME).write_bytes(blob)
            (tmp / MANIFEST_NAME).write_text(
                json.dumps(manifest.to_dict(), sort_keys=True),
                encoding="utf-8")
            os.rename(tmp, dest)        # the whole artifact or nothing
        else:
            io.write_bytes(tmp / ENTRIES_NAME, blob, "plan.export.entries")
            io.write_text(tmp / MANIFEST_NAME,
                          json.dumps(manifest.to_dict(), sort_keys=True),
                          "plan.export.manifest")
            io.rename(tmp, dest, "plan.export.rename")
    except BaseException:
        for p in (tmp / ENTRIES_NAME, tmp / MANIFEST_NAME):
            p.unlink(missing_ok=True)
        if tmp.exists():
            tmp.rmdir()
        raise
    return manifest


def _generation_name(generation: int) -> str:
    return f"{int(generation):08d}"


def _next_generation(root: pathlib.Path) -> int:
    """One past the highest numeric artifact directory under ``root``."""
    latest = 0
    if root.is_dir():
        for p in root.iterdir():
            try:
                latest = max(latest, int(p.name))
            except ValueError:
                continue                # temporary dirs, foreign files
    return latest + 1


def export_plan(plan: DispatchPlan, out_dir: os.PathLike, *,
                store: Optional[RecordStore] = None,
                generation: Optional[int] = None) -> pathlib.Path:
    """Export ``plan`` to ``out_dir/<generation>/`` and return that path.

    ``generation`` defaults to one past the highest already exported
    there.  ``store`` arms the staleness gate (:class:`StalePlanError`)
    and records provenance in the manifest.
    """
    root = pathlib.Path(out_dir)
    gen = generation if generation is not None else _next_generation(root)
    while True:
        dest = root / _generation_name(gen)
        try:
            _write_artifact(plan, dest, generation=gen, store=store)
            return dest
        except FileExistsError:
            if generation is not None:
                raise
            gen += 1                    # another exporter took the slot


def read_manifest(plan_dir: os.PathLike) -> PlanManifest:
    """Parse and schema-gate a plan directory's manifest."""
    path = pathlib.Path(plan_dir) / MANIFEST_NAME
    io = chaos._IO
    try:
        text = (path.read_text(encoding="utf-8") if io is None
                else io.read_text(path, "plan.pull.manifest"))
        doc = json.loads(text)
    except FileNotFoundError:
        raise PlanArtifactError(f"{path}: not a plan artifact (no manifest)")
    except (OSError, ValueError) as e:
        raise PlanArtifactError(f"{path}: torn or unreadable manifest ({e})")
    return PlanManifest.from_dict(doc)


def load_plan(plan_dir: os.PathLike) -> DispatchPlan:
    """Load and verify a plan artifact into a :class:`DispatchPlan`
    (``source="loaded"``, ``digest`` the verified digest).  The entries
    blob is checked against the manifest's digest before any entry is
    parsed; any failure raises :class:`PlanArtifactError`."""
    plan_dir = pathlib.Path(plan_dir)
    manifest = read_manifest(plan_dir)
    entries_path = plan_dir / ENTRIES_NAME
    io = chaos._IO
    try:
        blob = (entries_path.read_bytes() if io is None
                else io.read_bytes(entries_path, "plan.pull.entries"))
    except OSError as e:
        raise PlanArtifactError(f"{entries_path}: unreadable entries ({e})")
    digest = plan_digest(blob)
    if digest != manifest.digest:
        raise PlanArtifactError(
            f"{plan_dir}: digest mismatch (manifest {manifest.digest}, "
            f"entries {digest}) — torn or tampered artifact, refusing to "
            "serve it")
    table: Dict[tuple, Tuple[Dict[str, int], str]] = {}
    for i, line in enumerate(blob.decode("utf-8").splitlines()):
        if not line.strip():
            continue
        try:
            e = json.loads(line)
            key = (str(e["space"]), shape_key(normalize_inputs(e["inputs"])))
            table[key] = (normalize_config(e["config"]),
                          str(e.get("tier", "exact")))
        except (ValueError, TypeError, KeyError) as exc:
            raise PlanArtifactError(
                f"{entries_path}:{i + 1}: bad plan entry ({exc})")
    if len(table) != manifest.n_entries:
        raise PlanArtifactError(
            f"{plan_dir}: {len(table)} entries parsed but manifest "
            f"promises {manifest.n_entries}")
    return DispatchPlan(
        generation=manifest.generation, fingerprint=manifest.fingerprint,
        store_version=manifest.store_version, table=table,
        source="loaded", digest=manifest.digest)


def check_freshness(manifest: PlanManifest,
                    store: Optional[RecordStore]) -> Optional[str]:
    """A warning when the store holds served records stamped after the
    artifact's export (the cross-process signal: a freshly opened store's
    ``version`` is 0), else None.  Advisory: the caller decides."""
    if store is None or manifest.store_max_created_at <= 0:
        return None
    newest = max((r.created_at for r in store.records()), default=0.0)
    if newest > manifest.store_max_created_at + 1e-6:
        return (f"store has records newer ({newest:.0f}) than the plan "
                f"artifact ({manifest.store_max_created_at:.0f}); the "
                "loaded plan may shadow fresher tuning — consider "
                "re-exporting")
    return None


# ---------------------------------------------------------------------------
# registry: publish and follow over a shared directory
# ---------------------------------------------------------------------------

def _atomic_write(path: pathlib.Path, text: str, *,
                  site: str = "plan.registry.write") -> None:
    io = chaos._IO
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
    if io is None:
        tmp.write_text(text, encoding="utf-8")
        os.replace(tmp, path)
    else:
        io.write_text(tmp, text, site)
        io.replace(tmp, path, site + ".replace")


class PlanRegistry:
    """One coordinator publishes plan generations; replicas follow.

    ``CURRENT.json`` is the only mutable file, replaced atomically, and it
    points at a complete artifact under ``generations/``.
    """

    def __init__(self, root: os.PathLike):
        self.root = pathlib.Path(root)
        self.generations_dir = self.root / GENERATIONS

    def init(self) -> "PlanRegistry":
        self.generations_dir.mkdir(parents=True, exist_ok=True)
        return self

    def generation_dir(self, generation: int) -> pathlib.Path:
        return self.generations_dir / _generation_name(generation)

    def publish(self, plan: DispatchPlan, *,
                store: Optional[RecordStore] = None) -> PlanManifest:
        """Export ``plan`` as the next generation, then point ``CURRENT``
        at it: a follower that reads the new pointer always finds the
        whole artifact behind it.  A stale plan is refused
        (:class:`StalePlanError`) before the registry is touched."""
        if plan is None:
            raise ValueError("nothing to publish: plan is None")
        self.init()
        gen = _next_generation(self.generations_dir)
        while True:
            dest = self.generation_dir(gen)
            try:
                manifest = _write_artifact(plan, dest, generation=gen,
                                           store=store)
                break
            except FileExistsError:
                gen += 1                # a racing publisher took the slot
        pointer = dict(manifest.to_dict())
        pointer["path"] = f"{GENERATIONS}/{_generation_name(gen)}"
        pointer["published_at"] = time.time()
        _atomic_write(self.root / CURRENT_NAME,
                      json.dumps(pointer, sort_keys=True))
        self._count("published")
        return manifest

    def current(self) -> Optional[Dict[str, object]]:
        """The published pointer, or None (nothing published yet, or an
        unreadable pointer: both mean "try again at the next poll")."""
        io = chaos._IO
        try:
            path = self.root / CURRENT_NAME
            text = (path.read_text(encoding="utf-8") if io is None
                    else io.read_text(path, "plan.registry.current"))
            doc = json.loads(text)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or "generation" not in doc:
            return None
        return doc

    def pull(self, pointer: Mapping[str, object]) -> DispatchPlan:
        """Load the artifact behind a ``current()`` pointer and check it is
        the one the pointer names (digest equality)."""
        rel = str(pointer.get("path") or f"{GENERATIONS}/"
                  f"{_generation_name(int(pointer['generation']))}")
        plan = load_plan(self.root / rel)
        want = pointer.get("digest")
        if want and plan.digest != want:
            raise PlanArtifactError(
                f"{self.root / rel}: artifact digest {plan.digest} does not "
                f"match the published pointer ({want})")
        return plan

    @staticmethod
    def _count(event: str) -> None:
        get_registry().counter(
            "tunedb_plan_registry_events_total",
            "plan registry publishes/pulls").inc(event=event)


# the live followers, which the metrics registry's collector reads at
# scrape time (the poll path itself makes no instrument call)
_FOLLOWERS: List["PlanFollower"] = []
_FOLLOWERS_LOCK = threading.Lock()


def active_followers() -> List["PlanFollower"]:
    with _FOLLOWERS_LOCK:
        return list(_FOLLOWERS)


class PlanFollower:
    """Poll a :class:`PlanRegistry` and adopt each new generation.

    By default an adopted plan goes into the process's serving state
    (``install_serving(plan=...)``, ``store`` and ``fingerprint`` when
    given, else the installed ones kept); ``install=`` / ``current_plan=``
    follow into another target (tests, simulated replicas).  A candidate
    is refused, counted, and the serving generation kept, when:

    * its artifact fails verification (``refused_digest``);
    * ``CURRENT`` points below what this follower installed
      (``refused_stale``);
    * the sentry finds planned shapes losing coverage against the plan
      served now (``refused_sentry``).

    Each candidate's pull-verify-install attempt is one ``plan.install``
    span, always kept while tracing is on.
    """

    def __init__(self, registry, *,
                 store: Optional[RecordStore] = None,
                 fingerprint: Optional[str] = None,
                 poll_s: float = 2.0,
                 sentry=None,
                 install: Optional[Callable] = None,
                 current_plan: Optional[Callable] = None,
                 name: Optional[str] = None):
        self.registry = (registry if isinstance(registry, PlanRegistry)
                         else PlanRegistry(registry))
        self.store = store
        self.fingerprint = fingerprint
        self.poll_s = float(poll_s)
        self.sentry = sentry
        self.name = name or f"follower-{os.getpid()}-{id(self) & 0xffff}"
        self.generation = -1            # the last installed generation
        self.installed_at: Optional[float] = None
        self.lag_s: Optional[float] = None   # publish -> install delay
        self.polls = 0
        self.installs = 0
        self.refused_digest = 0
        self.refused_stale = 0
        self.refused_sentry = 0
        self.errors = 0
        self._install = install or self._install_serving
        self._current_plan = current_plan or self._serving_plan
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        with _FOLLOWERS_LOCK:
            _FOLLOWERS.append(self)

    # -- the default target: the process's serving state -----------------------
    @staticmethod
    def _serving_plan():
        return serving_state().plan

    def _install_serving(self, plan: DispatchPlan,
                         pointer: Mapping[str, object]) -> bool:
        install_serving(
            store=self.store if self.store is not None else _KEEP,
            fingerprint=(self.fingerprint if self.fingerprint is not None
                         else _KEEP),
            plan=plan)
        return True

    # -- one round -----------------------------------------------------------
    def poll_once(self) -> Optional[Dict[str, object]]:
        """Check the registry once: the pointer installed this round, or
        None (nothing new, or the candidate was refused)."""
        self.polls += 1
        pointer = self.registry.current()
        if pointer is None:
            return None
        try:
            gen = int(pointer["generation"])
        except (TypeError, ValueError):
            self.errors += 1
            return None
        if gen <= self.generation:
            if gen < self.generation:
                self.refused_stale += 1     # a rollback: keep serving
            return None
        tr = _trace._TRACER
        sp = (tr.begin("plan.install", trace_id=_trace.new_trace_id(),
                       follower=self.name, generation=gen)
              if tr is not None else None)
        outcome = "installed"
        try:
            try:
                plan = self.registry.pull(pointer)
            except PlanArtifactError:
                self.refused_digest += 1    # torn: the next poll retries
                outcome = "refused_digest"
                return None
            if self.sentry is not None:
                cur = self._current_plan()
                if cur is not None:
                    from .obs.snapshot import plan_snapshot
                    report = self.sentry.diff_plans(plan_snapshot(cur),
                                                    plan_snapshot(plan))
                    if not report.ok:
                        self.refused_sentry += 1
                        outcome = "refused_sentry"
                        warnings.warn(
                            f"plan follower {self.name} refused generation "
                            f"{gen}: {len(report.regressions)} planned "
                            "shape(s) lose coverage vs the serving plan; "
                            f"keeping generation {self.generation}",
                            RuntimeWarning, stacklevel=2)
                        return None
            if not self._install(plan, pointer):
                self.errors += 1
                outcome = "error"
                return None
            self.generation = gen
            self.installs += 1
            self.installed_at = time.time()
            published = pointer.get("published_at")
            if isinstance(published, (int, float)) and published > 0:
                self.lag_s = max(self.installed_at - float(published), 0.0)
            return dict(pointer)
        finally:
            if sp is not None:
                tr.end(sp, outcome=outcome)

    # -- the daemon loop -----------------------------------------------------
    def start(self) -> "PlanFollower":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:   # noqa: BLE001 — counted, the loop goes on
                self.errors += 1
            self._stop.wait(self.poll_s)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        with _FOLLOWERS_LOCK:
            if self in _FOLLOWERS:
                _FOLLOWERS.remove(self)

    # -- reporting -----------------------------------------------------------
    def published_generation(self) -> Optional[int]:
        pointer = self.registry.current()
        if pointer is None:
            return None
        try:
            return int(pointer["generation"])
        except (TypeError, ValueError):
            return None

    def lag_generations(self) -> int:
        """How many generations behind the registry this follower is."""
        published = self.published_generation()
        if published is None:
            return 0
        return max(published - max(self.generation, 0), 0)

    def stats(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "registry": str(self.registry.root),
            "generation": self.generation,
            "published_generation": self.published_generation(),
            "lag_generations": self.lag_generations(),
            "lag_s": self.lag_s,
            "polls": self.polls,
            "installs": self.installs,
            "refused_digest": self.refused_digest,
            "refused_stale": self.refused_stale,
            "refused_sentry": self.refused_sentry,
            "errors": self.errors,
            "running": self._thread is not None,
        }
