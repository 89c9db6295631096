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

The reference's registry and follower (publish / follow a plan across
replicas) are not ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import time
from typing import Dict, List, Mapping, Optional, Tuple

from .store import (DispatchPlan, RecordStore, normalize_config,
                    normalize_inputs, shape_key)

PLAN_SCHEMA_VERSION = 1

MANIFEST_NAME = "manifest.json"
ENTRIES_NAME = "entries.jsonl"


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
    try:
        (tmp / ENTRIES_NAME).write_bytes(blob)
        (tmp / MANIFEST_NAME).write_text(
            json.dumps(manifest.to_dict(), sort_keys=True), encoding="utf-8")
        os.rename(tmp, dest)            # the whole artifact or nothing
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
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
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
    try:
        blob = entries_path.read_bytes()
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
