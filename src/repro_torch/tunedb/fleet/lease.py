"""Filesystem lease protocol: the coordination bus of the tuning fleet.

A port of ``repro.tunedb.fleet.lease``, with the reference's file layout
and JSON formats, so a bus written by either package reads in the other.
No network, no database, no daemon: a shared directory is the queue, as
the record store is a shared JSONL file.

  * **publish**: the coordinator writes one ``queue/<job_id>.json`` per
    :class:`FleetJob` (a temporary file, then a rename, so no reader sees
    a torn job file).  ``job_id`` comes from the (space, inputs) key, so
    publishing the same plan again is idempotent.
  * **claim by atomic rename**: a worker claims a job by renaming
    ``queue/<id>.json`` to ``leases/<id>.json``.  ``os.rename`` of one
    source path succeeds for exactly one racer; every loser gets
    ``FileNotFoundError`` and moves to the next entry.  Entries are tried
    hottest first (the telemetry ``count`` in the job file).
  * **heartbeat**: the claiming worker refreshes the lease file's mtime
    while it tunes; a heartbeat on a vanished lease tells the worker the
    job was reclaimed.
  * **expiry**: the coordinator requeues a lease older than
    ``lease_timeout_s`` with ``attempts`` bumped, and buries it in
    ``failed/`` once ``max_attempts`` is spent.
  * **completion**: the worker appends its records to its own shard store
    (``<store>.shards/<worker_id>.jsonl``: one writer a file), writes
    ``done/<id>.json``, then drops the lease.  The done marker wins: a
    lease or queue entry whose job is done is swept, never run again.
  * **drain**: a ``DRAIN`` marker tells workers to exit once the queue is
    empty instead of idling for more work.

Every transition is atomic (a rename, or a temporary file and a replace)
but not fsynced: the bus recovers crashed processes, and a host's power
loss may drop in-flight markers, whose jobs lease expiry or the next
publish queue again.  The reference writes these files through its
fault-injection shim (``chaos._IO`` / ``retry_io``); the port writes them
plainly (the shim is ROADMAP A6.4).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Dict, List, Mapping, Optional, Tuple

from ..store import input_key, normalize_inputs

FLEET_SCHEMA_VERSION = 1

QUEUE, LEASES, DONE, FAILED = "queue", "leases", "done", "failed"
MANIFEST, DRAIN_MARKER, REPORT = "manifest.json", "DRAIN", "report.json"


def job_id_for(space: str, inputs: Mapping[str, int]) -> str:
    """Stable job id, one per (space, inputs): publishing is idempotent."""
    return f"{space}-{input_key(space, inputs)}"


@dataclasses.dataclass(frozen=True)
class FleetJob:
    """One leased unit of fleet work: tune one input shape."""

    space: str
    inputs: Dict[str, int]
    count: int = 0                      # telemetry frequency (claim priority)
    source: str = "fleet"               # the committed record's source tag
    attempts: int = 0                   # times this job was leased so far
    created_at: float = 0.0
    # the trace id of the coordinator epoch that published the job ("" =
    # not traced): a worker opens its fleet.job root under it, so the
    # merged trace links the worker's tuning to the submit-to-swap window
    trace_id: str = ""

    @property
    def job_id(self) -> str:
        return job_id_for(self.space, self.inputs)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["schema_version"] = FLEET_SCHEMA_VERSION
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "FleetJob":
        d = json.loads(line)
        if not isinstance(d, dict) or "space" not in d or "inputs" not in d:
            raise ValueError(f"not a FleetJob: {line[:80]!r}")
        if int(d.get("schema_version", 1)) > FLEET_SCHEMA_VERSION:
            raise ValueError(
                f"job schema v{d['schema_version']} > v{FLEET_SCHEMA_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d["inputs"] = normalize_inputs(d["inputs"])
        return cls(**d)


def _atomic_write(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text, encoding="utf-8")
    os.replace(tmp, path)


class FleetDir:
    """One fleet's coordination directory: queue, leases, done, failed and
    the manifest.

    Every mutation is one atomic filesystem operation, so any number of
    worker processes and one coordinator share the directory with no
    locks.  A file that vanishes mid-operation means another process got
    there first, never an error.
    """

    def __init__(self, root: os.PathLike):
        self.root = pathlib.Path(root)
        self.queue = self.root / QUEUE
        self.leases = self.root / LEASES
        self.done = self.root / DONE
        self.failed = self.root / FAILED
        # job file name -> (mtime_ns, telemetry count): the claim loop
        # stats each entry instead of parsing it again; a republished job
        # (a new mtime) is parsed again
        self._priority_cache: Dict[str, Tuple[int, int]] = {}

    # -- lifecycle -----------------------------------------------------------
    def init(self, store_path: os.PathLike, *, lease_timeout_s: float = 30.0,
             max_attempts: int = 3) -> Dict[str, object]:
        """Create the directory layout and the manifest (idempotent: an
        existing manifest wins)."""
        for d in (self.root, self.queue, self.leases, self.done, self.failed):
            d.mkdir(parents=True, exist_ok=True)
        manifest = {
            "schema_version": FLEET_SCHEMA_VERSION,
            "store": str(pathlib.Path(store_path).resolve()),
            "lease_timeout_s": float(lease_timeout_s),
            "max_attempts": int(max_attempts),
            "created_at": time.time(),
        }
        path = self.root / MANIFEST
        if path.exists():
            return self.manifest()
        _atomic_write(path, json.dumps(manifest, sort_keys=True))
        return manifest

    def manifest(self) -> Dict[str, object]:
        path = self.root / MANIFEST
        if not path.exists():
            raise FileNotFoundError(
                f"{path}: not a fleet directory (run `fleet start` first)")
        return json.loads(path.read_text())

    def store_path(self) -> pathlib.Path:
        return pathlib.Path(str(self.manifest()["store"]))

    def shard_dir(self) -> pathlib.Path:
        """The workers' shard stores live beside the parent store."""
        store = self.store_path()
        return store.with_name(store.name + ".shards")

    def shard_path(self, worker_id: str) -> pathlib.Path:
        return self.shard_dir() / f"{worker_id}.jsonl"

    def telemetry_dir(self) -> pathlib.Path:
        """``<fleet>/telemetry/<worker_id>/<epoch>.json``: the cumulative
        telemetry dumps of :class:`~repro_torch.tunedb.telemetry.
        TelemetryExporter`, which the coordinator aggregates."""
        return self.root / "telemetry"

    # -- publish -------------------------------------------------------------
    def publish(self, job: FleetJob, *, force: bool = False) -> bool:
        """Queue one job unless it is already anywhere in the lifecycle.

        ``force`` queues again a job whose earlier run completed or failed
        (its terminal marker is dropped first); a job queued or leased now
        is never duplicated.
        """
        jid = job.job_id
        for d in (self.queue, self.leases):
            if (d / f"{jid}.json").exists():
                return False
        for d in (self.done, self.failed):
            marker = d / f"{jid}.json"
            if marker.exists():
                if not force:
                    return False
                marker.unlink(missing_ok=True)
        if job.created_at <= 0:
            job = dataclasses.replace(job, created_at=time.time())
        _atomic_write(self.queue / f"{jid}.json", job.to_json())
        return True

    # -- claim / heartbeat (worker side) --------------------------------------
    def claim(self) -> Optional[Tuple[FleetJob, pathlib.Path]]:
        """Claim the hottest queue entry by atomic rename: ``(job,
        lease_path)``, or None when the queue is empty (or every entry went
        to a faster racer).  Entries are tried by descending telemetry
        ``count``, then job id; the priority read is advisory, the claim is
        the rename."""
        entries: List[Tuple[int, str]] = []
        try:
            for p in self.queue.iterdir():
                if p.suffix != ".json":
                    continue
                try:
                    mtime = p.stat().st_mtime_ns
                except FileNotFoundError:
                    continue            # claimed under us
                cached = self._priority_cache.get(p.name)
                if cached is None or cached[0] != mtime:
                    count = 0
                    try:
                        count = int(json.loads(p.read_text()).get("count", 0))
                    except (ValueError, TypeError, OSError, AttributeError):
                        pass            # vanished or garbage: lowest priority
                    if len(self._priority_cache) > 65536:
                        self._priority_cache.clear()
                    cached = self._priority_cache[p.name] = (mtime, count)
                entries.append((-cached[1], p.name))
        except FileNotFoundError:
            return None
        for _, name in sorted(entries):
            src, dst = self.queue / name, self.leases / name
            try:
                # freshen before the rename (which keeps the mtime): a job
                # that sat queued past the lease timeout must not be born
                # expired
                os.utime(src)
                os.rename(src, dst)
            except OSError:
                continue                # lost the race for this entry
            try:
                job = FleetJob.from_json(dst.read_text())
            except ValueError:
                dst.unlink(missing_ok=True)      # foreign garbage: drop it
                continue
            except OSError:
                continue                # reclaimed or completed under us
            try:
                os.utime(dst)           # the claim is the first heartbeat
            except OSError:
                pass
            return job, dst
        return None

    def heartbeat(self, lease_path: pathlib.Path) -> bool:
        """Refresh the lease's mtime; False means it was reclaimed."""
        try:
            os.utime(lease_path)
            return True
        except FileNotFoundError:
            return False
        except OSError:
            return lease_path.exists()

    # -- completion / failure (worker side) ------------------------------------
    def complete(self, job: FleetJob, lease_path: pathlib.Path,
                 meta: Mapping[str, object]) -> bool:
        """Mark a job done: the marker first, then the lease dropped (a
        crash between the two leaves a lease the sweep removes).  False
        when a marker was already there: the records still count (the
        merge is newest-wins), the credit goes to the first finisher."""
        marker = self.done / f"{job.job_id}.json"
        already = marker.exists()
        if not already:
            payload = dict(meta)
            payload.update(job_id=job.job_id, space=job.space,
                           inputs=job.inputs, finished_at=time.time())
            _atomic_write(marker, json.dumps(payload, sort_keys=True))
        try:
            lease_path.unlink(missing_ok=True)
        except OSError:
            pass
        return not already

    def fail(self, job: FleetJob, lease_path: pathlib.Path, error: str, *,
             max_attempts: int) -> str:
        """Requeue a failed job (attempts bumped) or bury it in ``failed/``;
        ``"requeued"`` or ``"failed"``."""
        attempts = job.attempts + 1
        if attempts >= max_attempts:
            _atomic_write(self.failed / f"{job.job_id}.json", json.dumps({
                "job": json.loads(job.to_json()), "attempts": attempts,
                "error": error, "failed_at": time.time()}, sort_keys=True))
            outcome = "failed"
        else:
            requeued = dataclasses.replace(job, attempts=attempts)
            _atomic_write(self.queue / f"{job.job_id}.json",
                          requeued.to_json())
            outcome = "requeued"
        lease_path.unlink(missing_ok=True)
        return outcome

    # -- expiry / sweep (coordinator side) -------------------------------------
    def reclaim_expired(self, *, lease_timeout_s: float,
                        max_attempts: int) -> List[str]:
        """Return crashed workers' jobs to the queue (or bury them); a lease
        whose job has a done marker is swept.  The job ids requeued or
        failed this pass."""
        now = time.time()
        touched: List[str] = []
        for lease in sorted(self.leases.glob("*.json")):
            if (self.done / lease.name).exists():
                lease.unlink(missing_ok=True)      # finished, stale lease
                continue
            try:
                age = now - lease.stat().st_mtime
            except FileNotFoundError:
                continue
            if age <= lease_timeout_s:
                continue
            try:
                job = FleetJob.from_json(lease.read_text())
            except ValueError:
                lease.unlink(missing_ok=True)      # unparseable: job lost
                continue
            except OSError:
                continue                           # released under us
            self.fail(job, lease, f"lease expired after {age:.1f}s",
                      max_attempts=max_attempts)
            touched.append(lease.stem)
        return touched

    def sweep_done(self) -> int:
        """Drop queue entries whose job completed anyway (an expiry requeue
        racing a slow worker that finished); the entries removed."""
        n = 0
        for entry in self.queue.glob("*.json"):
            if (self.done / entry.name).exists():
                entry.unlink(missing_ok=True)
                n += 1
        return n

    # -- drain ----------------------------------------------------------------
    def request_drain(self) -> None:
        (self.root / DRAIN_MARKER).touch()

    def clear_drain(self) -> None:
        """New work revives a drained fleet: without this, a directory that
        was ever drained would turn every later worker away."""
        (self.root / DRAIN_MARKER).unlink(missing_ok=True)

    def draining(self) -> bool:
        return (self.root / DRAIN_MARKER).exists()

    # -- inspection ------------------------------------------------------------
    @staticmethod
    def _count(d: pathlib.Path) -> int:
        try:
            return sum(1 for p in d.iterdir() if p.suffix == ".json")
        except FileNotFoundError:
            return 0

    def counts(self) -> Dict[str, int]:
        return {state: self._count(d) for state, d in
                ((QUEUE, self.queue), (LEASES, self.leases),
                 (DONE, self.done), (FAILED, self.failed))}

    def outstanding(self) -> int:
        """Jobs not yet done or failed."""
        c = self.counts()
        return c[QUEUE] + c[LEASES]

    def done_meta(self) -> List[Dict[str, object]]:
        out = []
        for p in sorted(self.done.glob("*.json")):
            try:
                out.append(json.loads(p.read_text()))
            except (ValueError, OSError):
                continue
            out[-1].setdefault("job_id", p.stem)
        return out

    def status(self) -> Dict[str, object]:
        now = time.time()
        lease_ages = {}
        for p in sorted(self.leases.glob("*.json")):
            try:
                lease_ages[p.stem] = round(now - p.stat().st_mtime, 3)
            except FileNotFoundError:
                continue
        shards = {}
        shard_dir = self.shard_dir()
        if shard_dir.is_dir():
            for p in sorted(shard_dir.glob("*.jsonl")):
                shards[p.stem] = sum(1 for line in
                                     p.read_text().splitlines() if line)
        return {
            "root": str(self.root),
            "store": str(self.store_path()),
            "counts": self.counts(),
            "draining": self.draining(),
            "lease_age_s": lease_ages,
            "shard_records": shards,
        }
