"""Fleet coordinator: publish a tuning plan, merge shards, report.

A port of ``repro.tunedb.fleet.coordinator``.  The coordinator owns the
parent :class:`~repro_torch.tunedb.store.RecordStore` and the fleet
directory; workers own their shards.  Its loop:

  1. **publish**: one lease-file job per planned shape (idempotent by job
     id, so publishing a plan again after a restart queues only what is
     not already queued, leased, done or failed).
  2. **poll**: sweep queue entries whose job completed anyway, requeue
     expired leases (crashed workers), and merge every shard's new records
     into the parent store.  Each shard has a cursor
     (``merged/<worker_id>.json``: the records consumed and the byte
     offset), so a restarted coordinator resumes where the last one
     stopped.  Only complete lines past the cursor are parsed (a live
     worker may be appending), and the cursor moves only after their
     records are in the store.
  3. **finalize**: retrain the regressors of every (space, backend) the
     merge touched and write a :class:`FleetReport` beside the manifest.

A merged record keeps its ``source`` and gains ``merged_from=<worker_id>``.
With ``sentry_margin`` the merge is gated: a shard record that would
replace a faster serving record beyond the margin is counted and refused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple

from ..obs.metrics import get_registry
from ..obs.sentry import RegressionSentry
from ..store import (SAMPLE_SOURCE, DispatchPlan, RecordStore, TuneRecord,
                     shape_key)
from ..telemetry import FleetTelemetryView, ShapeTelemetry
from .lease import REPORT, FleetDir, FleetJob, _atomic_write

MERGED = "merged"                       # the per-shard merge cursors


@dataclasses.dataclass
class FleetReport:
    """What one fleet run did, written to ``<fleet>/report.json``."""

    published: int = 0
    done: int = 0
    failed: int = 0
    requeued: int = 0                   # expiry reclaims seen this run
    merged_records: int = 0             # serving records merged
    merged_samples: int = 0             # training samples merged
    sentry_blocked: int = 0             # shard records the gate refused
    retrained: List[str] = dataclasses.field(default_factory=list)
    workers: List[str] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    jobs_per_s: float = 0.0

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class Coordinator:
    """Publish :class:`FleetJob` leases, merge worker shards, retrain.

    ``store`` must have a file behind it: the manifest records its path so
    worker processes, which share nothing with the coordinator but the
    filesystem, place their shards beside it.  A directory made for
    another store is refused.  ``store=None`` resumes from the manifest.
    """

    def __init__(self, fleet_dir: os.PathLike,
                 store: Optional[RecordStore] = None, *,
                 lease_timeout_s: float = 30.0, max_attempts: int = 3,
                 sentry_margin: Optional[float] = None):
        self.fleet = FleetDir(fleet_dir)
        if store is not None:
            if store.path is None:
                raise ValueError(
                    "fleet coordination needs a disk-backed parent store "
                    "(workers derive their shard paths from it)")
            self.store = store
            self.fleet.init(store.path, lease_timeout_s=lease_timeout_s,
                            max_attempts=max_attempts)
            manifest_store = self.fleet.store_path()
            if manifest_store != pathlib.Path(store.path).resolve():
                raise ValueError(
                    f"fleet dir {self.fleet.root} was created for store "
                    f"{manifest_store}, not {store.path}; use a fresh "
                    "fleet directory (or omit `store` to resume)")
        else:
            self.store = RecordStore.open(self.fleet.store_path())
        m = self.fleet.manifest()
        self.lease_timeout_s = float(m["lease_timeout_s"])
        self.max_attempts = int(m["max_attempts"])
        self._merged_dir = self.fleet.root / MERGED
        self._merged_dir.mkdir(parents=True, exist_ok=True)
        self.published = 0
        self.requeued = 0
        self.merged_records = 0
        self.merged_samples = 0
        self.sentry = (None if sentry_margin is None
                       else RegressionSentry(noise_margin=sentry_margin))
        self.sentry_blocked = 0
        # (space, backend) pairs the merge touched: the retrain set
        self.affected: Set[Tuple[str, str]] = set()
        # shard sizes at the last merge: an unchanged file is not read
        self._shard_sizes: Dict[str, int] = {}
        self._fresh_models = None

    # -- publish ---------------------------------------------------------------
    def publish(self, jobs: Iterable, *, source: str = "fleet",
                force: bool = False) -> int:
        """Queue jobs (``FleetJob``s, session ``TuneJob``s or ``(space,
        inputs, count)`` tuples); the number that were new.  ``force``
        queues again jobs an earlier run finished."""
        n = 0
        for job in jobs:
            if isinstance(job, FleetJob):
                fj = job
            elif isinstance(job, tuple):
                space, inputs, count = job
                fj = FleetJob(space=space, inputs=dict(inputs),
                              count=int(count), source=source)
            else:
                fj = FleetJob(space=job.space, inputs=dict(job.inputs),
                              count=int(getattr(job, "count", 0)),
                              source=source)
            if self.fleet.publish(fj, force=force):
                n += 1
        if n:
            self.fleet.clear_drain()    # new work revives a drained bus
        self.published += n
        return n

    def plan_from_telemetry(self, telemetry=None, *,
                            spaces: Optional[List[str]] = None, top_k: int = 8,
                            backend: Optional[str] = None,
                            skip_existing: bool = True,
                            source: str = "fleet") -> List[FleetJob]:
        """The top-K hot shapes per space as jobs, skipping shapes the
        parent store serves (under ``backend`` when given); without
        ``telemetry``, the fleet-global view of the bus is mined."""
        if telemetry is None:
            telemetry = self.global_telemetry()
        jobs: List[FleetJob] = []
        for space in (spaces if spaces is not None else telemetry.spaces()):
            for inputs, count in telemetry.hot_shapes(space, top_k):
                if skip_existing and self.store.contains(space, inputs,
                                                         backend=backend):
                    continue
                jobs.append(FleetJob(space=space, inputs=dict(inputs),
                                     count=count, source=source))
        return jobs

    # -- fleet-global telemetry ------------------------------------------------
    def global_telemetry(self, *, local: Optional[ShapeTelemetry] = None,
                         refresh_s: float = 0.0) -> FleetTelemetryView:
        """Every worker's latest dump under ``<fleet>/telemetry/`` folded
        into one view; ``local`` defaults to an empty telemetry (the
        coordinator aggregates, it serves no traffic)."""
        return FleetTelemetryView(
            self.fleet.telemetry_dir(),
            local=local if local is not None else ShapeTelemetry(),
            refresh_s=refresh_s)

    def telemetry_provenance(self) -> Dict[str, Dict[str, object]]:
        """Each replica's dump provenance on the bus."""
        return self.global_telemetry().replicas()

    @staticmethod
    def _shape_bucket(space: str, inputs: Mapping[str, object]) -> tuple:
        """The affinity class of a shape: (space, log2-bucketed dims)."""
        sig = []
        for k in sorted(inputs):
            v = inputs[k]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                sig.append((k, str(v)))
            elif v > 0:
                sig.append((k, int(v).bit_length()))
            else:
                sig.append((k, int(v)))
        return (space, tuple(sig))

    def partition_hot_shapes(self, n_replicas: int, *, telemetry=None,
                             top_k: int = 32,
                             spaces: Optional[List[str]] = None
                             ) -> List[List[Tuple[str, Dict[str, int], int]]]:
        """The global hot set split into one affinity class per replica:
        shapes grouped by :meth:`_shape_bucket`, buckets assigned hottest
        first to the replica with the least call mass so far (ties to the
        lower index).  One ``[(space, inputs, count), ...]`` a replica."""
        if n_replicas <= 0:
            raise ValueError(f"n_replicas must be positive, got {n_replicas}")
        if telemetry is None:
            telemetry = self.global_telemetry()
        buckets: Dict[tuple, List] = {}
        for space in (spaces if spaces is not None else telemetry.spaces()):
            for inputs, count in telemetry.hot_shapes(space, top_k):
                b = buckets.setdefault(self._shape_bucket(space, inputs),
                                       [0, []])
                b[0] += count
                b[1].append((space, dict(inputs), int(count)))
        classes: List[List[Tuple[str, Dict[str, int], int]]] = [
            [] for _ in range(n_replicas)]
        loads = [0] * n_replicas
        for _sig, (mass, shapes) in sorted(
                buckets.items(), key=lambda kv: (-kv[1][0], repr(kv[0]))):
            i = min(range(n_replicas), key=lambda j: (loads[j], j))
            loads[i] += mass
            classes[i].extend(shapes)
        return classes

    def _models(self, models_dir: Optional[os.PathLike]):
        """The last retrain's models, else ``models_dir``'s, else None."""
        models = self.fresh_models()
        if models is None and models_dir \
                and pathlib.Path(models_dir).is_dir():
            from ..model import ModelSet
            loaded = ModelSet.load(models_dir)
            if len(loaded):
                models = loaded
        return models

    def publish_replica_plans(self, registry_root: os.PathLike,
                              n_replicas: int, *, telemetry=None,
                              fingerprint: Optional[str] = None,
                              models_dir: Optional[os.PathLike] = None,
                              top_k: int = 32) -> List[Dict[str, object]]:
        """Publish one small plan per affinity class, under
        ``<registry_root>/replica-<i>/`` (a :class:`PlanRegistry` each):
        each class's shapes resolved store exact, then model, then
        nearest.  One summary dict a replica."""
        from ..plans import PlanRegistry
        classes = self.partition_hot_shapes(n_replicas, telemetry=telemetry,
                                            top_k=top_k)
        models = self._models(models_dir)
        predict = getattr(models, "predict", None) if models is not None \
            else None
        out: List[Dict[str, object]] = []
        root = pathlib.Path(registry_root)
        for i, shapes in enumerate(classes):
            table: Dict[tuple, Tuple[Dict[str, int], str]] = {}
            for space, inputs, _count in shapes:
                cfg, tier = None, ""
                rec = self.store.get(space, inputs, backend=fingerprint)
                if rec is not None:
                    cfg, tier = rec.config, "exact"
                if cfg is None and callable(predict):
                    got = predict(space, inputs, backend=fingerprint)
                    if got is not None:
                        cfg, tier = got[0], "model"
                if cfg is None:
                    rec = self.store.nearest(space, inputs,
                                             backend=fingerprint, count=False)
                    if rec is not None:
                        cfg, tier = rec.config, "nearest"
                if cfg is not None:
                    table[(space, shape_key(inputs))] = (dict(cfg), tier)
            name = f"replica-{i}"
            manifest = None
            if table:
                plan = DispatchPlan(generation=0, fingerprint=fingerprint,
                                    store_version=self.store.version,
                                    table=table)
                manifest = PlanRegistry(root / name).publish(
                    plan, store=self.store)
            out.append({
                "replica": name, "registry": str(root / name),
                "shapes": len(shapes), "entries": len(table),
                "mass": sum(c for _, _, c in shapes),
                "generation": (manifest.generation if manifest is not None
                               else None)})
        return out

    # -- shard merge -----------------------------------------------------------
    def _cursor(self, worker_id: str) -> Tuple[int, int]:
        """(records merged, byte offset consumed) of one shard."""
        path = self._merged_dir / f"{worker_id}.json"
        if not path.exists():
            return 0, 0
        try:
            d = json.loads(path.read_text())
            return int(d["merged"]), int(d.get("offset", -1))
        except (ValueError, KeyError, TypeError):
            return 0, 0

    def _save_cursor(self, worker_id: str, merged: int, offset: int) -> None:
        _atomic_write(self._merged_dir / f"{worker_id}.json",
                      json.dumps({"merged": merged, "offset": offset,
                                  "updated_at": time.time()}))

    def merge_completed(self) -> Tuple[int, int]:
        """Fold every shard's new records into the parent store, each once
        (the cursors), with one ``sync`` a pass instead of an fsync a
        record.  (serving records, samples) merged by this call."""
        shard_dir = self.fleet.shard_dir()
        if not shard_dir.is_dir():
            return 0, 0
        n_recs = n_samples = 0
        fsync_prev, self.store.fsync = self.store.fsync, False
        try:
            n_recs, n_samples = self._merge_pass(shard_dir)
        finally:
            self.store.fsync = fsync_prev
            if fsync_prev and n_recs + n_samples:
                self.store.sync()
        self.merged_records += n_recs
        self.merged_samples += n_samples
        return n_recs, n_samples

    def _sentry_refuses(self, rec: TuneRecord) -> bool:
        """The merge gate: True when ``rec`` would replace a faster serving
        record beyond the sentry's margin.  Samples pass (they never
        serve); a refused record is counted and never reaches the store."""
        if self.sentry is None or rec.source == SAMPLE_SOURCE:
            return False
        cur = self.store._index.get((rec.backend, rec.space,
                                     shape_key(rec.inputs)))
        # created_at <= 0 would be stamped "now" by add(): it would replace
        if cur is None or (0 < rec.created_at < cur.created_at):
            return False
        if not self.sentry.regresses(cur.tflops, rec.tflops):
            return False
        self.sentry_blocked += 1
        get_registry().counter(
            "tunedb_sentry_regressions_total",
            "records flagged as regressed by the sentry").inc(where="merge")
        return True

    def _merge_pass(self, shard_dir: pathlib.Path) -> Tuple[int, int]:
        n_recs = n_samples = 0
        for shard_path in sorted(shard_dir.glob("*.jsonl")):
            worker_id = shard_path.stem
            try:
                size = shard_path.stat().st_size
            except FileNotFoundError:
                continue
            if size == self._shard_sizes.get(worker_id):
                continue                 # nothing appended since
            count, offset = self._cursor(worker_id)
            # shards are append-only: read past the consumed bytes only (a
            # cursor without an offset pays one full parse)
            start, skip = (offset, 0) if offset >= 0 else (0, count)
            try:
                with shard_path.open("rb") as fh:
                    fh.seek(start)
                    chunk = fh.read()
            except OSError:
                continue                 # compacted or unreadable: next poll
            upto = chunk.rfind(b"\n")    # only complete lines are consumed
            if upto < 0:
                self._shard_sizes[worker_id] = size
                continue
            fresh: List[TuneRecord] = []
            for raw in chunk[:upto].split(b"\n"):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    fresh.append(TuneRecord.from_json(raw.decode("utf-8")))
                except (ValueError, TypeError, KeyError,
                        UnicodeDecodeError):
                    continue             # a garbage line: skipped
            for rec in fresh[skip:]:
                if self._sentry_refuses(rec):
                    continue             # consumed (the cursor moves), refused
                self.store.add(dataclasses.replace(rec,
                                                   merged_from=worker_id))
                if rec.source == SAMPLE_SOURCE:
                    n_samples += 1
                else:
                    n_recs += 1
                    self.affected.add((rec.space, rec.backend))
            new_count = len(fresh) if offset < 0 else count + len(fresh)
            self._save_cursor(worker_id, new_count, start + upto + 1)
            # only after the cursor is saved: a failure above leaves the
            # size stale, so the next poll reads the shard again
            self._shard_sizes[worker_id] = size
        return n_recs, n_samples

    # -- shard GC --------------------------------------------------------------
    def compact_shards(self) -> List[str]:
        """Move shards the cursor has consumed whole into
        ``<store>.shards/archive/`` and drop their cursors (a returning
        worker of the same id starts a fresh shard, merged from the top).
        Only once no worker can append: the drain path runs it with the
        queue and the leases empty.  The worker ids archived."""
        shard_dir = self.fleet.shard_dir()
        archived: List[str] = []
        if not shard_dir.is_dir():
            return archived
        archive = shard_dir / "archive"
        for shard_path in sorted(shard_dir.glob("*.jsonl")):
            worker_id = shard_path.stem
            try:
                size = shard_path.stat().st_size
            except FileNotFoundError:
                continue
            _count, offset = self._cursor(worker_id)
            if offset < 0 or offset < size:
                continue                 # unmerged bytes or an old cursor
            archive.mkdir(parents=True, exist_ok=True)
            dest = archive / shard_path.name
            if dest.exists():
                n = 1
                while (archive / f"{worker_id}.{n}.jsonl").exists():
                    n += 1
                dest = archive / f"{worker_id}.{n}.jsonl"
            os.replace(shard_path, dest)
            (self._merged_dir / f"{worker_id}.json").unlink(missing_ok=True)
            self._shard_sizes.pop(worker_id, None)
            archived.append(worker_id)
        return archived

    # -- the poll loop ---------------------------------------------------------
    def poll(self) -> Dict[str, object]:
        """One maintenance pass: sweep, reclaim expired leases, merge."""
        self.fleet.sweep_done()
        reclaimed = self.fleet.reclaim_expired(
            lease_timeout_s=self.lease_timeout_s,
            max_attempts=self.max_attempts)
        self.requeued += len(reclaimed)
        recs, samples = self.merge_completed()
        return {"counts": self.fleet.counts(),
                "draining": self.fleet.draining(),
                "reclaimed": reclaimed, "merged_now": recs + samples}

    def outstanding(self) -> int:
        return self.fleet.outstanding()

    def wait(self, *, timeout_s: Optional[float] = None,
             poll_s: float = 0.25, verbose: bool = False,
             cancel=None) -> bool:
        """Poll until every published job is done or failed (True) or the
        deadline passes (False), merging as shards fill.  ``cancel`` (a
        ``threading.Event``, the retune watchdog's) ends the wait early."""
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            if cancel is not None and cancel.is_set():
                return False
            status = self.poll()
            left = self.outstanding()
            if verbose:
                c = status["counts"]
                print(f"[fleet] queue {c['queue']}, leases {c['leases']}, "
                      f"done {c['done']}, failed {c['failed']}", flush=True)
            if left == 0:
                return True
            if deadline is not None and time.time() >= deadline:
                return False
            time.sleep(poll_s)

    # -- retrain and report ----------------------------------------------------
    def retrain(self, *, models_dir: Optional[os.PathLike] = None,
                min_samples: int = 24, epochs: int = 20,
                seed: int = 0) -> List[str]:
        """Retrain the regressors of every (space, backend) the merge
        touched (saved to ``models_dir`` when given); the ``space/backend``
        keys retrained."""
        if not self.affected:
            return []
        from ..model import train_models
        fresh = None
        for space, backend in sorted(self.affected):
            part = train_models(self.store, space=space, backend=backend,
                                min_samples=min_samples, epochs=epochs,
                                seed=seed)
            fresh = part if fresh is None else fresh.merged_with(part)
        if fresh is None or not len(fresh):
            return []
        if models_dir:
            fresh.save(models_dir)
        self._fresh_models = fresh
        return [f"{s}/{b}" for s, b in sorted(fresh.models)]

    def fresh_models(self):
        """The model set the last :meth:`retrain` produced (None before)."""
        return self._fresh_models

    def publish_plan(self, registry_dir: os.PathLike, *,
                     fingerprint: Optional[str] = None,
                     models_dir: Optional[os.PathLike] = None,
                     telemetry=None, hot_k: Optional[int] = None):
        """Compile the merged store into a plan and publish it to a plan
        registry for replicas to follow; without ``telemetry`` the bus's
        global view (when any replica dumped) is the hot set.  The
        published :class:`~repro_torch.tunedb.plans.PlanManifest`."""
        from ..plans import PlanRegistry
        from ..store import PLAN_HOT_K, compile_plan
        if telemetry is None:
            fleet_view = self.global_telemetry()
            if fleet_view.total() > 0:
                telemetry = fleet_view
        plan = compile_plan(self.store, self._models(models_dir),
                            fingerprint, telemetry=telemetry,
                            hot_k=PLAN_HOT_K if hot_k is None else hot_k)
        if plan is None or not len(plan):
            raise ValueError(
                "nothing to publish: the merged store has no serving "
                "records" + (f" under fingerprint {fingerprint!r}"
                             if fingerprint else ""))
        return PlanRegistry(registry_dir).publish(plan, store=self.store)

    def report(self, *, retrained: Optional[List[str]] = None,
               wall_s: float = 0.0, write: bool = True) -> FleetReport:
        counts = self.fleet.counts()
        workers = sorted({str(m.get("worker_id", "?"))
                          for m in self.fleet.done_meta()})
        rep = FleetReport(
            published=self.published, done=counts["done"],
            failed=counts["failed"], requeued=self.requeued,
            merged_records=self.merged_records,
            merged_samples=self.merged_samples,
            sentry_blocked=self.sentry_blocked,
            retrained=list(retrained or []), workers=workers,
            wall_s=wall_s,
            jobs_per_s=(counts["done"] / wall_s if wall_s > 0 else 0.0))
        if write:
            _atomic_write(self.fleet.root / REPORT,
                          json.dumps(rep.to_dict(), indent=1,
                                     sort_keys=True))
        self._publish_metrics(counts)
        return rep

    def _publish_metrics(self, counts: Dict[str, int]) -> None:
        """Queue state and merge progress into the metrics registry."""
        reg = get_registry()
        jobs = reg.gauge("tunedb_fleet_jobs", "fleet bus job counts by state")
        for state in ("queue", "leases", "done", "failed"):
            jobs.set(counts.get(state, 0), state=state)
        merged = reg.gauge("tunedb_fleet_merged_records",
                           "records folded into the parent store")
        merged.set(self.merged_records, kind="serving")
        merged.set(self.merged_samples, kind="sample")
        reg.gauge("tunedb_fleet_requeued",
                  "expiry reclaims observed this run").set(self.requeued)
        reg.gauge("tunedb_fleet_sentry_blocked",
                  "shard records refused by the merge sentry").set(
                      self.sentry_blocked)


def run_fleet_inline(fleet_dir: os.PathLike, store: RecordStore,
                     jobs: Iterable, *, n_workers: int = 2,
                     tuners: Optional[Mapping[str, object]] = None,
                     tuner_factory=None, source: str = "fleet",
                     lease_timeout_s: float = 30.0,
                     timeout_s: Optional[float] = None,
                     remeasure: bool = True) -> FleetReport:
    """A coordinator and ``n_workers`` thread workers in one process: the
    same directory, leases and shards as a fleet of processes, without
    the process management.  The workers share ``tuners``."""
    import threading

    from .worker import Worker

    t0 = time.time()
    coord = Coordinator(fleet_dir, store, lease_timeout_s=lease_timeout_s)
    coord.publish(jobs, source=source)
    coord.fleet.request_drain()          # one plan, then everybody goes home
    workers = [Worker(fleet_dir, worker_id=f"w{i}", tuners=tuners,
                      tuner_factory=tuner_factory, poll_s=0.02,
                      remeasure=remeasure)
               for i in range(n_workers)]
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    coord.wait(timeout_s=timeout_s, poll_s=0.1)
    for t in threads:
        t.join()
    coord.poll()                         # the final merge
    return coord.report(wall_s=time.time() - t0)
