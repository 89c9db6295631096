"""Fleet worker: claim leased jobs, tune, append to a private shard store.

A port of ``repro.tunedb.fleet.worker``.  A :class:`Worker` claims jobs
from the shared :class:`~repro_torch.tunedb.fleet.lease.FleetDir` (claim
by atomic rename: two workers never run one lease), tunes the shape with
its per-space tuner and appends the records to its own shard store,
``<store>.shards/<worker_id>.jsonl``, so no two writers share a file.  The
coordinator merges the shards into the parent store; a worker never
touches the parent.

While a job runs a daemon thread refreshes the lease's mtime every
``heartbeat_s``; a worker that dies mid-job stops heartbeating and the
coordinator's expiry pass queues the job again.  The chaos shim's
kill-points ``worker.claimed``, ``worker.tuned``, ``worker.appended`` and
``worker.complete`` raise :class:`~repro_torch.tunedb.chaos.KillPoint`
(a ``BaseException``) past the job isolation, as a real kill would end
the worker between those steps.  Workers may be threads
of one process (tests, ``run_fleet_inline``) or processes of their own
(``python -m repro_torch.tunedb fleet worker``): the protocol is the
filesystem either way.

Where the reference's default tuner trains on its TPU simulator, the
port's (``tunedb.controller._default_tuner_factory``) labels through
``CheckedBackend(CudaEventBackend(device))``: the correctness gate, then
the port's kernels timed on ``device`` (the card unless the caller names
the CPU).  Every such timing holds ``core.backend.DEVICE_LOCK``, so a
thread worker's measurements never overlap its process's graph captures.
A worker process has a CUDA context of its own: its captures and the
serving engine's cannot break each other, and its timings share the card
with the engine's replays (time-sliced).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import threading
import time
import uuid
from typing import Callable, Dict, List, Mapping, Optional

from .. import chaos
from ..controller import _default_tuner_factory
from ..obs import trace as _trace
from ..obs.metrics import get_registry
from ..session import record_from_search
from ..store import SAMPLE_SOURCE, RecordStore, TuneRecord
from ..telemetry import TelemetryExporter, get_telemetry
from .lease import FleetDir, FleetJob

_NULL_CTX = contextlib.nullcontext()


def default_worker_id() -> str:
    """A host-unique, restart-unique id: shard files never collide."""
    return (f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
            .replace("/", "-"))


@dataclasses.dataclass
class WorkerReport:
    worker_id: str
    claimed: int = 0
    tuned: int = 0
    failed: int = 0
    lost: int = 0                       # leases reclaimed from under us
    wall_s: float = 0.0
    errors: List[str] = dataclasses.field(default_factory=list)


class Worker:
    """One fleet worker: claim -> tune -> shard append -> done marker.

    ``tuners`` maps a space to a trained tuner (``.search`` /
    ``.backend``); a space without one is trained once by
    ``tuner_factory`` (by default ``_default_tuner_factory``, on the
    card).
    """

    def __init__(self, fleet_dir: os.PathLike, *,
                 worker_id: Optional[str] = None,
                 tuners: Optional[Mapping[str, object]] = None,
                 tuner_factory: Optional[Callable[[str], object]] = None,
                 heartbeat_s: float = 2.0, poll_s: float = 0.2,
                 remeasure: bool = True, collect_samples: bool = True,
                 telemetry_export_s: float = 0.0,
                 trace_export: bool = False,
                 verbose: bool = False):
        self.fleet = FleetDir(fleet_dir)
        self.worker_id = worker_id or default_worker_id()
        self.heartbeat_s = heartbeat_s
        self.poll_s = poll_s
        self.remeasure = remeasure
        self.collect_samples = collect_samples
        # > 0: dump this process's telemetry onto the bus every this many
        # seconds (``<fleet>/telemetry/<worker_id>/``)
        self.telemetry_export_s = float(telemetry_export_s)
        self.exporter: Optional[TelemetryExporter] = None
        # a worker process dumps its finished spans to
        # ``<fleet>/traces/<worker_id>.jsonl`` at the end of run(); a
        # thread worker must not (it shares its process's tracer)
        self.trace_export = trace_export
        self.verbose = verbose
        self._tuners: Dict[str, object] = dict(tuners or {})
        self._tuner_factory = tuner_factory or _default_tuner_factory
        # attach lazily: a worker may start before any coordinator has
        # created the bus, and idles until the manifest appears
        self._manifest: Optional[Dict] = None
        self.shard: Optional[RecordStore] = None
        self.report = WorkerReport(worker_id=self.worker_id)

    def _ensure_attached(self) -> bool:
        """Bind to the bus once its manifest exists."""
        if self.shard is not None:
            return True
        try:
            self._manifest = self.fleet.manifest()
        except FileNotFoundError:
            return False
        # no fsync a record: the append reaches the kernel before the done
        # marker is written, and a lost host is lease expiry's case
        self.shard = RecordStore(self.fleet.shard_path(self.worker_id),
                                 fsync=False)
        return True

    def _tuner_for(self, space: str):
        tuner = self._tuners.get(space)
        if tuner is None:
            tuner = self._tuners[space] = self._tuner_factory(space)
        return tuner

    # -- one job ---------------------------------------------------------------
    def _tune_job(self, job: FleetJob, lease_path) -> TuneRecord:
        """Run the tuner under a live heartbeat; commit to the shard."""
        stop = threading.Event()

        def beat():
            while not stop.wait(self.heartbeat_s):
                if not self.fleet.heartbeat(lease_path):
                    return               # reclaimed: stop beating
        t = threading.Thread(target=beat, daemon=True)
        t.start()
        try:
            tuner = self._tuner_for(job.space)
            result = tuner.search(job.inputs, remeasure=self.remeasure)
        finally:
            stop.set()
            t.join()
        rec = record_from_search(job.space, job.inputs, result,
                                 tuner.backend, source=job.source)
        # kill-point: tuned, nothing written yet: a crash here loses only
        # work that lease expiry queues again
        io = chaos._IO
        if io is not None:
            io.probe("worker.tuned")
        self.shard.add(rec)
        if io is not None:
            # kill-point: the record is in the shard, no done marker yet:
            # the job runs again and the merge's newest-wins index absorbs
            # the second record
            io.probe("worker.appended")
        if self.collect_samples and result.measured:
            for cfg, tflops in result.measured:
                if cfg == result.best:
                    continue
                self.shard.add(TuneRecord(
                    space=job.space, inputs=dict(job.inputs),
                    config=dict(cfg), tflops=float(tflops),
                    backend=rec.backend, source=SAMPLE_SOURCE))
        return rec

    def run_one(self) -> Optional[bool]:
        """Claim and run one job.  None: nothing to claim.  True: tuned and
        marked done.  False: the job failed (requeued or buried) or its
        lease was reclaimed meanwhile (the shard's records still count)."""
        if not self._ensure_attached():
            return None
        claimed = self.fleet.claim()
        if claimed is None:
            return None
        job, lease_path = claimed
        self.report.claimed += 1
        # kill-point: claimed, nothing done: a crashed worker's case, which
        # lease expiry and a requeue recover
        io = chaos._IO
        if io is not None:
            io.probe("worker.claimed")
        t0 = time.time()
        tr = _trace._TRACER             # None: untraced, no instrument call
        # the coordinator's trace id from the job file: the tuning shows up
        # under its submit-to-swap window in the merged trace
        ctx = (tr.root("fleet.job", trace_id=job.trace_id or None,
                       space=job.space, job=job.job_id,
                       worker=self.worker_id)
               if tr is not None else _NULL_CTX)
        with ctx as sp:
            try:
                rec = self._tune_job(job, lease_path)
            except Exception as e:  # noqa: BLE001 — one job fails alone
                err = f"{type(e).__name__}: {e}"
                outcome = self.fleet.fail(
                    job, lease_path, err,
                    max_attempts=int(self._manifest.get("max_attempts", 3)))
                self.report.failed += 1
                self.report.errors.append(f"{job.job_id}: {err} ({outcome})")
                self._count_outcome("failed")
                if sp is not None:
                    sp.attrs["outcome"] = "failed"
                return False
            if sp is not None:
                sp.attrs["outcome"] = "tuned"
                sp.attrs["tflops"] = round(float(rec.tflops), 3)
        if io is not None:
            # kill-point: between the shard append and the done marker
            io.probe("worker.complete")
        ok = self.fleet.complete(job, lease_path, {
            "worker_id": self.worker_id, "tflops": rec.tflops,
            "backend": rec.backend, "wall_s": round(time.time() - t0, 4),
            "trace_id": job.trace_id})
        if ok:
            self.report.tuned += 1
            if self.verbose:
                print(f"[fleet:{self.worker_id}] {job.space} {job.inputs} "
                      f"-> {rec.tflops:.1f} TFLOPS", flush=True)
        else:
            self.report.lost += 1
        self._count_outcome("tuned" if ok else "lost")
        return ok

    @staticmethod
    def _count_outcome(outcome: str) -> None:
        """This process's finished jobs in ``tunedb_worker_jobs_total``."""
        get_registry().counter(
            "tunedb_worker_jobs_total",
            "fleet jobs finished by workers in this process").inc(
                outcome=outcome)

    # -- the loop --------------------------------------------------------------
    def run(self, *, max_jobs: Optional[int] = None,
            idle_timeout_s: Optional[float] = None) -> WorkerReport:
        """Work until drained (``DRAIN`` and an empty queue), ``max_jobs``
        claims are made, or the queue stays empty for ``idle_timeout_s``."""
        t0 = time.time()
        if self.telemetry_export_s > 0 and self.exporter is None:
            self.exporter = TelemetryExporter(
                get_telemetry(), self.fleet.telemetry_dir(),
                worker_id=self.worker_id,
                interval_s=self.telemetry_export_s).start()
        idle_since: Optional[float] = None
        while True:
            if max_jobs is not None and self.report.claimed >= max_jobs:
                break
            if self.run_one() is not None:
                idle_since = None
                continue
            if self.fleet.draining():
                break
            now = time.time()
            if idle_since is None:
                idle_since = now
            if (idle_timeout_s is not None
                    and now - idle_since >= idle_timeout_s):
                break
            time.sleep(self.poll_s)
        if self.exporter is not None:
            self.exporter.stop()         # the final dump lands the tail
            self.exporter = None
        if self.trace_export:
            self._export_spans()
        self.report.wall_s = time.time() - t0
        return self.report

    def _export_spans(self) -> int:
        """Append this process's finished spans to the bus."""
        tr = _trace._TRACER
        if tr is None:
            return 0
        return tr.export_jsonl(self.fleet.root / _trace.FLEET_TRACE_DIR
                               / f"{self.worker_id}.jsonl")
