"""Tuning sessions: mine hot shapes, tune them on a worker pool, commit.

The port of ``repro.tunedb.session``.  The jobs are explicit shapes, or
the top ``top_k_shapes`` of a :class:`~repro_torch.tunedb.telemetry.
ShapeTelemetry` (``hot_shapes``: the shapes traffic hit most).  One
:class:`TuneJob` per shape runs the tuner's §6 search — with top-k
re-measurement on the backend — and appends one :class:`TuneRecord` per
shape, stamped with the session's ``source`` (the retune controller's is
``"retune"``), plus, with ``collect_samples``, the measured top-k losers as
``source="sample"`` records (training data for a performance model;
serving never resolves them).  A ``progress_path`` file (``{"space",
"done"}``, written through a ``.tmp`` file and ``os.replace``) makes a
long session resumable: a rerun skips the shapes it lists.

:func:`backend_fingerprint` is the one place that names a measuring
backend.  The tuner stamps it on every record and serving pins its lookups
to it, so the two always agree: a port record names the package, the
backend class and the device, and never collides with a record of the
reference's backends.  The operand values a timing backend draws are not
part of it: they do not change what a config measures.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Mapping, Optional, Tuple

from .store import (SAMPLE_SOURCE, RecordStore, TuneRecord, input_key,
                    normalize_inputs)
from .telemetry import ShapeTelemetry

# fields of a backend that change what it measures, in fingerprint order
# (a simulator's noise and its seed; the port's timing backend has none)
_FINGERPRINT_FIELDS = ("noise", "seed", "warmup", "reps", "iters")


def backend_fingerprint(backend) -> str:
    """Stable id of the measuring backend, recorded with every result.

    ``<package>.<class>/device=<name>/<field>=<value>...``; a gate that
    wraps a timing backend (``CheckedBackend``) names the backend it wraps,
    whose timings it returns.
    """
    timer = getattr(backend, "timer", None)
    if timer is not None:
        return backend_fingerprint(timer)
    cls = type(backend)
    parts = [f"{cls.__module__.split('.')[0]}.{cls.__name__}"]
    device = getattr(backend, "device_name", None)
    if device is not None:
        parts.append(f"device={device}")
    for field in _FINGERPRINT_FIELDS:
        v = getattr(backend, field, None)
        if v is not None and not callable(v):
            parts.append(f"{field}={v}")
    return "/".join(parts)


def record_from_search(space: str, inputs: Mapping[str, int], result,
                       backend, source: str) -> TuneRecord:
    """The TuneRecord for one SearchResult: measured TFLOPS when the top-k
    was re-measured (else predicted), the backend's latency for the winner,
    and the backend's fingerprint."""
    tflops = (result.measured_tflops if result.measured_tflops is not None
              else result.predicted_tflops)
    config = dict(result.best)
    latency = None
    time_us = getattr(backend, "time_us", None)
    if callable(time_us):
        latency = float(time_us(space, config, inputs))
    return TuneRecord(
        space=space, inputs=dict(inputs), config=config,
        tflops=float(tflops), latency_us=latency,
        backend=backend_fingerprint(backend), source=source)


@dataclasses.dataclass(frozen=True)
class TuneJob:
    """One unit of session work: tune one input shape."""

    space: str
    inputs: Dict[str, int]
    count: int = 0                      # telemetry frequency (priority)

    @property
    def key(self) -> str:
        return input_key(self.space, self.inputs)


@dataclasses.dataclass
class SessionReport:
    space: str
    jobs: int
    tuned: int
    skipped: int
    failed: int
    wall_s: float
    records: List[TuneRecord] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)


class TuningSession:
    """Drive the tuner over explicit or telemetry-mined shapes into a store.

    Jobs run on ``workers`` threads; the backend serialises the
    measurements themselves (one kernel on the card at a time), so the
    threads overlap the host-side search, not the timing.  A job that
    raises is counted in ``SessionReport.failed`` with its error, and the
    other jobs go on: the caller reads the report.  When the jobs are done
    the backend's ``release`` (where it has one) drops what it kept for
    them: ``CheckedBackend``'s cached gate oracles, and its timer's
    operand sets and timing log.
    """

    def __init__(self, tuner, store: RecordStore,
                 telemetry: Optional[ShapeTelemetry] = None, *,
                 top_k_shapes: int = 8, workers: int = 4,
                 remeasure: bool = True, skip_existing: bool = True,
                 collect_samples: bool = True,
                 progress_path: Optional[os.PathLike] = None,
                 source: str = "session"):
        self.tuner = tuner
        self.store = store
        self.telemetry = telemetry
        self.top_k_shapes = top_k_shapes
        self.workers = max(1, workers)
        self.remeasure = remeasure
        self.skip_existing = skip_existing
        self.collect_samples = collect_samples
        self.source = source
        self.progress_path = (pathlib.Path(progress_path)
                              if progress_path else None)
        self._done = self._load_progress()

    # -- resumability ---------------------------------------------------------
    def _load_progress(self) -> set:
        if self.progress_path is None or not self.progress_path.exists():
            return set()
        try:
            return set(json.loads(self.progress_path.read_text())["done"])
        except (ValueError, KeyError, TypeError):
            return set()

    def _save_progress(self) -> None:
        if self.progress_path is None:
            return
        self.progress_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.progress_path.with_name(self.progress_path.name + ".tmp")
        tmp.write_text(json.dumps({"space": self.tuner.space.name,
                                   "done": sorted(self._done)}))
        os.replace(tmp, self.progress_path)

    # -- planning -------------------------------------------------------------
    def plan(self, shapes: Optional[List[Mapping[str, int]]] = None
             ) -> Tuple[List[TuneJob], int]:
        """Build the job list; returns (jobs, n_skipped).  ``shapes``
        overrides the telemetry's hot shapes.  Skipping is
        fingerprint-scoped: a shape tuned by another backend still needs a
        record from this one; a shape the progress file lists is done."""
        space = self.tuner.space.name
        if shapes is not None:
            cand = [(normalize_inputs(s), 0) for s in shapes]
        elif self.telemetry is not None:
            cand = self.telemetry.hot_shapes(space, self.top_k_shapes)
        else:
            raise ValueError("need telemetry or explicit shapes to plan")
        fp = backend_fingerprint(self.tuner.backend)
        jobs, skipped, seen = [], 0, set()
        for inputs, count in cand:
            job = TuneJob(space=space, inputs=dict(inputs), count=count)
            if job.key in seen or job.key in self._done or (
                    self.skip_existing and self.store.contains(
                        space, inputs, backend=fp)):
                skipped += 1
                continue
            seen.add(job.key)
            jobs.append(job)
        return jobs, skipped

    def _run_job(self, job: TuneJob) -> Tuple[TuneRecord, List[TuneRecord]]:
        result = self.tuner.search(job.inputs, remeasure=self.remeasure)
        rec = record_from_search(job.space, job.inputs, result,
                                 self.tuner.backend, source=self.source)
        samples: List[TuneRecord] = []
        if self.collect_samples:
            samples = [TuneRecord(space=job.space, inputs=dict(job.inputs),
                                  config=dict(cfg), tflops=float(tflops),
                                  backend=rec.backend, source=SAMPLE_SOURCE)
                       for cfg, tflops in result.measured or ()
                       if cfg != result.best]
        return rec, samples

    def _guarded(self, job: TuneJob):
        try:
            return self._run_job(job), None
        except Exception as e:       # noqa: BLE001 — job isolation is the point
            return None, f"{type(e).__name__}: {e}"

    def run(self, shapes: Optional[List[Mapping[str, int]]] = None,
            verbose: bool = False) -> SessionReport:
        t0 = time.time()
        jobs, skipped = self.plan(shapes)
        report = SessionReport(space=self.tuner.space.name, jobs=len(jobs),
                               tuned=0, skipped=skipped, failed=0, wall_s=0.0)
        if jobs:
            # commit each result the moment it lands: a crash mid-session
            # must not discard jobs that already finished
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                futures = {pool.submit(self._guarded, j): j for j in jobs}
                for fut in as_completed(futures):
                    job = futures[fut]
                    out, err = fut.result()
                    if err is not None:
                        report.failed += 1
                        report.errors.append(f"{job.inputs}: {err}")
                        continue
                    rec, samples = out
                    self.store.add(rec)
                    for sample in samples:
                        self.store.add(sample)
                    self._done.add(job.key)
                    self._save_progress()
                    report.tuned += 1
                    report.records.append(rec)
                    if verbose:
                        print(f"[session:{job.space}] {job.inputs} -> "
                              f"{rec.config} {rec.tflops:.3f} TFLOPS")
        release = getattr(self.tuner.backend, "release", None)
        if release is not None:     # the gate's cases, the timer's operands
            release()
        report.wall_s = time.time() - t0
        return report
