"""The port's tuning fleet (``repro_torch.tunedb.fleet``) against the JAX
package's ``repro.tunedb.fleet``, on the CPU.

The same operations on the same inputs in both packages, with one stub
tuner (deterministic configs and TFLOP/s, as the reference's own fleet
tests use; the fleet is about coordination, not search): equal job ids,
job files, manifests, cursors and claim order; the same file tree after
the same publish / claim / heartbeat / expiry / fail / drain sequence
(timestamps and worker ids aside); the same merged store, sentry
refusals included; the controller's fleet epoch swapping only after the
merge; a SmolLM SMOKE engine with ``retune_fleet`` and a thread worker
whose greedy tokens equal the JAX engine's before and after the swap;
and the CLI's ``fleet start --workers`` starting port workers.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import types
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.tunedb.controller as jcontroller
import repro.tunedb.fleet as jfleet
import repro.tunedb.obs.metrics as jmetrics
import repro.tunedb.store as jstore
import repro.tunedb.telemetry as jtel
from repro.configs import smollm_135m as jconfigs
from repro.models import init_params as jinit_params
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.core.space import gemm_input
from repro_torch.serve import Engine, ServeConfig
from repro_torch.tunedb import controller as tcontroller
from repro_torch.tunedb import fleet as tfleet
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb import telemetry as ttel
from repro_torch.tunedb.__main__ import main as tcli_main
from repro_torch.tunedb.obs.metrics import reset_metrics
from repro_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
CFG = {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
       "order": 0, "acc32": 1, "prefetch": 2}

JAX = types.SimpleNamespace(
    fleet=jfleet, store=jstore, tel=jtel, controller=jcontroller,
    lease=jfleet.lease)
PORT = types.SimpleNamespace(
    fleet=tfleet, store=tstore, tel=ttel, controller=tcontroller,
    lease=tfleet.lease)
BOTH = [JAX, PORT]
# fields that differ run to run: times, process-made ids, error texts with
# ages in them
VOLATILE = {"created_at", "finished_at", "failed_at", "updated_at",
            "worker_id", "error", "wall_s"}


def _reset():
    tstore.install_serving(store=None, models=None, fingerprint=None)
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    ttel.clear_telemetry()
    jtel.clear_telemetry()
    reset_metrics()
    jmetrics.reset_metrics()


@pytest.fixture(autouse=True)
def _clean_globals():
    _reset()
    yield
    _reset()


class StubBackend:
    noise = 0.0


class StubTuner:
    """A deterministic, instant tuner usable by both packages' workers:
    the best config is CFG at a TFLOP/s derived from the shape (plus
    ``n_measured`` losers, which become sample records)."""

    def __init__(self, n_measured: int = 0, fail: bool = False,
                 delay_s: float = 0.0, tflops_scale: float = 1.0,
                 space: str = "gemm"):
        self.space = types.SimpleNamespace(name=space)
        self.backend = StubBackend()
        self.n_measured = n_measured
        self.fail = fail
        self.delay_s = delay_s
        self.tflops_scale = tflops_scale
        self.calls = 0

    def search(self, inputs, remeasure=True):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("synthetic tuner failure")
        tf = self.tflops_scale * (1.0 + (inputs["M"] * inputs["N"]
                                         + inputs["K"]) % 997 / 10.0)
        measured = [(dict(CFG), tf)]
        for j in range(self.n_measured):
            measured.append((dict(CFG, bm=(16, 32, 128)[j % 3]),
                             tf / (2 + j)))
        return types.SimpleNamespace(best=dict(CFG), predicted_tflops=tf,
                                     measured_tflops=tf, measured=measured)


def _shape(i: int):
    return gemm_input(256 * (i + 1), 64, 512)


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in VOLATILE}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _tree(root: Path) -> dict:
    """Every file under ``root``: relative path -> parsed JSON (volatile
    fields removed) or its raw text."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            text = p.read_text()
            try:
                out[str(p.relative_to(root))] = _strip(json.loads(text))
            except ValueError:
                out[str(p.relative_to(root))] = text
    return out


def _records(store):
    """A store's whole log, backend fingerprints (package-named) left out."""
    return sorted((r.space, sorted(r.inputs.items()),
                   sorted(r.config.items()), round(r.tflops, 9), r.source,
                   r.merged_from) for r in store.training_records())


# ---------------------------------------------------------------------------
# the lease protocol
# ---------------------------------------------------------------------------

JOBS = [("gemm", gemm_input(4, 576, 576), 7),
        ("gemm", gemm_input(32, 1536, 576), 0),
        ("attention", {"B": 4, "Hq": 9, "Hkv": 3, "Lq": 1, "Lkv": 256,
                       "D": 64, "causal": 1, "dtype_bits": 16}, 3)]


@pytest.mark.parametrize("space,inputs,count", JOBS)
def test_job_ids_and_files_match_the_reference(space, inputs, count):
    jjob = jfleet.FleetJob(space=space, inputs=inputs, count=count,
                           source="retune", created_at=12.5, trace_id="ab")
    tjob = tfleet.FleetJob(space=space, inputs=inputs, count=count,
                           source="retune", created_at=12.5, trace_id="ab")
    assert tfleet.job_id_for(space, inputs) == jfleet.job_id_for(space,
                                                                  inputs)
    assert tjob.job_id == jjob.job_id
    assert tjob.to_json() == jjob.to_json()
    # each package reads the other's job file
    assert tfleet.FleetJob.from_json(jjob.to_json()) == tjob
    assert jfleet.FleetJob.from_json(tjob.to_json()) == jjob
    with pytest.raises(ValueError, match="schema"):
        tfleet.FleetJob.from_json(json.dumps(
            {**json.loads(tjob.to_json()), "schema_version": 2}))


def test_manifest_layout_and_claim_order_match(tmp_path):
    orders, manifests = [], []
    for pkg in BOTH:
        root = tmp_path / pkg.fleet.__name__
        fd = pkg.fleet.FleetDir(root / "fleet")
        manifests.append(_strip(fd.init(tmp_path / "db.jsonl",
                                        lease_timeout_s=5, max_attempts=4)))
        for i, count in enumerate((1, 50, 5, 50, 0)):
            assert fd.publish(pkg.fleet.FleetJob(space="gemm",
                                                 inputs=_shape(i),
                                                 count=count))
        order = []
        while (got := fd.claim()) is not None:
            order.append(got[0].job_id)
        orders.append(order)
        assert fd.shard_path("w").name == "w.jsonl"
        assert fd.shard_dir().name == "db.jsonl.shards"
    assert orders[0] == orders[1] and len(orders[1]) == 5
    assert manifests[0] == manifests[1]
    assert manifests[1]["store"] == str((tmp_path / "db.jsonl").resolve())


def _lifecycle(pkg, root: Path) -> dict:
    """publish -> claim -> heartbeat -> expiry -> requeue -> fail ->
    complete -> drain, on one fleet directory; returns the counts seen."""
    fd = pkg.fleet.FleetDir(root)
    fd.init(root.parent / "db.jsonl", lease_timeout_s=0.05, max_attempts=2)
    seen = {}
    jobs = [pkg.fleet.FleetJob(space="gemm", inputs=_shape(i), count=10 - i,
                               trace_id=f"t{i}") for i in range(4)]
    assert [fd.publish(j) for j in jobs] == [True] * 4
    assert not fd.publish(jobs[0])                  # queued: known
    job, lease = fd.claim()
    assert fd.heartbeat(lease)
    old = time.time() - 10
    os.utime(lease, (old, old))                     # a crashed worker
    seen["reclaimed"] = fd.reclaim_expired(lease_timeout_s=0.05,
                                           max_attempts=2)
    assert not fd.heartbeat(lease)                  # the zombie learns
    job, lease = fd.claim()                         # attempt 2
    assert job.attempts == 1
    seen["fail"] = fd.fail(job, lease, "boom", max_attempts=2)
    job, lease = fd.claim()
    seen["complete"] = fd.complete(job, lease, {"worker_id": "w",
                                                "tflops": 1.0})
    seen["again"] = fd.complete(job, lease, {"worker_id": "w"})
    job, lease = fd.claim()
    seen["requeue"] = fd.fail(job, lease, "boom", max_attempts=2)
    assert fd.publish(jobs[0], force=True)          # buried, forced back
    fd.request_drain()
    seen["draining"] = fd.draining()
    seen["counts"] = fd.counts()
    seen["outstanding"] = fd.outstanding()
    seen["done"] = _strip(fd.done_meta())
    seen["swept"] = fd.sweep_done()
    return seen


def test_file_tree_after_the_same_sequence_matches(tmp_path):
    trees, seen = [], []
    for pkg in BOTH:
        root = tmp_path / pkg.fleet.__name__ / "fleet"
        root.parent.mkdir()
        seen.append(_lifecycle(pkg, root))
        trees.append(_tree(root))
    assert seen[1] == seen[0]
    assert seen[1]["counts"] == {"queue": 3, "leases": 0, "done": 1,
                                 "failed": 0}
    # the manifests name each package's own store path: compare the rest
    for tree in trees:
        tree["manifest.json"].pop("store")
    assert trees[1] == trees[0]
    assert "DRAIN" in trees[1]


def test_stale_queue_wait_does_not_expire_a_fresh_claim(tmp_path):
    fd = tfleet.FleetDir(tmp_path / "fleet")
    fd.init(tmp_path / "db.jsonl", lease_timeout_s=0.2)
    fd.publish(tfleet.FleetJob(space="gemm", inputs=_shape(0)))
    old = time.time() - 10
    os.utime(fd.queue / f"{tfleet.job_id_for('gemm', _shape(0))}.json",
             (old, old))                            # queued for long
    job, lease = fd.claim()
    assert fd.reclaim_expired(lease_timeout_s=0.2, max_attempts=3) == []
    assert fd.heartbeat(lease)


def test_two_racers_one_lease_single_winner(tmp_path):
    fd = tfleet.FleetDir(tmp_path / "fleet")
    fd.init(tmp_path / "db.jsonl")
    for i in range(10):
        fd.publish(tfleet.FleetJob(space="gemm", inputs=_shape(i)))
        barrier = threading.Barrier(2)
        wins = []

        def race():
            barrier.wait()
            got = fd.claim()
            if got is not None:
                wins.append(got)
        threads = [threading.Thread(target=race) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1, f"round {i}: {len(wins)} winners"
        fd.complete(wins[0][0], wins[0][1], {"worker_id": "racer"})


# ---------------------------------------------------------------------------
# the coordinator's merge
# ---------------------------------------------------------------------------

def _shard_lines(pkg):
    """A shard's records: a served record, its samples, a slower re-tune
    of an already served shape (the sentry's case), a faster one."""
    R = pkg.store.TuneRecord
    recs = [R(space="gemm", inputs=_shape(0), config=dict(CFG),
              tflops=100.0, backend="bk", source="fleet", created_at=10.0),
            R(space="gemm", inputs=_shape(0), config=dict(CFG, bm=32),
              tflops=40.0, backend="bk", source="sample", created_at=10.5),
            R(space="gemm", inputs=_shape(1), config=dict(CFG, bm=16),
              tflops=50.0, backend="bk", source="retune", created_at=11.0),
            R(space="gemm", inputs=_shape(2), config=dict(CFG, bm=128),
              tflops=95.0, backend="bk", source="retune", created_at=12.0)]
    return "".join(r.to_json() + "\n" for r in recs)


def _merge(pkg, tmp: Path, margin, torn: bool = False):
    store = pkg.store.RecordStore.open(tmp / "db.jsonl")
    R = pkg.store.TuneRecord
    # already served: shape 1 at 100 (a 50 re-tune regresses), shape 2 at
    # 90 (a 95 re-tune improves)
    store.add(R(space="gemm", inputs=_shape(1), config=dict(CFG),
                tflops=100.0, backend="bk", created_at=1.0))
    store.add(R(space="gemm", inputs=_shape(2), config=dict(CFG),
                tflops=90.0, backend="bk", created_at=1.0))
    coord = pkg.fleet.Coordinator(tmp / "fleet", store, sentry_margin=margin)
    shard = coord.fleet.shard_path("w7")
    shard.parent.mkdir(parents=True, exist_ok=True)
    text = _shard_lines(pkg)
    if torn:
        cut = text.rindex("{")
        shard.write_text(text[:cut + 20])           # a half-written line
        first = coord.merge_completed()
        with shard.open("w") as fh:
            fh.write(text)
    else:
        shard.write_text(text)
        first = None
    got = coord.merge_completed()
    again = coord.merge_completed()                 # the cursor holds
    cursor = json.loads((tmp / "fleet" / "merged" / "w7.json").read_text())
    return {"first": first, "merged": got, "again": again,
            "records": _records(pkg.store.RecordStore.open(tmp / "db.jsonl")),
            "sentry_blocked": coord.sentry_blocked,
            "affected": sorted(coord.affected),
            "cursor": _strip(cursor),
            "served": sorted((sorted(r.inputs.items()), r.tflops)
                             for r in store.records())}


@pytest.mark.parametrize("margin", [None, 0.10])
@pytest.mark.parametrize("torn", [False, True])
def test_merge_matches_the_reference(tmp_path, margin, torn):
    out = []
    for pkg in BOTH:
        tmp = tmp_path / pkg.fleet.__name__
        tmp.mkdir()
        out.append(_merge(pkg, tmp, margin, torn))
    assert out[1] == out[0]
    merged = out[1]
    assert merged["sentry_blocked"] == (0 if margin is None else 1)
    assert merged["again"] == (0, 0)
    assert merged["cursor"]["merged"] == 4
    if torn:
        assert merged["first"] == (2 if margin is None else 1, 1)
    assert all(r[5] == "w7" for r in merged["records"] if r[4] != "tuner")


def test_merge_reads_only_complete_lines_of_a_live_shard(tmp_path):
    """A worker appending while the coordinator merges: a line without its
    newline waits, and the cursor never moves past what reached the
    store."""
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    shard = coord.fleet.shard_path("w1")
    shard.parent.mkdir(parents=True, exist_ok=True)
    lines = _shard_lines(PORT).splitlines(keepends=True)
    with shard.open("w") as fh:
        for line in lines:
            fh.write(line[:-7])
            fh.flush()
            before = len(store.training_records())
            coord.merge_completed()
            assert len(store.training_records()) == before
            cur = coord._cursor("w1")
            assert cur[1] <= shard.stat().st_size - len(line[:-7])
            fh.write(line[-7:])
            fh.flush()
            coord.merge_completed()
            assert len(store.training_records()) == before + 1
    assert coord._cursor("w1") == (4, shard.stat().st_size)


def test_coordinator_refuses_a_store_without_a_file_or_another_store(
        tmp_path):
    with pytest.raises(ValueError, match="disk-backed"):
        tfleet.Coordinator(tmp_path / "fleet", tstore.RecordStore())
    tfleet.Coordinator(tmp_path / "fleet",
                       tstore.RecordStore.open(tmp_path / "db.jsonl"))
    for pkg in BOTH:
        with pytest.raises(ValueError, match="was created for store"):
            pkg.fleet.Coordinator(tmp_path / "fleet", pkg.store.RecordStore
                                  .open(tmp_path / "other.jsonl"))


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def test_inline_fleet_matches_the_reference(tmp_path):
    """Six jobs, three thread workers, three samples a job, in both
    packages: the same report and the same merged store (configs,
    TFLOP/s, sources; each record merged from one of the workers)."""
    out = []
    for pkg in BOTH:
        tmp = tmp_path / pkg.fleet.__name__
        store = pkg.store.RecordStore.open(tmp / "db.jsonl")
        rep = pkg.fleet.run_fleet_inline(
            tmp / "fleet", store,
            [pkg.fleet.FleetJob(space="gemm", inputs=_shape(i), count=i)
             for i in range(6)],
            n_workers=3, tuners={"gemm": StubTuner(n_measured=3)})
        fresh = pkg.store.RecordStore.open(tmp / "db.jsonl")
        out.append((_strip(dataclasses.asdict(rep)),
                    [r[:5] for r in _records(fresh)],
                    {r.merged_from for r in fresh.training_records()}))
    (jrep, jrecs, jfrom), (trep, trecs, tfrom) = out
    jrep.pop("workers"), trep.pop("workers")
    jrep.pop("jobs_per_s"), trep.pop("jobs_per_s")
    assert trep == jrep
    assert trep["done"] == 6 and trep["merged_samples"] == 18
    assert trecs == jrecs
    assert tfrom <= {"w0", "w1", "w2"} and tfrom


def test_worker_crash_requeues_without_a_duplicate(tmp_path):
    out = []
    for pkg in BOTH:
        tmp = tmp_path / pkg.fleet.__name__
        store = pkg.store.RecordStore.open(tmp / "db.jsonl")
        coord = pkg.fleet.Coordinator(tmp / "fleet", store,
                                      lease_timeout_s=0.05)
        coord.publish([pkg.fleet.FleetJob(space="gemm", inputs=_shape(3))])
        _job, lease = coord.fleet.claim()       # claimed, then the worker dies
        old = time.time() - 10
        os.utime(lease, (old, old))
        status = coord.poll()
        w2 = pkg.fleet.Worker(tmp / "fleet", worker_id="w2",
                              tuners={"gemm": StubTuner()}, poll_s=0.01)
        assert w2.run_one() is True
        assert w2.run_one() is None
        coord.poll()
        coord.poll()
        out.append((status["reclaimed"], coord.requeued,
                    _records(store), _strip(dataclasses.asdict(w2.report))))
    assert out[1] == out[0]
    assert len(out[1][2]) == 1 and out[1][2][0][5] == "w2"


def test_worker_failure_requeues_then_buries(tmp_path):
    out = []
    for pkg in BOTH:
        tmp = tmp_path / pkg.fleet.__name__
        store = pkg.store.RecordStore.open(tmp / "db.jsonl")
        coord = pkg.fleet.Coordinator(tmp / "fleet", store, max_attempts=2)
        coord.publish([pkg.fleet.FleetJob(space="gemm", inputs=_shape(0))])
        bad = pkg.fleet.Worker(tmp / "fleet", worker_id="bad",
                               tuners={"gemm": StubTuner(fail=True)})
        steps = [bad.run_one(), coord.fleet.counts(), bad.run_one(),
                 coord.fleet.counts()]
        out.append((steps, bad.report.errors, len(store.training_records())))
    assert out[1] == out[0]
    assert out[1][0][3]["failed"] == 1


def test_coordinator_restart_resumes_from_the_cursors(tmp_path):
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    jobs = [tfleet.FleetJob(space="gemm", inputs=_shape(i)) for i in range(3)]
    coord.publish(jobs)
    w = tfleet.Worker(tmp_path / "fleet", worker_id="w1",
                      tuners={"gemm": StubTuner()}, poll_s=0.01)
    assert w.run_one() is True
    coord.poll()
    coord2 = tfleet.Coordinator(tmp_path / "fleet")     # the restart
    assert coord2.store.path == store.path
    assert coord2.publish(jobs) == 0
    while w.run_one() is not None:
        pass
    coord2.poll()
    fresh = tstore.RecordStore.open(tmp_path / "db.jsonl")
    assert len(fresh) == 3 and len(fresh.training_records()) == 3


def test_worker_before_the_bus_idles_then_attaches(tmp_path):
    w = tfleet.Worker(tmp_path / "fleet", worker_id="early",
                      tuners={"gemm": StubTuner()}, poll_s=0.01)
    assert w.run_one() is None
    assert w.run(idle_timeout_s=0.05).claimed == 0
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=_shape(0))])
    assert w.run_one() is True
    coord.poll()
    assert store.contains("gemm", _shape(0))
    assert store.get("gemm", _shape(0)).merged_from == "early"


def test_compact_archives_merged_shards(tmp_path):
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=_shape(i))
                   for i in range(2)])
    worker = tfleet.Worker(tmp_path / "fleet", worker_id="w0",
                           tuners={"gemm": StubTuner(n_measured=2)})
    assert worker.run_one() and worker.run_one()
    assert coord.compact_shards() == []            # nothing merged yet
    coord.poll()
    assert coord.compact_shards() == ["w0"]
    assert (coord.fleet.shard_dir() / "archive" / "w0.jsonl").exists()
    coord.publish([tfleet.FleetJob(space="gemm", inputs=_shape(2))])
    worker2 = tfleet.Worker(tmp_path / "fleet", worker_id="w0",
                            tuners={"gemm": StubTuner()})
    assert worker2.run_one()
    coord.poll()
    assert len(store) == 3


def test_store_sync_and_unsynced_shard(tmp_path):
    store = tstore.RecordStore(tmp_path / "s.jsonl", fsync=False)
    assert store.fsync is False
    store.add(tstore.TuneRecord(space="gemm", inputs=_shape(0),
                                config=dict(CFG), tflops=1.0))
    store.sync()
    assert len(tstore.RecordStore.open(tmp_path / "s.jsonl")) == 1
    tstore.RecordStore().sync()                     # in memory: a no-op


# ---------------------------------------------------------------------------
# the controller's fleet epoch
# ---------------------------------------------------------------------------

def _drive(tel, inputs, n=40):
    for _ in range(n):
        tel.record("gemm", inputs)


def test_fleet_retune_swaps_only_after_the_merge(tmp_path):
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    tstore.install_serving(store=store)
    fleet_dir = tmp_path / "fleet"
    ctl = tcontroller.RetuneController(
        store, fleet_dir=fleet_dir, fleet_poll_s=0.02, fleet_timeout_s=30,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1,
                                     retrain=False))
    _drive(ttel.get_telemetry(), _shape(0))
    gen0 = tstore.serving_state().generation
    assert ctl.maybe_retune() is None
    deadline = time.time() + 5
    while not (fleet_dir / "manifest.json").exists() \
            and time.time() < deadline:
        time.sleep(0.02)
    time.sleep(0.2)
    assert ctl.async_active() and tstore.serving_state().generation == gen0
    job = json.loads(next((fleet_dir / "queue").glob("*.json")).read_text())
    assert job["count"] == 40 and job["source"] == "retune"
    worker = tfleet.Worker(fleet_dir, worker_id="w1",
                           tuners={"gemm": StubTuner()}, poll_s=0.01)
    worker.run(idle_timeout_s=1.0)
    report = ctl.wait_async(timeout=30)
    assert report is not None and report.mode == "fleet" and report.tuned == 1
    assert tstore.serving_state().generation == gen0 + 1
    rec = store.get("gemm", _shape(0))
    assert rec.source == "retune" and rec.merged_from == "w1"
    assert json.loads((fleet_dir / "report.json").read_text())["done"] == 1
    assert ctl.stats()["async"]["fleet_dir"] == str(fleet_dir)
    assert ctl.maybe_retune() is None               # the shape was attempted


def test_fleet_retune_refuses_a_store_without_a_file():
    store = tstore.RecordStore()
    tstore.install_serving(store=store)
    ctl = tcontroller.RetuneController(
        store, fleet_dir="/nonexistent-fleet",
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1,
                                     retrain=False),
        tuners={"gemm": StubTuner()})
    _drive(ttel.get_telemetry(), _shape(0))
    with pytest.warns(RuntimeWarning, match="disk-backed"):
        ctl.maybe_retune()
    report = ctl.wait_async(timeout=30)             # in-process instead
    assert report is not None and report.tuned == 1
    assert report.mode == "async"


def test_fleet_epoch_timeout_publishes_what_landed(tmp_path):
    """No worker: the epoch times out, swaps nothing, and its shape counts
    as novel again (the reference's straggler rule)."""
    out = []
    for pkg in BOTH:
        tmp = tmp_path / pkg.fleet.__name__
        store = pkg.store.RecordStore.open(tmp / "db.jsonl")
        ctl = pkg.controller.RetuneController(
            store, tuners={"gemm": StubTuner()}, fleet_dir=tmp / "fleet",
            fleet_timeout_s=0.2, fleet_poll_s=0.02,
            cfg=pkg.controller.RetuneConfig(min_calls=8, top_k_shapes=2))
        _drive(pkg.tel.get_telemetry(), _shape(0))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ctl.maybe_retune()
            rep = ctl.wait_async(timeout=30)
        out.append((rep.mode, rep.tuned, rep.generation > 0,
                    sorted(p.name for p in (tmp / "fleet" / "queue")
                           .glob("*.json")), ctl._attempted))
    assert out[1] == out[0]
    assert out[1][:2] == ("fleet", 0) and out[1][3] and not out[1][4]


def test_controller_publishes_each_swap_to_a_registry(tmp_path):
    from repro_torch.tunedb.plans import PlanRegistry
    store = tstore.RecordStore()
    tstore.install_serving(store=store)
    ctl = tcontroller.RetuneController(
        store, tuners={"gemm": StubTuner()},
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1,
                                     retrain=False,
                                     publish=str(tmp_path / "reg")))
    _drive(ttel.get_telemetry(), _shape(0))
    report = ctl.maybe_retune()
    assert report is not None and report.tuned == 1
    assert ctl.published_plans == 1 and ctl.publish_failed == 0
    pointer = PlanRegistry(tmp_path / "reg").current()
    plan = PlanRegistry(tmp_path / "reg").pull(pointer)
    assert plan.lookup("gemm", tstore.shape_key(_shape(0)))[0] == CFG
    assert ctl.stats()["published_plans"] == 1
    # a registry that cannot be written: the swap stays, the publish counts
    (tmp_path / "blocked").write_text("a file, not a directory")
    ctl2 = tcontroller.RetuneController(
        store, tuners={"gemm": StubTuner()},
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1,
                                     retrain=False,
                                     publish=str(tmp_path / "blocked")))
    _drive(ttel.get_telemetry(), _shape(1))
    with pytest.warns(RuntimeWarning, match="plan publish"):
        assert ctl2.maybe_retune().tuned == 1
    assert ctl2.publish_failed == 1 and ctl2.retunes == 1


# ---------------------------------------------------------------------------
# the engine with retune_fleet and a thread worker
# ---------------------------------------------------------------------------

def test_smoke_engine_fleet_epoch_and_tokens_match_the_jax_engine(tmp_path):
    """SmolLM's SMOKE serves with ``retune_fleet``: its first poll
    publishes jobs, a thread worker tunes them, the swap lands only after
    the merge, and the greedy tokens before and after the swap equal the
    JAX engine's on the same prompts (the stub's config runs the same
    plain fp32 product on the CPU)."""
    jcfg, tcfg = jconfigs.SMOKE, tconfigs.SMOKE
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in (5, 9, 3, 12)]
    want = [[int(t) for t in o] for o in JEngine(
        jcfg, jp, JServeConfig(max_len=64, slots=3)).generate(
            prompts, max_new=12)]
    db = tmp_path / "db.jsonl"
    db.touch()
    fleet_dir = tmp_path / "fleet"
    eng = Engine(tcfg, tp, ServeConfig(
        max_len=64, slots=3, tunedb=str(db), retune=True, retune_interval=4,
        retune_min_calls=8, retune_top_k=2, retune_train=False,
        retune_fleet=str(fleet_dir), telemetry_export_s=0.05,
        router="affinity", retune_publish=str(tmp_path / "reg")),
        device="cpu")
    ctl = eng.controller
    ctl.fleet_poll_s = 0.02
    assert ctl.async_mode and eng.exporter is not None
    tuner = StubTuner(delay_s=0.05)
    installs = []
    real = tcontroller.install_serving

    def spy(**kw):
        # at the swap, every job a worker finished is already in the store
        done = tfleet.FleetDir(fleet_dir).done_meta()
        installs.append((len(done), all(
            eng.tunedb_store.contains(m["space"], m["inputs"])
            for m in done)))
        return real(**kw)
    tcontroller.install_serving = spy
    worker = tfleet.Worker(fleet_dir, worker_id="tw", poll_s=0.01,
                           tuners={"gemm": tuner, "attention": tuner})
    th = threading.Thread(target=worker.run, kwargs={"idle_timeout_s": 5.0})
    th.start()
    try:
        gen0 = tstore.serving_state().generation
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            before = eng.generate(prompts, max_new=12)
            # reaped by a poll inside generate, or still in flight
            report = ctl.wait_async(timeout=60) or ctl.last_report
            after = eng.generate(prompts, max_new=12)
    finally:
        tcontroller.install_serving = real
        th.join(30)
        eng.exporter.stop()
    assert report is not None and report.mode == "fleet" and report.tuned
    assert tstore.serving_state().generation > gen0
    assert installs and all(n >= 1 and merged for n, merged in installs)
    assert {r.merged_from for r in eng.tunedb_store.records()} == {"tw"}
    assert before == want and after == want
    assert eng.router.stats()["decisions"] == 2 * len(prompts)
    assert ctl.published_plans == ctl.retunes == len(installs)
    assert (fleet_dir / "telemetry" / eng.exporter.worker_id).is_dir()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_fleet_round_trip(tmp_path, capsys):
    """fleet start -> status -> a worker (a saved tuner, on the CPU) ->
    drain --wait, as the reference's round trip."""
    db, fleet = tmp_path / "db.jsonl", tmp_path / "fleet"
    tuner_dir = _saved_tuner(tmp_path)
    assert tcli_main(["fleet", "start", "--fleet", str(fleet), "--store",
                      str(db), "--space", "gemm", "--shape",
                      "M=32,N=64,K=64", "--drain"]) == 0
    assert "published 1 job(s)" in capsys.readouterr().out
    assert tcli_main(["fleet", "status", "--fleet", str(fleet)]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["counts"]["queue"] == 1 and status["draining"]
    assert tcli_main(["fleet", "worker", "--fleet", str(fleet),
                      "--worker-id", "cli-w", "--device", "cpu",
                      "--load-tuner", str(tuner_dir)]) == 0
    out = capsys.readouterr().out
    assert "1 tuned" in out and "kernel launches" in out
    assert tcli_main(["fleet", "drain", "--fleet", str(fleet), "--wait",
                      "--timeout", "30", "--compact"]) == 0
    out = capsys.readouterr().out
    assert "compacted 1 merged shard(s)" in out
    report = json.loads((fleet / "report.json").read_text())
    assert report["done"] == 1 and report["workers"] == ["cli-w"]
    store = tstore.RecordStore.open(db)
    rec = store.get("gemm", gemm_input(32, 64, 64))
    assert rec.merged_from == "cli-w"
    assert rec.backend.startswith("repro_torch.CudaEventBackend/device=")
    assert tcli_main(["fleet", "status", "--fleet", str(fleet),
                      "--json"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["fleet"]["report"]["done"] == 1
    with pytest.raises(FileNotFoundError):
        tcli_main(["fleet", "status", "--fleet", str(tmp_path / "nope")])


def _saved_tuner(tmp_path: Path) -> Path:
    """A small GEMM tuner labelled on the CPU, saved to a directory."""
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    from repro_torch.core.space import SPACES
    from repro_torch.core.tuner import InputAwareTuner
    tuner = InputAwareTuner.train(
        SPACES["gemm"], n_samples=48, hidden=(8,), epochs=2, seed=0,
        backend=CheckedBackend(CudaEventBackend(device="cpu")))
    tuner.top_k = 2
    d = tmp_path / "tuners"
    tuner.save(str(d))
    return d


def test_cli_fleet_start_workers_spawns_port_workers(tmp_path, capsys):
    """``fleet start --workers 2`` starts two ``repro_torch`` worker
    processes on the CPU, waits for them, merges and reaps them."""
    db, fleet = tmp_path / "db.jsonl", tmp_path / "fleet"
    tuner_dir = _saved_tuner(tmp_path)
    rc = tcli_main(["fleet", "start", "--fleet", str(fleet), "--store",
                    str(db), "--space", "gemm", "--shape", "M=32,N=64,K=64",
                    "--shape", "M=16,N=128,K=64", "--workers", "2",
                    "--device", "cpu", "--load-tuner", str(tuner_dir),
                    "--timeout", "240"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "spawned 2 local worker process(es)" in out
    report = json.loads((fleet / "report.json").read_text())
    assert report["done"] == 2 and report["failed"] == 0
    assert report["merged_records"] == 2
    store = tstore.RecordStore.open(db)
    assert len(store) == 2
    assert all(r.merged_from for r in store.records())


def test_cli_fleet_start_forwards_to_the_spawned_workers(tmp_path,
                                                         monkeypatch, capsys):
    spawned = []

    class _FakeProc:
        def __init__(self, cmd):
            self.cmd = cmd
            self.pid = 4000 + len(spawned)

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: spawned.append(_FakeProc(cmd))
                        or spawned[-1])
    rc = tcli_main(["fleet", "start", "--fleet", str(tmp_path / "fleet"),
                    "--store", str(tmp_path / "db.jsonl"), "--workers", "2",
                    "--worker-train-samples", "300", "--worker-epochs", "2",
                    "--device", "cpu", "--load-tuner", "T", "--timeout", "5"])
    assert rc == 0 and len(spawned) == 2
    for proc in spawned:
        assert proc.cmd[1:5] == ["-m", "repro_torch.tunedb", "fleet",
                                 "worker"]
        assert proc.cmd[proc.cmd.index("--device") + 1] == "cpu"
        assert proc.cmd[proc.cmd.index("--load-tuner") + 1] == "T"
        assert "300" in proc.cmd
    assert tfleet.FleetDir(tmp_path / "fleet").draining()


def test_fleet_worker_defaults_to_the_card(tmp_path):
    """Without ``--device`` a worker's tuners label on cuda, which this
    host does not have: the job fails and is requeued, never labelled on
    the CPU quietly."""
    db, fleet = tmp_path / "db.jsonl", tmp_path / "fleet"
    coord = tfleet.Coordinator(fleet, tstore.RecordStore.open(db),
                               max_attempts=5)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=_shape(0))])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tunedb", "fleet", "worker",
         "--fleet", str(fleet), "--max-jobs", "1",
         "--load-tuner", str(_saved_tuner(tmp_path))],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "0 tuned, 1 failed" in proc.stdout
    assert coord.fleet.counts()["queue"] == 1
