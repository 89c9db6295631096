"""The port's fault injection and crash safety (``repro_torch.tunedb.chaos``,
the store's quarantine and ``repair``, ``tunedb fsck``, the bus protocols
through the shim) against the JAX package's, on the CPU.

Parity: one ``FaultPlan`` over one sequence of operations injects the same
faults in both packages (the same outcomes, reports and files); a store
with a garbage line, a CRC mismatch and a torn tail opens with the same
records in both, and their quarantine files and the files ``repair``
rewrites are byte for byte the same; ``fsck`` on the same damaged store,
plan and fleet trees gives the same exit codes, findings and repaired
trees in both CLIs; a single-threaded lease lifecycle under one plan makes
the same shim calls and meets the same faults.

Then the reference's chaos tests, ported: zero shim calls while disarmed,
``retry_io``'s policy and metric, kill-points that job isolation does not
swallow (each of the worker's four), a torn append quarantined on reload,
a SIGKILLed appender losing nothing it acknowledged, the lease protocol
under seeded plans with a stub tuner, a crash in the middle of a merge
that ``fsck`` repairs and a restarted coordinator merges again, and the
recovery paths of the lease, telemetry and plan protocols.
"""

import errno
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
import warnings

import pytest

import repro.tunedb.chaos as jchaos
import repro.tunedb.fleet as jfleet
import repro.tunedb.store as jstore
from repro.tunedb.__main__ import main as jcli
from repro_torch.core.space import gemm_input
from repro_torch.tunedb import chaos as tchaos
from repro_torch.tunedb import fleet as tfleet
from repro_torch.tunedb import plans as tplans
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb import telemetry as ttel
from repro_torch.tunedb.__main__ import main as tcli
from repro_torch.tunedb.chaos import (TRANSIENT_ERRNOS, FaultPlan, FaultRule,
                                      KillPoint, retry_io)
from repro_torch.tunedb.obs import trace as ttrace
from repro_torch.tunedb.obs.metrics import get_registry, reset_metrics

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
CFG = {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
       "order": 0, "acc32": 1, "prefetch": 2}
JAX = types.SimpleNamespace(chaos=jchaos, store=jstore, fleet=jfleet,
                            cli=jcli, name="jax")
PORT = types.SimpleNamespace(chaos=tchaos, store=tstore, fleet=tfleet,
                             cli=tcli, name="port")
BOTH = [JAX, PORT]
SHIM_METHODS = ("probe", "read_text", "read_bytes", "write_text",
                "write_bytes", "file_write", "replace", "rename", "fsync",
                "utime", "unlink")


@pytest.fixture(autouse=True)
def _disarmed():
    """The shims are process-global: none may leak across tests."""
    jchaos.disarm()
    tchaos.disarm()
    reset_metrics()
    yield
    jchaos.disarm()
    tchaos.disarm()
    ttrace.reset_tracing()


def _rec(pkg=PORT, i: int = 0, tflops: float = 1.0, **kw):
    return pkg.store.TuneRecord(
        space="gemm", inputs=gemm_input(128 * (i + 1), 64, 512),
        config=dict(CFG), tflops=tflops, backend="sim",
        created_at=kw.pop("created_at", 1000.0 + i), **kw)


class StubTuner:
    """Instant and deterministic: the chaos tests are about I/O."""

    def __init__(self):
        self.space = types.SimpleNamespace(name="gemm")
        self.backend = types.SimpleNamespace(noise=0.0)

    def search(self, inputs, remeasure=True):
        tf = 1.0 + (inputs["M"] * inputs["N"] + inputs["K"]) % 997 / 10.0
        return types.SimpleNamespace(best=dict(CFG), predicted_tflops=tf,
                                     measured_tflops=tf,
                                     measured=[(dict(CFG), tf)])


def _worker(fleet_dir, wid: str, **kw) -> tfleet.Worker:
    return tfleet.Worker(fleet_dir, worker_id=wid,
                         tuners={"gemm": StubTuner()}, poll_s=0.01,
                         heartbeat_s=kw.pop("heartbeat_s", 0.05), **kw)


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


# ---------------------------------------------------------------------------
# parity: the same plan over the same operations, in both packages
# ---------------------------------------------------------------------------

def _plan(pkg, seed: int):
    R = pkg.chaos.FaultRule
    return pkg.chaos.FaultPlan(seed=seed, rules=[
        R(site="a.*", kind="kill", p=0.2, after=2, max_count=3),
        R(site="bus.write", kind="torn_write", p=0.25),
        R(site="bus.append", kind="torn_write", p=0.2),
        R(site="bus.rename", kind="rename_dup", p=0.3),
        R(site="bus.rename", kind="rename_fail", p=0.3),
        R(site="bus.read", kind="truncated_read", p=0.3),
        R(site="bus.read", kind="stale_read", p=0.3),
        R(site="bus.*", kind="errno", p=0.2, errno=errno.EAGAIN,
          max_count=6),
        R(site="bus.slow", kind="stall", p=0.5, stall_s=0.0),
    ])


def _script(io, root: pathlib.Path) -> list:
    """60 operations of every primitive over a few files, each outcome
    recorded: the value read, or the error, or the kill-point's site."""
    out = []

    def step(fn, *a, **kw):
        try:
            got = fn(*a, **kw)
            out.append(("ok", got if isinstance(got, (str, bytes)) else None))
        except KillPoint as e:
            out.append(("kill", e.site))
        except jchaos.KillPoint as e:
            out.append(("kill", e.site))
        except OSError as e:
            out.append(("oserror", e.errno))

    for i in range(60):
        p, q = root / f"f{i % 4}", root / f"g{i % 3}"
        k = i % 11
        if k == 0:
            step(io.probe, f"a.step{i % 2}")
        elif k == 1:
            step(io.write_text, p, f"text {i} " * 5, "bus.write")
        elif k == 2:
            if p.exists():
                step(io.read_text, p, "bus.read")
        elif k == 3:
            step(io.write_bytes, q, f"bytes {i}".encode() * 3, "bus.write")
        elif k == 4:
            if q.exists():
                step(io.read_bytes, q, "bus.read")
        elif k == 5:
            if p.exists():
                step(io.rename, p, root / f"r{i}", "bus.rename")
        elif k == 6:
            if q.exists():
                step(io.replace, q, root / f"f{i % 4}", "bus.rename")
        elif k == 7:
            with (root / "log").open("a") as fh:
                step(io.file_write, fh, f"line {i}\n", "bus.append")
                step(io.fsync, fh, "bus.fsync")
        elif k == 8:
            (root / "t").touch()
            step(io.utime, root / "t", "bus.slow")
        elif k == 9:
            step(io.unlink, root / f"r{i - 4}", "bus.unlink",
                 missing_ok=True)
        else:
            step(io.probe, "bus.slow")
    return out


def _files(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("seed", [0, 7, 11, 23])
def test_same_plan_same_operations_same_faults(tmp_path, seed):
    results = []
    for pkg in BOTH:
        root = tmp_path / pkg.name
        root.mkdir()
        plan = _plan(pkg, seed)
        io = pkg.chaos.FaultyIO(plan)
        outcomes = _script(io, root)
        results.append((outcomes, io.report(), _files(root),
                        [(r.seen, r.fired) for r in plan.rules]))
    (j_out, j_rep, j_files, j_rules), (t_out, t_rep, t_files, t_rules) = \
        results
    assert t_out == j_out
    assert t_rep == j_rep
    assert t_files == j_files
    assert t_rules == j_rules
    assert t_rep["injected_total"] > 0 and t_rep["calls"] > 50
    assert {"kill", "oserror", "ok"} <= {o[0] for o in t_out}


@pytest.mark.parametrize("seed", [3, 7])
def test_store_appends_under_one_plan_match(tmp_path, seed):
    """Each package's store appends 24 records under the same plan: every
    torn append is a crash (the store is opened again, quarantining the
    fragment); the outcomes, the reports, the store files and the
    quarantined lines are the same."""
    results = []
    for pkg in BOTH:
        root = tmp_path / pkg.name
        root.mkdir()
        path = root / "db.jsonl"
        R = pkg.chaos.FaultRule
        plan = pkg.chaos.FaultPlan(seed=seed, rules=[
            R(site="store.append", kind="torn_write", p=0.15),
            R(site="store.append*", kind="errno", p=0.2, errno=errno.EIO)])
        s = pkg.store.RecordStore(path)
        outcomes = []
        with pkg.chaos.armed(plan) as io:
            for i in range(24):
                try:
                    s.add(_rec(pkg, i))
                    outcomes.append("ok")
                except OSError as e:
                    outcomes.append(f"errno {e.errno}")
                except BaseException as e:       # the package's KillPoint
                    assert type(e).__name__ == "KillPoint"
                    outcomes.append(f"kill {e.site}")
                    s = _quiet(pkg.store.RecordStore, path)
        s = _quiet(pkg.store.RecordStore, path)
        quarantined = "".join(p.read_text() for p in
                              sorted(s.quarantine_dir().glob("*.jsonl"))) \
            if s.quarantine_dir().is_dir() else ""
        results.append((outcomes, io.report(), path.read_bytes(),
                        quarantined, sorted(r.to_json() for r in
                                            s.records())))
    assert results[0] == results[1]
    outcomes = results[1][0]
    assert "ok" in outcomes and any(o.startswith("kill") for o in outcomes)


def test_quarantine_and_repair_are_byte_identical(tmp_path):
    bad_crc = json.loads(_rec(PORT, 5).to_json())
    bad_crc["tflops"] = 99.0                    # flipped after the CRC stamp
    lines = [_rec(PORT, 0).to_json(), _rec(PORT, 1).to_json(),
             '{"torn half-line', json.dumps(bad_crc, sort_keys=True),
             "", _rec(PORT, 2).to_json(), "not json at all"]
    text = "\n".join(lines) + "\n" + _rec(PORT, 3).to_json()[:57]
    got = {}
    for pkg in BOTH:
        path = tmp_path / pkg.name / "db.jsonl"
        path.parent.mkdir()
        path.write_text(text)
        with pytest.warns(RuntimeWarning, match="quarantined"):
            s = pkg.store.RecordStore.open(path)
        q_load = [p.read_bytes() for p in
                  sorted(s.quarantine_dir().glob("*-load.jsonl"))]
        repaired = s.repair()
        q_repair = [p.read_bytes() for p in
                    sorted(s.quarantine_dir().glob("*-repair.jsonl"))]
        rewritten = path.read_bytes()
        with warnings.catch_warnings():
            warnings.simplefilter("error")       # clean now: no warning
            s2 = pkg.store.RecordStore.open(path)
        s2.add(_rec(pkg, 4))
        got[pkg.name] = dict(
            counts=(len(s), s.n_lines, s.n_skipped),
            records=sorted(r.to_json() for r in s.records()),
            q_load=q_load, repaired=repaired, q_repair=q_repair,
            rewritten=rewritten, after_add=path.read_bytes(),
            reopened=(len(s2), s2.n_skipped))
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["counts"] == (3, 3, 4)
    assert port["repaired"] == {"kept": 3, "quarantined": 4}
    assert len(port["q_load"]) == 1 and b"torn half-line" in port["q_load"][0]
    assert port["q_load"] == port["q_repair"]
    assert port["reopened"] == (4, 0)


def test_crcless_legacy_line_still_loads(tmp_path):
    doc = json.loads(_rec().to_json())
    doc.pop("crc")
    legacy = tmp_path / "old.jsonl"
    legacy.write_text(json.dumps(doc) + "\n")
    s = tstore.RecordStore.open(legacy)
    assert len(s) == 1 and s.n_skipped == 0


# -- fsck on the same damaged trees ------------------------------------------

def _plan_table(i: int) -> dict:
    return {("gemm", tstore.shape_key(gemm_input(128 * (i + 1), 64, 512))):
            (dict(CFG), "exact")}


def _registry(root: pathlib.Path, n: int = 3) -> tplans.PlanRegistry:
    reg = tplans.PlanRegistry(root)
    for i in range(n):
        reg.publish(tstore.DispatchPlan(generation=i, fingerprint="sim",
                                        store_version=-1,
                                        table=_plan_table(i)))
    return reg


def _tear(gen_dir: pathlib.Path) -> None:
    entries = gen_dir / tplans.ENTRIES_NAME
    entries.write_bytes(entries.read_bytes()[:20])


def _fleet_tree(root: pathlib.Path) -> None:
    store = tstore.RecordStore(root / "db.jsonl")
    store.add(_rec())
    coord = tfleet.Coordinator(root / "fleet", store)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=gemm_input(*s))
                   for s in ((128, 64, 512), (256, 64, 512))])
    fd = coord.fleet
    job, lp = fd.claim()
    fd.complete(job, lp, {"worker_id": "w"})
    # an orphan lease behind the done marker, a requeued copy of it, a
    # garbage queue file and a garbage lease
    (fd.leases / f"{job.job_id}.json").write_text(job.to_json())
    (fd.queue / "junk.json").write_text("not a job")
    (fd.leases / "junk2.json").write_text('{"space": "gemm"}')


def _tree(kind: str, root: pathlib.Path) -> list:
    """Build one damaged tree under ``root``; the fsck arguments, relative
    to it."""
    root.mkdir(parents=True)
    store = tstore.RecordStore(root / "db.jsonl")
    for i in range(2):
        store.add(_rec(PORT, i))
    args = ["db.jsonl"]
    if kind == "store":
        with (root / "db.jsonl").open("a") as fh:
            fh.write('{"bad\n' + _rec(PORT, 2).to_json() + "\n"
                     + _rec(PORT, 3).to_json()[:40])
    elif kind in ("plans_old", "plans_current", "plans_pointer"):
        reg = _registry(root / "reg")
        if kind in ("plans_old", "plans_current"):
            _tear(reg.generation_dir(1))
        if kind == "plans_current":
            _tear(reg.generation_dir(3))
        if kind == "plans_pointer":
            (root / "reg" / tplans.CURRENT_NAME).write_text('{"gen')
        args += ["--plans", "reg"]
    elif kind in ("fleet", "store_fleet_plans"):
        _fleet_tree(root)
        args += ["--fleet", "fleet"]
        if kind == "store_fleet_plans":
            with (root / "db.jsonl").open("a") as fh:
                fh.write("garbage\n")
            _tear(_registry(root / "reg").generation_dir(2))
            args += ["--plans", "reg"]
    return args


def _normalise(text: str, root: pathlib.Path) -> str:
    return text.replace(str(root.resolve()), "<ROOT>").replace(
        str(root), "<ROOT>")


def _tree_bytes(root: pathlib.Path) -> dict:
    """Every file of a tree; quarantine files named without their
    millisecond stamps, the fleet manifest and the job files' times left
    out."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        if ".quarantine" in rel:
            rel = rel.rsplit("/", 1)[0] + "/" + p.name.split("-", 1)[1]
            out[rel] = out.get(rel, b"") + p.read_bytes()
        elif p.suffix == ".json" and "fleet" in rel:
            out[rel] = "json"          # times: compared by name only
        else:
            out[rel] = p.read_bytes()
    return out


FSCK_TREES = {
    # kind: exit codes of plain, --repair, plain
    "clean": (0, 0, 0),
    "store": (1, 0, 0),
    "plans_old": (1, 0, 0),
    "plans_current": (1, 1, 1),
    "plans_pointer": (1, 1, 1),
    "fleet": (1, 0, 0),
    "store_fleet_plans": (1, 0, 0),
}


@pytest.mark.parametrize("kind", sorted(FSCK_TREES))
def test_fsck_matches_the_reference(tmp_path, capsys, kind):
    base = tmp_path / "base"
    args = _tree(kind, base)
    got = {}
    for pkg in BOTH:
        root = tmp_path / pkg.name
        shutil.copytree(base, root)
        rel = [str(root / a) if not a.startswith("--") else a for a in args]
        codes, outs = [], []
        capsys.readouterr()
        for extra in ([], ["--repair"], []):
            codes.append(_quiet(pkg.cli, ["fsck", *rel, *extra, "--json"]))
            outs.append(_normalise(capsys.readouterr().out, root))
        got[pkg.name] = (codes, outs, _tree_bytes(root))
    assert got["port"][0] == got["jax"][0] == list(FSCK_TREES[kind])
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    report = _json_block(got["port"][1][0])
    if kind == "fleet":
        assert len(report["fleet"]["orphans"]) == 1
        assert sorted(report["fleet"]["garbage"]) == ["lease:junk2.json",
                                                      "queue:junk.json"]
    if kind == "store":
        assert report["store"]["bad_lines"] == [3, 5]
        assert report["store"]["torn_tail"] is True


def _json_block(out: str) -> dict:
    """The ``--json`` report inside fsck's output."""
    start = out.index("\n{") + 1
    end = out.index("\n}", start) + 2
    return json.loads(out[start:end])


def test_fsck_clean_store_exits_zero(tmp_path, capsys):
    path = tmp_path / "db.jsonl"
    tstore.RecordStore(path).add(_rec())
    assert tcli(["fsck", str(path)]) == 0
    assert "verdict: OK" in capsys.readouterr().out


def test_fsck_detects_then_repairs_damage(tmp_path, capsys):
    path = tmp_path / "db.jsonl"
    tstore.RecordStore(path).add(_rec())
    with path.open("a") as fh:
        fh.write('{"bad\n')
    assert tcli(["fsck", str(path)]) == 1
    with pytest.warns(RuntimeWarning):
        assert tcli(["fsck", str(path), "--repair", "--json"]) == 0
    assert "repaired" in capsys.readouterr().out
    assert tcli(["fsck", str(path)]) == 0
    assert len(tstore.RecordStore.open(path)) == 1


def test_fsck_fleet_invariants(tmp_path, capsys):
    _fleet_tree(tmp_path)
    args = ["fsck", str(tmp_path / "db.jsonl"), "--fleet",
            str(tmp_path / "fleet")]
    assert tcli(args) == 1
    assert tcli(args + ["--repair"]) == 0
    assert tcli(args) == 0
    fd = tfleet.FleetDir(tmp_path / "fleet")
    assert fd.counts() == {"queue": 1, "leases": 0, "done": 1, "failed": 0}
    assert sorted(p.name for p in (fd.root / "quarantine").iterdir()) == [
        "lease-junk2.json", "queue-junk.json"]
    capsys.readouterr()


# -- the lease lifecycle under one plan, single-threaded ----------------------

@pytest.mark.parametrize("seed", [5, 11])
def test_lease_lifecycle_under_one_plan_matches(tmp_path, seed):
    """One thread publishes 6 jobs, claims each, heartbeats, completes or
    fails it, then reclaims expired leases, in each package under the same
    plan: the same shim calls meet the same faults, and the buses end in
    the same state."""
    got = {}
    for pkg in BOTH:
        root = tmp_path / pkg.name
        fd = pkg.fleet.FleetDir(root / "fleet")
        fd.init(root / "db.jsonl", lease_timeout_s=0.0, max_attempts=2)
        R = pkg.chaos.FaultRule
        plan = pkg.chaos.FaultPlan(seed=seed, rules=[
            R(site="lease.claim*", kind="errno", p=0.25, errno=errno.EIO),
            R(site="lease.*", kind="errno", p=0.15, errno=errno.EBUSY),
            R(site="lease.*.replace", kind="rename_dup", p=0.2)])
        outcomes = []
        with pkg.chaos.armed(plan) as io:
            for i in range(6):
                try:
                    outcomes.append(fd.publish(pkg.fleet.FleetJob(
                        space="gemm", inputs=gemm_input(128 * (i + 1), 64,
                                                        512),
                        count=6 - i, created_at=1.0)))
                except OSError as e:
                    outcomes.append(f"publish errno {e.errno}")
            for i in range(8):
                try:
                    claimed = fd.claim()
                except OSError as e:
                    outcomes.append(f"claim errno {e.errno}")
                    continue
                if claimed is None:
                    outcomes.append("empty")
                    continue
                job, lp = claimed
                outcomes.append((job.job_id, fd.heartbeat(lp)))
                try:
                    if i % 3 == 2:
                        outcomes.append(fd.fail(job, lp, "boom",
                                                max_attempts=2))
                    else:
                        outcomes.append(fd.complete(job, lp, {"w": 1}))
                except OSError as e:
                    outcomes.append(f"finish errno {e.errno}")
            try:
                outcomes.append(fd.reclaim_expired(lease_timeout_s=-1.0,
                                                   max_attempts=2))
            except OSError as e:
                outcomes.append(f"reclaim errno {e.errno}")
        files = sorted(str(p.relative_to(root / "fleet"))
                       for p in (root / "fleet").rglob("*") if p.is_file())
        got[pkg.name] = (outcomes, io.report(), fd.counts(), files)
    assert got["port"] == got["jax"]
    assert got["port"][1]["injected_total"] > 0


# ---------------------------------------------------------------------------
# the reference's chaos tests, on the port
# ---------------------------------------------------------------------------

def test_load_quarantines_garbage_and_repair_rewrites(tmp_path):
    path = tmp_path / "db.jsonl"
    s = tstore.RecordStore(path)
    s.add(_rec(PORT, 0))
    s.add(_rec(PORT, 1))
    with path.open("a", encoding="utf-8") as fh:
        fh.write('{"torn half-line\n')
        fh.write(_rec(PORT, 2).to_json() + "\n")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        s2 = tstore.RecordStore.open(path)
    assert len(s2) == 3 and s2.n_skipped == 1
    quarantined = list(s2.quarantine_dir().glob("*-load.jsonl"))
    assert len(quarantined) == 1
    assert "torn half-line" in quarantined[0].read_text()
    assert get_registry().counter(
        "tunedb_store_quarantined_lines_total").value() == 1
    assert s2.repair() == {"kept": 3, "quarantined": 1}
    s3 = tstore.RecordStore.open(path)
    assert len(s3) == 3 and s3.n_skipped == 0
    s3.add(_rec(PORT, 3))                 # the newline bookkeeping holds
    assert len(tstore.RecordStore.open(path)) == 4


def test_quarantine_warns_once_per_store(tmp_path):
    path = tmp_path / "db.jsonl"
    tstore.RecordStore(path).add(_rec())
    with path.open("a") as fh:
        fh.write("garbage\n")
    with pytest.warns(RuntimeWarning):
        tstore.RecordStore.open(path)
    with path.open("a") as fh:
        fh.write("more garbage\n")
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # the second load is silent
        s = tstore.RecordStore.open(path)
    assert s.n_skipped == 2
    assert get_registry().counter(
        "tunedb_store_quarantined_lines_total").value() == 3


def test_retry_io_retries_transient_errno():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "injected")
        return "ok"

    assert retry_io(flaky, site="t", base_delay_s=0.0) == "ok"
    assert calls["n"] == 3
    assert get_registry().counter("tunedb_io_retries_total").value(
        site="t", errno=str(errno.EIO)) == 2


def test_retry_io_gives_up_after_budget():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError(errno.EBUSY, "injected")

    with pytest.raises(OSError):
        retry_io(always, site="t", attempts=3, base_delay_s=0.0)
    assert calls["n"] == 3


@pytest.mark.parametrize("exc", [
    FileNotFoundError(errno.ENOENT, "lost race"),
    OSError(errno.ENOSPC, "disk full"),
    ValueError("not an I/O error"),
])
def test_retry_io_never_retries_nontransient(exc):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        retry_io(fn, site="t", base_delay_s=0.0)
    assert calls["n"] == 1
    assert getattr(exc, "errno", None) not in TRANSIENT_ERRNOS
    assert not get_registry().counter("tunedb_io_retries_total").samples()


def test_zero_shim_calls_while_disarmed(tmp_path, monkeypatch):
    """With no plan armed the store, the lease lifecycle, a worker's job,
    the coordinator's merge, plan export / load / publish / pull, a
    telemetry dump and a trace dump make no FaultyIO call."""
    hits = {"n": 0}

    def trap(self, *a, **kw):
        hits["n"] += 1
        raise AssertionError("a disarmed path touched the chaos shim")

    for name in SHIM_METHODS:
        monkeypatch.setattr(tchaos.FaultyIO, name, trap)
    assert tchaos._IO is None

    store = tstore.RecordStore(tmp_path / "db.jsonl")
    store.add(_rec())
    store.sync()
    store.export(tmp_path / "out.jsonl")
    tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store,
                               lease_timeout_s=5.0)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=gemm_input(*s))
                   for s in ((128, 64, 512), (256, 64, 512),
                             (512, 64, 512))])
    fd = coord.fleet
    job, lp = fd.claim()
    assert fd.heartbeat(lp)
    fd.complete(job, lp, {"worker_id": "w"})
    job, lp = fd.claim()
    fd.fail(job, lp, "boom", max_attempts=3)
    os.utime(fd.queue / f"{job.job_id}.json", (1.0, 1.0))
    job, lp = fd.claim()
    os.utime(lp, (1.0, 1.0))
    fd.reclaim_expired(lease_timeout_s=5.0, max_attempts=3)
    assert _worker(tmp_path / "fleet", "w1").run(
        max_jobs=3, idle_timeout_s=0.0).tuned >= 1
    coord.poll()
    plan = tstore.DispatchPlan(generation=0, fingerprint="sim",
                               store_version=-1, table=_plan_table(0))
    tplans.load_plan(tplans.export_plan(plan, tmp_path / "plan"))
    reg = tplans.PlanRegistry(tmp_path / "reg")
    reg.publish(plan)
    reg.pull(reg.current())
    tel = ttel.ShapeTelemetry()
    tel.record("gemm", gemm_input(4, 576, 576))
    tel.save(tmp_path / "tel.json")
    ttel.ShapeTelemetry.load(tmp_path / "tel.json")
    exp = ttel.TelemetryExporter(tel, tmp_path / "tele", worker_id="w",
                                 interval_s=0.01).start()
    time.sleep(0.05)
    exp.stop()
    tr = ttrace.enable_tracing(1.0)
    with tr.root("chaos.test"):
        pass
    assert tr.export_jsonl(tmp_path / "spans.jsonl") == 1
    assert hits["n"] == 0


def test_same_seed_same_faults(tmp_path):
    def run(seed):
        plan = FaultPlan(seed=seed, rules=[
            FaultRule(site="store.append", kind="errno", p=0.5,
                      errno=errno.EIO)])
        s = tstore.RecordStore(tmp_path / f"s{seed}-{time.monotonic_ns()}")
        outcomes = []
        with tchaos.armed(plan) as io:
            for i in range(20):
                try:
                    s.add(_rec(PORT, i))
                    outcomes.append("ok")
                except OSError:
                    outcomes.append("eio")
        return outcomes, io.report()

    a_out, a_rep = run(7)
    b_out, b_rep = run(7)
    c_out, _ = run(8)
    assert a_out == b_out and a_rep == b_rep
    assert "eio" in a_out and "ok" in a_out
    assert a_out != c_out


def test_shim_counts_hold_under_threads():
    """Worker threads share one shim: with more threads than cores and a
    short switch interval no call goes uncounted and no rule fires past
    its ``max_count``."""
    plan = FaultPlan(seed=3, rules=[
        FaultRule(site="s.*", kind="errno", p=0.5, max_count=50)])
    io = tchaos.FaultyIO(plan)
    n_threads = len(os.sched_getaffinity(0)) + 2
    n_ops = 400
    errors = []

    def hammer():
        for _ in range(n_ops):
            try:
                io.probe("s.x")
            except OSError:
                errors.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    rep = io.report()
    assert rep["calls"] == plan.rules[0].seen == n_threads * n_ops
    assert rep["injected_total"] == len(errors) == plan.rules[0].fired == 50


KILL_SITES = ("worker.claimed", "worker.tuned", "worker.appended",
              "worker.complete")


@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_point_is_not_swallowed_by_job_isolation(tmp_path, site):
    """KillPoint is a BaseException: the worker's ``except Exception`` job
    isolation lets it through, the heartbeat thread has stopped, the lease
    stays (no done marker), and its expiry requeues the job; a second
    worker's run is merged once, whatever the dead worker appended."""
    store = tstore.RecordStore(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store,
                               lease_timeout_s=0.2)
    job = tfleet.FleetJob(space="gemm", inputs=gemm_input(128, 64, 512))
    coord.publish([job])
    w = _worker(tmp_path / "fleet", "doomed", heartbeat_s=0.02)
    threads = set(threading.enumerate())
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site=site, kind="kill", p=1.0, max_count=1)])
    with tchaos.armed(plan) as io:
        with pytest.raises(KillPoint) as exc:
            w.run_one()
    assert exc.value.site == site
    assert io.report()["by_site"] == {f"{site}|kill": 1}
    assert not set(threading.enumerate()) - threads   # no heartbeat left
    fd = coord.fleet
    assert fd.counts() == {"queue": 0, "leases": 1, "done": 0, "failed": 0}
    shard = fd.shard_path("doomed")
    appended = shard.exists() and shard.read_text().count("\n")
    assert appended == (site in ("worker.appended", "worker.complete"))
    time.sleep(0.25)
    assert fd.reclaim_expired(lease_timeout_s=0.2, max_attempts=3) == [
        job.job_id]
    assert fd.counts()["queue"] == 1
    assert _worker(tmp_path / "fleet", "w2").run_one() is True
    coord.poll()
    assert [r.inputs for r in store.records()] == [job.inputs]


def test_torn_append_quarantined_on_reload(tmp_path):
    path = tmp_path / "db.jsonl"
    s = tstore.RecordStore(path, fsync=True)
    s.add(_rec(PORT, 0))
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="store.append", kind="torn_write", p=1.0,
                  max_count=1)])
    with tchaos.armed(plan):
        with pytest.raises(KillPoint):
            s.add(_rec(PORT, 1))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        s2 = tstore.RecordStore.open(path)
    assert len(s2) == 1
    assert s2.records()[0].inputs == _rec(PORT, 0).inputs
    s2.add(_rec(PORT, 2))
    assert len(tstore.RecordStore.open(path)) == 2


_CHILD = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.tunedb.store import RecordStore, TuneRecord
s = RecordStore({path!r}, fsync=True)
i = 0
while True:
    s.add(TuneRecord(space="gemm", inputs={{"M": i, "N": 64, "K": 512}},
                     config={{"bm": 32}}, tflops=1.0, backend="sim"))
    print(i, flush=True)        # the acknowledgement: fsynced before it
    i += 1
"""


def test_sigkill_mid_append_recovers_all_acked(tmp_path):
    path = str(tmp_path / "db.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(src=SRC, path=path)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    acked = []
    try:
        for line in proc.stdout:
            acked.append(int(line))
            if len(acked) >= 12:
                proc.send_signal(signal.SIGKILL)   # mid-flight, no clean-up
                break
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert len(acked) >= 12
    s = _quiet(tstore.RecordStore.open, path)
    recovered = {r.inputs["M"] for r in s.records()}
    assert not set(acked) - recovered, "acknowledged records lost"


def _recover(coord, fleet_dir, timeout_s: float, deadline_s: float = 30.0):
    """Faults off: requeue expired leases and run sweep workers until the
    queue and the leases are empty."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        time.sleep(timeout_s + 0.01)
        coord.fleet.reclaim_expired(lease_timeout_s=timeout_s,
                                    max_attempts=10)
        c = coord.fleet.counts()
        if c["leases"] == 0 and c["queue"] == 0:
            break
        _worker(fleet_dir, f"sweep-{time.monotonic_ns()}").run(
            max_jobs=8, idle_timeout_s=0.2)


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_lease_protocol_survives_seeded_chaos(tmp_path, seed):
    store = tstore.RecordStore(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store,
                               lease_timeout_s=0.3)
    jobs = [tfleet.FleetJob(space="gemm",
                            inputs=gemm_input(128 * (i + 1), 64, 512))
            for i in range(6)]
    assert coord.publish(jobs) == 6
    plan = FaultPlan(seed=seed, rules=[
        FaultRule(site="worker.*", kind="kill", p=0.15, max_count=2),
        FaultRule(site="lease.*", kind="errno", p=0.10, errno=errno.EIO,
                  max_count=6),
        FaultRule(site="store.append", kind="torn_write", p=0.05,
                  max_count=1)])

    def run_worker(wid):
        try:
            _worker(tmp_path / "fleet", wid).run(max_jobs=8,
                                                 idle_timeout_s=0.5)
        except (KillPoint, OSError):
            pass                        # a crash (simulated, or a lease
                                        # write past its retries)

    with tchaos.armed(plan) as io:
        threads = [threading.Thread(target=run_worker, args=(f"w{i}",))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert io.calls > 0
    _recover(coord, tmp_path / "fleet", 0.3)
    c = coord.fleet.counts()
    assert c["queue"] == 0 and c["leases"] == 0, c
    done = {p.stem for p in coord.fleet.done.glob("*.json")}
    failed = {p.stem for p in coord.fleet.failed.glob("*.json")}
    assert done | failed == {j.job_id for j in jobs}
    assert not (done & failed)
    coord.poll()
    merged = {tuple(sorted(r.inputs.items()))
              for r in store.records() if r.source == "fleet"}
    for j in jobs:
        if j.job_id in done:
            assert tuple(sorted(j.inputs.items())) in merged


def test_crash_mid_merge_repaired_and_merged_again(tmp_path, capsys):
    """A torn append in the coordinator's merge: the poll dies, the store
    warns and quarantines the fragment, fsck reports, repairs, passes
    clean, and a restarted coordinator merges again from the unmoved
    cursor."""
    path = tmp_path / "db.jsonl"
    store = tstore.RecordStore(path)
    store.add(_rec(PORT, 5))
    coord = tfleet.Coordinator(tmp_path / "fleet", store,
                               lease_timeout_s=5.0)
    jobs = [tfleet.FleetJob(space="gemm", inputs=gemm_input(*s))
            for s in ((128, 64, 512), (256, 64, 512))]
    coord.publish(jobs)
    assert _worker(tmp_path / "fleet", "w").run(idle_timeout_s=0.0).tuned \
        == 2
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="store.append", kind="torn_write", p=1.0,
                  max_count=1)])
    with tchaos.armed(plan):
        with pytest.raises(KillPoint):
            coord.poll()
    with pytest.warns(RuntimeWarning, match="quarantined"):
        reopened = tstore.RecordStore.open(path)
    assert len(reopened) == 1 and reopened.n_skipped == 1
    fragment = next(reopened.quarantine_dir().glob("*-load.jsonl"))
    tail = path.read_text().rsplit("\n", 1)[1]
    assert tail.strip() and fragment.read_text() == tail.strip() + "\n"
    args = ["fsck", str(path), "--fleet", str(tmp_path / "fleet")]
    assert tcli(args) == 1
    assert _quiet(tcli, args + ["--repair"]) == 0
    assert tcli(args) == 0
    capsys.readouterr()
    again = tfleet.Coordinator(tmp_path / "fleet")
    assert again.poll()["merged_now"] == 2
    shapes = {tuple(sorted(r.inputs.items())) for r in
              tstore.RecordStore.open(path).records()}
    assert {tuple(sorted(j.inputs.items())) for j in jobs} <= shapes


def test_merge_read_error_leaves_the_cursor(tmp_path):
    store = tstore.RecordStore(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    coord.publish([tfleet.FleetJob(space="gemm",
                                   inputs=gemm_input(128, 64, 512))])
    _worker(tmp_path / "fleet", "w").run(idle_timeout_s=0.0)
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="coord.merge.read", kind="errno", p=1.0,
                  errno=errno.EIO)])
    with tchaos.armed(plan) as io:
        assert coord.poll()["merged_now"] == 0
    assert io.report()["by_site"] == {"coord.merge.read|errno": 1}
    assert not (tmp_path / "fleet" / "merged" / "w.json").exists()
    assert coord.poll()["merged_now"] == 1


def test_cursor_write_retried(tmp_path):
    store = tstore.RecordStore(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    coord.publish([tfleet.FleetJob(space="gemm",
                                   inputs=gemm_input(128, 64, 512))])
    _worker(tmp_path / "fleet", "w").run(idle_timeout_s=0.0)
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="coord.cursor", kind="errno", p=1.0,
                  errno=errno.EAGAIN, max_count=1)])
    with tchaos.armed(plan):
        assert coord.poll()["merged_now"] == 1
    assert json.loads((tmp_path / "fleet" / "merged" / "w.json")
                      .read_text())["merged"] == 1
    assert get_registry().counter("tunedb_io_retries_total").value(
        site="coord.cursor", errno=str(errno.EAGAIN)) == 1


def test_claim_read_error_keeps_the_lease_garbage_drops_it(tmp_path):
    fd = tfleet.FleetDir(tmp_path / "fleet")
    fd.init(tmp_path / "db.jsonl")
    job = tfleet.FleetJob(space="gemm", inputs=gemm_input(128, 64, 512))
    fd.publish(job)
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="lease.claim.read", kind="errno", p=1.0,
                  errno=errno.EIO)])
    with tchaos.armed(plan):
        assert fd.claim() is None
    # the read failed past its retries: the lease stays for expiry
    assert fd.counts() == {"queue": 0, "leases": 1, "done": 0, "failed": 0}
    assert get_registry().counter("tunedb_io_retries_total").value(
        site="lease.claim.read", errno=str(errno.EIO)) == 3   # each error
    lease = fd.leases / f"{job.job_id}.json"
    os.utime(lease, (1.0, 1.0))
    assert fd.reclaim_expired(lease_timeout_s=5.0, max_attempts=3) == [
        job.job_id]
    (fd.queue / "junk.json").write_text("not a job")
    got, _ = fd.claim()
    assert got.job_id == job.job_id
    assert fd.claim() is None            # the garbage lease is unlinked
    assert fd.counts()["leases"] == 1


def test_heartbeat_survives_transient_errors(tmp_path):
    fd = tfleet.FleetDir(tmp_path / "fleet")
    fd.init(tmp_path / "db.jsonl")
    fd.publish(tfleet.FleetJob(space="gemm",
                               inputs=gemm_input(128, 64, 512)))
    _, lp = fd.claim()
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="lease.heartbeat", kind="errno", p=1.0,
                  errno=errno.EIO)])
    with tchaos.armed(plan):
        assert fd.heartbeat(lp) is True      # persistent, but the lease is
        lp.unlink()                          # there; gone, it says False
        assert fd.heartbeat(lp) is False


def test_telemetry_dump_torn_keeps_the_old_one(tmp_path):
    tel = ttel.ShapeTelemetry()
    tel.record("gemm", gemm_input(4, 576, 576), n=3)
    path = tmp_path / "tel.json"
    tel.save(path)
    tel.record("gemm", gemm_input(32, 576, 576), n=5)
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="telemetry.save", kind="torn_write", p=1.0)])
    with tchaos.armed(plan):
        with pytest.raises(KillPoint):
            tel.save(path)
    back = ttel.ShapeTelemetry.load(path)
    assert back.snapshot().counts == ttel.ShapeTelemetry.load(
        path).snapshot().counts
    assert sum(c for _, c in back.snapshot().counts["gemm"].values()) == 3


def test_telemetry_exporter_retries_transient_errors(tmp_path):
    tel = ttel.ShapeTelemetry()
    tel.record("gemm", gemm_input(4, 576, 576))
    exp = ttel.TelemetryExporter(tel, tmp_path / "tele", worker_id="w",
                                 interval_s=3600.0)
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="telemetry.save.replace", kind="errno", p=1.0,
                  errno=errno.EIO, max_count=1)])
    with tchaos.armed(plan) as io:
        exp.start()
        exp.stop()                           # the final export retries
    assert io.report()["by_site"] == {"telemetry.save.replace|errno": 1}
    assert exp.exports == 1
    assert get_registry().counter("tunedb_io_retries_total").value(
        site="telemetry.export", errno=str(errno.EIO)) == 1
    assert ttel.ShapeTelemetry.load(
        sorted((tmp_path / "tele" / "w").glob("*.json"))[-1])


def test_plan_export_torn_leaves_nothing(tmp_path):
    plan = tstore.DispatchPlan(generation=0, fingerprint="sim",
                               store_version=-1, table=_plan_table(0))
    rules = FaultPlan(seed=0, rules=[
        FaultRule(site="plan.export.manifest", kind="torn_write", p=1.0)])
    with tchaos.armed(rules):
        with pytest.raises(KillPoint):
            tplans.export_plan(plan, tmp_path / "plan")
    assert not (tmp_path / "plan").exists() or not any(
        (tmp_path / "plan").iterdir())
    dest = tplans.export_plan(plan, tmp_path / "plan")
    trunc = FaultPlan(seed=1, rules=[
        FaultRule(site="plan.pull.entries", kind="truncated_read", p=1.0)])
    with tchaos.armed(trunc):
        with pytest.raises(tplans.PlanArtifactError):
            tplans.load_plan(dest)
    assert tplans.load_plan(dest).digest


def test_registry_pointer_faults_mean_try_again(tmp_path):
    reg = _registry(tmp_path / "reg", n=1)
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="plan.registry.current", kind="errno", p=1.0,
                  errno=errno.EIO)])
    with tchaos.armed(plan):
        assert reg.current() is None
    torn = FaultPlan(seed=0, rules=[
        FaultRule(site="plan.registry.write", kind="torn_write", p=1.0)])
    with tchaos.armed(torn):
        with pytest.raises(KillPoint):
            reg.publish(tstore.DispatchPlan(
                generation=1, fingerprint="sim", store_version=-1,
                table=_plan_table(1)))
    # the artifact landed, the pointer did not move
    assert reg.current()["generation"] == 1
    assert reg.pull(reg.current()).digest


def test_trace_dump_through_the_shim(tmp_path):
    tr = ttrace.enable_tracing(1.0)
    for i in range(3):
        with tr.root("chaos.span", i=i):
            pass
    plan = FaultPlan(seed=0, rules=[
        FaultRule(site="trace.export", kind="torn_write", p=1.0)])
    with tchaos.armed(plan) as io:
        with pytest.raises(KillPoint):
            tr.export_jsonl(tmp_path / "spans.jsonl")
    assert io.report()["by_site"] == {"trace.export|torn_write": 1}
    spans = ttrace.load_span_file(tmp_path / "spans.jsonl")
    assert len(spans) < 3                 # the torn last line is read past
