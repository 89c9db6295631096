"""The port's fleet-global telemetry, shape-affinity router, replica plans
and fleet status against the JAX package's, on the CPU.

The same dumps, plans and request streams in both packages: the same
aggregated counts (under concurrent ring writers too), the same affinity
classes and replica plans (digests included), the same routing decisions
of every policy, the same ``fleet route`` answer, the same ``fleet`` /
``follower`` / ``router`` sections of ``/status`` field by field, and the
four span names the fleet adds (``request.route``, ``fleet.job``,
``fleet.merge``, ``plan.install``) in the taxonomy the JAX package emits.
"""

import io
import json
import threading
import time
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import repro.serve.router as jrouter
import repro.tunedb.controller as jcontroller
import repro.tunedb.fleet as jfleet
import repro.tunedb.obs.metrics as jmetrics
import repro.tunedb.obs.snapshot as jsnapshot
import repro.tunedb.obs.trace as jtrace
import repro.tunedb.plans as jplans
import repro.tunedb.store as jstore
import repro.tunedb.telemetry as jtel
from repro.tunedb.__main__ import main as jcli_main
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.core.space import gemm_input
from repro_torch.models import init_params
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import router as trouter
from repro_torch.tunedb import controller as tcontroller
from repro_torch.tunedb import fleet as tfleet
from repro_torch.tunedb import plans as tplans
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb import telemetry as ttel
from repro_torch.tunedb.__main__ import main as tcli_main
from repro_torch.tunedb.obs import snapshot as tsnapshot
from repro_torch.tunedb.obs import trace as ttrace
from repro_torch.tunedb.obs.metrics import get_registry, reset_metrics

CFG = {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
       "order": 0, "acc32": 1, "prefetch": 2}

JAX = types.SimpleNamespace(
    router=jrouter, fleet=jfleet, store=jstore, tel=jtel, plans=jplans,
    controller=jcontroller, snapshot=jsnapshot, trace=jtrace,
    cli=jcli_main)
PORT = types.SimpleNamespace(
    router=trouter, fleet=tfleet, store=tstore, tel=ttel, plans=tplans,
    controller=tcontroller, snapshot=tsnapshot, trace=ttrace,
    cli=tcli_main)
BOTH = [JAX, PORT]
# run-to-run fields: times, ages, paths, process-made ids
VOLATILE = {"created_at", "updated_at", "age_s", "lag_s", "root", "store",
            "registry", "name", "lease_age_s", "wall_s", "jobs_per_s",
            "published_at", "installed_at", "out_dir", "path"}


def _reset():
    tstore.install_serving(store=None, models=None, fingerprint=None)
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    ttel.clear_telemetry()
    jtel.clear_telemetry()
    ttrace.reset_tracing()
    jtrace.reset_tracing()
    reset_metrics()
    jmetrics.reset_metrics()
    for f in tplans.active_followers():
        f.stop()
    for f in jplans.active_followers():
        f.stop()


@pytest.fixture(autouse=True)
def _clean_globals():
    _reset()
    yield
    _reset()


def _shape(i: int):
    return gemm_input(256 * (i + 1), 64, 512)


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in VOLATILE}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _plan(pkg, shapes, generation=0):
    table = {("gemm", pkg.store.shape_key(s)): (dict(CFG), "exact")
             for s in shapes}
    return pkg.store.DispatchPlan(generation=generation, fingerprint="test",
                                  store_version=-1, table=table)


# ---------------------------------------------------------------------------
# fleet-global telemetry
# ---------------------------------------------------------------------------

def test_view_aggregates_concurrent_writers_as_the_reference(tmp_path):
    """Three replicas, four ring writers each, dumped while they write and
    once after: the port's view counts every call, and equals the
    reference's view of the same dumps, shape by shape."""
    bus = tmp_path / "telemetry"
    replicas = [ttel.ShapeTelemetry() for _ in range(3)]

    def writer(tel, tid):
        for j in range(200):
            tel.record_buffered("gemm", _shape((tid + j) % 5))

    exporters = [ttel.TelemetryExporter(tel, bus, worker_id=f"w{i}")
                 for i, tel in enumerate(replicas)]
    threads = [threading.Thread(target=writer, args=(tel, tid))
               for tel in replicas for tid in range(4)]
    for th in threads:
        th.start()
    for exp in exporters:
        exp.export_once()                   # while the writers land
    for th in threads:
        th.join()
    for exp in exporters:
        exp.export_once()
    tview = ttel.FleetTelemetryView(bus, local=ttel.ShapeTelemetry(),
                                    refresh_s=0.0)
    jview = jtel.FleetTelemetryView(bus, local=jtel.ShapeTelemetry(),
                                    refresh_s=0.0)
    assert tview.total() == jview.total() == 3 * 4 * 200
    for i in range(5):
        want = sum(tel.count("gemm", _shape(i)) for tel in replicas)
        assert tview.count("gemm", _shape(i)) == want
        assert jview.count("gemm", _shape(i)) == want
    assert tview.hot_shapes("gemm", 5) == jview.hot_shapes("gemm", 5)
    assert _strip(tview.replicas()) == _strip(jview.replicas())
    assert tview.stats()["scope"] == "fleet"


def test_cumulative_torn_and_own_dumps_as_the_reference(tmp_path):
    out = []
    for pkg in BOTH:
        bus = tmp_path / pkg.tel.__name__
        tel = pkg.tel.ShapeTelemetry()
        exp = pkg.tel.TelemetryExporter(tel, bus, worker_id="me", keep=2)
        tel.record("gemm", _shape(0), n=10)
        exp.export_once()
        tel.record("gemm", _shape(0), n=5)
        exp.export_once()
        tel.record("gemm", _shape(0), n=1)
        exp.export_once()                   # prunes to the newest two
        files = [f.stem for f in sorted((bus / "me").glob("*.json"))]
        peer = pkg.tel.ShapeTelemetry()
        peer.record("gemm", _shape(0), n=7)
        pexp = pkg.tel.TelemetryExporter(peer, bus, worker_id="peer",
                                         keep=3)
        pexp.export_once()
        peer.record("gemm", _shape(0), n=3)
        pexp.export_once().write_text("{not json")     # a torn dump
        view = pkg.tel.FleetTelemetryView(bus, local=tel, refresh_s=0.0,
                                          exclude={"me"})
        out.append((files, view.count("gemm", _shape(0)),
                    _strip(view.replicas()), view.total()))
    assert out[1] == out[0]
    assert out[1][0] == ["00000002", "00000003"]
    assert out[1][1] == 16 + 7              # own live counts, peer's older


def test_controller_triggers_off_the_aggregated_mass(tmp_path):
    out = []
    for pkg in BOTH:
        bus = tmp_path / pkg.tel.__name__
        store = pkg.store.RecordStore()
        local = pkg.tel.ShapeTelemetry()
        cfg = pkg.controller.RetuneConfig(min_calls=32)
        fleet_ctl = pkg.controller.RetuneController(
            store, telemetry=pkg.tel.FleetTelemetryView(
                bus, local=local, refresh_s=0.0), cfg=cfg)
        local_ctl = pkg.controller.RetuneController(store, telemetry=local,
                                                    cfg=cfg)
        local.record("gemm", _shape(0), n=5)
        for i in range(3):
            tel = pkg.tel.ShapeTelemetry()
            tel.record("gemm", _shape(0), n=15)
            pkg.tel.TelemetryExporter(tel, bus,
                                      worker_id=f"peer{i}").export_once()
        dl, df = local_ctl.check()["gemm"], fleet_ctl.check()["gemm"]
        out.append((dl.trigger, df.trigger, df.reason, df.window_calls,
                    fleet_ctl.stats()["telemetry_scope"]))
    assert out[1] == out[0]
    assert out[1][:2] == (False, True) and out[1][3] == 50


# ---------------------------------------------------------------------------
# affinity classes and replica plans
# ---------------------------------------------------------------------------

HOT = [(gemm_input(4096, 64, 512), 100), (gemm_input(4097, 64, 512), 80),
       (gemm_input(256, 64, 512), 90), (gemm_input(16, 64, 512), 10),
       (gemm_input(32, 576, 576), 60), (gemm_input(4, 576, 576), 240)]


@pytest.mark.parametrize("n_replicas", [1, 2, 3])
def test_partition_hot_shapes_matches_the_reference(tmp_path, n_replicas):
    out = []
    for pkg in BOTH:
        tmp = tmp_path / pkg.fleet.__name__
        coord = pkg.fleet.Coordinator(
            tmp / "fleet", pkg.store.RecordStore.open(tmp / "db.jsonl"))
        tel = pkg.tel.ShapeTelemetry()
        for x, n in HOT:
            tel.record("gemm", x, n=n)
        out.append(coord.partition_hot_shapes(n_replicas, telemetry=tel,
                                              top_k=8))
    assert out[1] == out[0]
    assert sum(len(c) for c in out[1]) == len(HOT)


def _replica_plans(pkg, tmp):
    store = pkg.store.RecordStore.open(tmp / "db.jsonl")
    for i, (x, _) in enumerate(HOT):
        store.add(pkg.store.TuneRecord(space="gemm", inputs=x,
                                       config=dict(CFG, bm=16 << (i % 3)),
                                       tflops=100.0 + i, backend="test",
                                       created_at=1.0 + i))
    coord = pkg.fleet.Coordinator(tmp / "fleet", store)
    tel = pkg.tel.ShapeTelemetry()
    for x, n in HOT:
        tel.record("gemm", x, n=n)
    summary = coord.publish_replica_plans(tmp / "registries", 2,
                                          telemetry=tel, fingerprint="test")
    digests = [pkg.plans.PlanRegistry(s["registry"]).current()["digest"]
               for s in summary if s["generation"] is not None]
    return _strip(summary), digests


def test_replica_plans_match_the_reference(tmp_path):
    out = [_replica_plans(pkg, tmp_path / pkg.fleet.__name__)
           for pkg in BOTH]
    assert out[1] == out[0]
    summary, digests = out[1]
    assert [s["replica"] for s in summary] == ["replica-0", "replica-1"]
    assert len(digests) == 2 and all(d.startswith("sha256:")
                                     for d in digests)


def test_fleet_route_cli_matches_the_reference(tmp_path):
    """``fleet route`` over the two replica registries: a request's shapes
    land on the replica that covers them, the same answer in both."""
    outs = []
    for pkg in BOTH:
        tmp = tmp_path / pkg.fleet.__name__
        _replica_plans(pkg, tmp)
        for shape in ("M=4096,N=64,K=512", "M=16,N=64,K=512"):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = pkg.cli(["fleet", "route", "--registry-root",
                              str(tmp / "registries"), "--space", "gemm",
                              "--shape", shape])
            assert rc == 0
            outs.append(json.loads(buf.getvalue()))
    assert outs[2:] == outs[:2]
    for got in outs[2:]:
        assert got["coverage"][got["replica"]] == max(
            got["coverage"].values()) == 1.0
        assert got["outcome"] == "affinity"


# ---------------------------------------------------------------------------
# routers
# ---------------------------------------------------------------------------

def test_plan_coverage_matches_the_reference():
    for shapes in ([("gemm", _shape(0))],
                   [("gemm", _shape(0)), ("gemm", _shape(3))],
                   [("gemm", _shape(3))], []):
        cov = [pkg.router.plan_coverage(_plan(pkg, [_shape(0), _shape(1)]),
                                        shapes) for pkg in BOTH]
        assert cov[1] == cov[0]
    assert trouter.plan_coverage(None, [("gemm", _shape(0))]) == 0.0


def _stream(pkg, policy, **kw):
    """A skewed request stream over three replicas with live loads: the
    names picked, the outcomes, the replicas' stats."""
    r = pkg.router.make_router(policy, **kw)
    load = {"a": 0, "b": 0, "c": 0}
    r.add_replica("a", plan=_plan(pkg, [_shape(0), _shape(1)]),
                  load=lambda: load["a"])
    r.add_replica("b", plan=_plan(pkg, [_shape(1)]), load=lambda: load["b"])
    r.add_replica("c", plan=None, load=lambda: load["c"])
    picks = []
    for step in range(40):
        cls = [0, 0, 1, 4, 0][step % 5]
        reqs = [("gemm", _shape(cls))]
        if step % 7 == 0:
            reqs.append(("gemm", _shape(1)))
        picked = r.route(reqs).name
        load[picked] += 1
        if step % 3 == 0:                   # some requests finish
            busiest = max(load, key=load.get)
            load[busiest] -= 1
        picks.append(picked)
    return picks, _strip(r.stats())


@pytest.mark.parametrize("policy,kw", [
    ("affinity", {}), ("affinity", {"max_imbalance": 1.0}),
    ("round_robin", {}), ("random", {}), ("random", {"seed": 7})])
def test_router_decisions_match_the_reference(policy, kw):
    got = [_stream(pkg, policy, **kw) for pkg in BOTH]
    assert got[1] == got[0]
    picks, stats = got[1]
    assert len(picks) == stats["decisions"] == 40
    if policy == "affinity":
        assert set(stats["outcomes"]) <= {"affinity", "balanced", "escape"}
        assert stats["outcomes"].get("escape", 0) >= 1   # class 4: no plan


def test_affinity_router_load_bound_escape_and_no_starvation():
    r = trouter.ShapeAffinityRouter(max_imbalance=2.0)
    ra = r.add_replica("a", plan=_plan(PORT, [_shape(0), _shape(1)]))
    r.add_replica("b", plan=_plan(PORT, [_shape(1)]))
    req = [("gemm", _shape(0)), ("gemm", _shape(1))]
    names = [r.route(req).name for _ in range(6)]
    assert "b" in names and r.outcomes.get("balanced", 0) > 0
    assert ra.assigned + names.count("b") == 6
    assert r.route([("gemm", _shape(4))]) is not None
    assert r.outcomes["escape"] == 1
    hot = trouter.ShapeAffinityRouter(max_imbalance=4.0)
    hot.add_replica("hot", plan=_plan(PORT, [_shape(i) for i in range(4)]))
    hot.add_replica("cold", plan=None)
    for step in range(100):
        assert hot.route([("gemm", _shape(step % 5))]) is not None
    loads = {x.name: x.assigned for x in hot.replicas}
    assert abs(loads["hot"] - loads["cold"]) <= 5
    text = get_registry().render_prometheus()
    assert 'tunedb_router_decisions_total{outcome="escape",' \
           'policy="affinity"}' in text


def test_router_factory_refusals():
    assert isinstance(trouter.make_router("affinity"),
                      trouter.ShapeAffinityRouter)
    with pytest.raises(ValueError, match="unknown router policy"):
        trouter.make_router("bogus")
    with pytest.raises(RuntimeError, match="no replicas"):
        trouter.make_router("affinity").route([])
    assert sorted(trouter.ROUTER_POLICIES) == sorted(jrouter.ROUTER_POLICIES)


# ---------------------------------------------------------------------------
# /status: the fleet, follower and router sections
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self):
        self.space = types.SimpleNamespace(name="gemm")
        self.backend = types.SimpleNamespace(noise=0.0)

    def search(self, inputs, remeasure=True):
        return types.SimpleNamespace(best=dict(CFG), predicted_tflops=5.0,
                                     measured_tflops=5.0,
                                     measured=[(dict(CFG), 5.0)])


def _sections(pkg, tmp):
    store = pkg.store.RecordStore.open(tmp / "db.jsonl")
    coord = pkg.fleet.Coordinator(tmp / "fleet", store)
    coord.publish([pkg.fleet.FleetJob(space="gemm", inputs=_shape(i),
                                      count=i) for i in range(3)])
    w = pkg.fleet.Worker(tmp / "fleet", worker_id="w0",
                         tuners={"gemm": _Stub()})
    assert w.run_one() is True
    coord.fleet.claim()                     # one lease left in flight
    coord.poll()
    coord.report(wall_s=1.0)
    tel = pkg.tel.ShapeTelemetry()
    tel.record("gemm", _shape(0), n=9)
    pkg.tel.TelemetryExporter(tel, coord.fleet.telemetry_dir(),
                              worker_id="rep0").export_once()
    reg = pkg.plans.PlanRegistry(tmp / "reg")
    reg.publish(_plan(pkg, [_shape(0)]))
    follower = pkg.plans.PlanFollower(reg, fingerprint="test")
    assert follower.poll_once() is not None
    router = pkg.router.make_router("affinity")
    router.add_replica("local", plan=lambda: pkg.store.serving_state().plan,
                       load=0)
    router.route([("gemm", _shape(0))])
    doc = pkg.snapshot.status_snapshot(fleet=str(tmp / "fleet"),
                                       router=router)
    follower.stop()
    return {k: _strip(doc[k]) for k in ("fleet", "follower", "router")}


def test_status_sections_match_the_reference(tmp_path):
    jdoc = _sections(JAX, tmp_path / "jax")
    tdoc = _sections(PORT, tmp_path / "port")
    assert tdoc == jdoc
    assert tdoc["fleet"]["counts"] == {"queue": 1, "leases": 1, "done": 1,
                                       "failed": 0}
    assert tdoc["fleet"]["report"]["merged_records"] == 1
    assert tdoc["fleet"]["telemetry_replicas"]["rep0"]["calls"] == 9
    assert tdoc["follower"]["installs"] == 1
    assert tdoc["router"]["outcomes"] == {"affinity": 1}
    assert tsnapshot.status_snapshot(fleet=str(tmp_path / "nope"))[
        "fleet"] is None


def test_fleet_metrics_match_the_reference(tmp_path):
    def families(pkg, reg, tmp):
        store = pkg.store.RecordStore.open(tmp / "db.jsonl")
        coord = pkg.fleet.Coordinator(tmp / "fleet", store, sentry_margin=0.1)
        coord.publish([pkg.fleet.FleetJob(space="gemm", inputs=_shape(0))])
        w = pkg.fleet.Worker(tmp / "fleet", worker_id="w0",
                             tuners={"gemm": _Stub()})
        w.run_one()
        coord.poll()
        coord.report(wall_s=1.0)
        snap = reg().snapshot()
        return {k: [s for s in v["samples"]] for k, v in snap.items()
                if k.startswith(("tunedb_fleet", "tunedb_worker"))}
    j = families(JAX, jmetrics.get_registry, tmp_path / "jax")
    t = families(PORT, get_registry, tmp_path / "port")
    assert t == j
    assert set(t) == {"tunedb_fleet_jobs", "tunedb_fleet_merged_records",
                      "tunedb_fleet_requeued", "tunedb_fleet_sentry_blocked",
                      "tunedb_worker_jobs_total"}


# ---------------------------------------------------------------------------
# the four span names
# ---------------------------------------------------------------------------

def _fleet_spans(pkg, tmp):
    """Route one request, run a fleet epoch through a thread worker and
    follow one published plan, traced: the new spans' names and
    attribute keys."""
    tr = pkg.trace.enable_tracing(1.0)
    router = pkg.router.make_router("round_robin")
    router.add_replica("a")
    with tr.root("engine.admit"):
        router.route([("gemm", _shape(0))])
    store = pkg.store.RecordStore.open(tmp / "db.jsonl")
    pkg.store.install_serving(store=store)
    ctl = pkg.controller.RetuneController(
        store, fleet_dir=tmp / "fleet", fleet_poll_s=0.02,
        fleet_timeout_s=30, cfg=pkg.controller.RetuneConfig(
            min_calls=8, top_k_shapes=1, retrain=False,
            publish=str(tmp / "reg")))
    tel = pkg.tel.get_telemetry()
    for _ in range(40):
        tel.record("gemm", _shape(0))
    ctl.maybe_retune()
    deadline = time.time() + 30
    while not list((tmp / "fleet" / "queue").glob("*.json")) \
            and time.time() < deadline:
        time.sleep(0.02)
    worker = pkg.fleet.Worker(tmp / "fleet", worker_id="w0",
                              tuners={"gemm": _Stub()}, poll_s=0.01)
    worker.run(idle_timeout_s=0.2)
    report = ctl.wait_async(timeout=30)
    assert report is not None and report.tuned == 1
    follower = pkg.plans.PlanFollower(tmp / "reg")
    follower._install = lambda plan, pointer: True
    assert follower.poll_once() is not None
    follower.stop()
    tr.drain()
    spans = tr.spans()
    keys = {sp.name: sorted(sp.attrs) for sp in spans
            if sp.name in ("request.route", "fleet.job", "fleet.merge",
                           "plan.install", "retune.epoch")}
    epoch = next(sp for sp in spans if sp.name == "retune.epoch")
    joined = {sp.name for sp in spans if sp.trace_id == epoch.trace_id}
    pkg.trace.reset_tracing()
    return keys, sorted(joined)


def test_fleet_span_names_match_the_reference(tmp_path):
    j = _fleet_spans(JAX, tmp_path / "jax")
    _reset()
    t = _fleet_spans(PORT, tmp_path / "port")
    assert t == j
    keys, joined = t
    assert set(keys) == {"request.route", "fleet.job", "fleet.merge",
                         "plan.install", "retune.epoch"}
    # the worker's job and the merge sit in the epoch's trace
    assert {"fleet.job", "fleet.merge", "retune.epoch"} <= set(joined)


def test_collect_fleet_spans_reads_worker_dumps(tmp_path):
    tr = ttrace.enable_tracing(1.0)
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=_shape(0),
                                   trace_id="feedface00000001")])
    coord.fleet.request_drain()
    w = tfleet.Worker(tmp_path / "fleet", worker_id="wp",
                      tuners={"gemm": _Stub()}, trace_export=True)
    w.run()
    dump = tmp_path / "fleet" / "traces" / "wp.jsonl"
    assert dump.exists()
    with dump.open("a") as fh:
        fh.write('{"name": "fleet.job", "trace_id": "x", "spa')  # torn
    spans = ttrace.collect_fleet_spans(tmp_path / "fleet")
    jspans = jtrace.collect_fleet_spans(tmp_path / "fleet")
    assert [(s.name, s.trace_id) for s in spans] == \
        [(s.name, s.trace_id) for s in jspans]
    assert ("fleet.job", "feedface00000001") in [(s.name, s.trace_id)
                                                 for s in spans]
    assert ttrace.collect_fleet_spans(tmp_path / "none") == []
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli_main(["trace", "summary", "--fleet",
                          str(tmp_path / "fleet"), "--json"]) == 0
    assert json.loads(buf.getvalue())["names"]["fleet.job"]["count"] == 1
    assert tr is ttrace.get_tracer()


# ---------------------------------------------------------------------------
# the engine's wiring
# ---------------------------------------------------------------------------

def test_engine_wires_export_router_follower_and_status(tmp_path):
    """The SMOKE engine with a fleet bus, telemetry export, a router and a
    follower: dumps land on the bus, the controller reads the fleet view,
    each admission routes (``request.route`` spans), the follower installs
    a published plan, and ``/status`` carries all three sections."""
    cfg = tconfigs.SMOKE
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    db = tmp_path / "db.jsonl"
    tstore.RecordStore.open(db).add(tstore.TuneRecord(
        space="gemm", inputs=_shape(0), config=dict(CFG), tflops=1.0,
        backend="test"))
    reg = tplans.PlanRegistry(tmp_path / "reg")
    reg.publish(_plan(PORT, [_shape(0)]))
    eng = Engine(cfg, params, ServeConfig(
        max_len=64, slots=2, tunedb=str(db), retune_interval=4,
        retune_fleet=str(tmp_path / "fleet"), telemetry_export_s=0.05,
        router="affinity", follow=str(tmp_path / "reg"),
        follow_interval_s=0.05, follow_sentry=None, status_port=0,
        trace_sample=1.0), device="cpu")
    try:
        assert eng.controller is not None and eng.controller.async_mode
        assert eng.controller.stats()["telemetry_scope"] == "fleet"
        rng = np.random.default_rng(0)
        outs = eng.generate([rng.integers(0, cfg.vocab, 6)
                             for _ in range(4)], max_new=6)
        assert all(len(o) == 6 for o in outs)
        assert eng.router.stats()["decisions"] == 4
        assert eng._prefill_shapes[6]           # kept for the router
        deadline = time.time() + 10
        while eng.follower.installs == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert eng.follower.installs == 1
        snap = eng.status_server.status_json()
        assert snap["router"]["replicas"][0]["name"] == "local"
        assert snap["follower"]["generation"] == 1
        assert snap["fleet"]["root"] == str(tmp_path / "fleet")
        assert eng.exporter.worker_id in snap["fleet"]["telemetry_replicas"]
        names = {s.name for s in eng.tracer.spans()}
        assert "request.route" in names and "plan.install" in names
        text = eng.status_server.metrics_text()
        assert "tunedb_follower_installs_total" in text
        assert "tunedb_router_decisions_total" in text
    finally:
        eng.follower.stop()
        eng.exporter.stop()
        eng.status_server.stop()
        if eng.controller.async_active():
            eng.controller._async_cancel.set()
            eng.controller.wait_async(timeout=30)
