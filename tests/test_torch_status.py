"""The port's status endpoint (``repro_torch.tunedb.obs.{snapshot,server}``)
and the engine's ``status_port`` / ``trace_sample`` against the JAX
package's.

The same records installed in both packages give the same ``/status`` and
``/plan`` documents; a live SMOKE engine answers every route (``/healthz``
503 while it sheds load); ``stats --json`` and ``serve-status`` serve the
same schema; ``trace_sample=0`` makes no tracer call over a ``generate``;
two threads draining the telemetry at once lose no call; and the metrics
publishers this slice adds count what the reference's count."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.serve.engine as jengine
import repro.tunedb.obs.metrics as jmetrics
import repro.tunedb.obs.snapshot as jsnapshot
import repro.tunedb.obs.trace as jtrace
import repro.tunedb.store as jstore
import repro.tunedb.telemetry as jtel
import repro_torch.serve.engine as tengine
from repro.configs import smollm_135m as jconfigs
from repro.core.backend import HBM_GBPS, PEAK_BF16_TFLOPS, PEAK_FP32_TFLOPS
from repro.models import init_params as jinit_params
from repro.tunedb.__main__ import main as jcli_main
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.core.backend import Peaks
from repro_torch.core.space import gemm_input
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb import telemetry as ttel
from repro_torch.tunedb.__main__ import main as tcli_main
from repro_torch.tunedb.obs import (StatusServer, Tracer, get_registry,
                                    plan_snapshot, reset_metrics,
                                    reset_tracing, status_snapshot)
from repro_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
CFG = {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
       "order": 0, "acc32": 1, "prefetch": 2}
FP = "test"
# times and ids: they differ run to run (the serving generation counts the
# process's installs)
VOLATILE = {"compile_ms", "created_at", "path", "generation",
            "tunedb_serving_generation", "tunedb_plan_generation"}


def _reset():
    reset_tracing()
    jtrace.reset_tracing()
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


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in VOLATILE}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _records(mod, shapes):
    return [mod.TuneRecord(space="gemm", inputs=x, config=dict(CFG, bm=bm),
                           tflops=tflops, backend=FP, created_at=1000.0 + i)
            for i, (x, bm, tflops) in enumerate(shapes)]


SHAPES = [(gemm_input(4, 576, 576), 64, 120.0),
          (gemm_input(32, 576, 576), 128, 300.0),
          (gemm_input(4, 1536, 576), 64, 150.0),
          (gemm_input(32, 192, 576), 32, 90.0)]


@pytest.mark.parametrize("build_plan", [True, False])
def test_snapshots_match_the_reference(build_plan):
    """The same records and telemetry installed through ``install_serving``
    in both packages, a few resolutions on each tier: the same
    ``status_snapshot()`` and ``plan_snapshot()`` (times and paths removed;
    the port's ``fleet``, ``follower`` and ``router`` are null)."""
    from repro.kernels import dispatch as jdispatch
    from repro_torch.kernels import dispatch as tdispatch
    for mod, tel, disp in ((jstore, jtel, jdispatch),
                           (tstore, ttel, tdispatch)):
        store = mod.RecordStore()
        for rec in _records(mod, SHAPES):
            store.add(rec)
        for x, _, _ in SHAPES[:2]:
            tel.record_shape("gemm", x)
        tel.record_shape("gemm", gemm_input(8, 576, 576))
        mod.install_serving(store=store, fingerprint=FP,
                            build_plan=build_plan)
        for x in (SHAPES[0][0], SHAPES[1][0], gemm_input(8, 576, 576),
                  gemm_input(16, 576, 576)):
            disp._tuned_cfg("gemm", x)
    jdoc, tdoc = jsnapshot.status_snapshot(), status_snapshot()
    assert (tdoc["fleet"], tdoc["follower"], tdoc["router"]) == (None,) * 3
    # the reference's collector files every entry, promoted ones too, under
    # origin="built"; the port's files the compiled ones there
    entries = {s["labels"]["origin"]: s["value"] for s in
               tdoc["metrics"].pop("tunedb_plan_entries", {"samples": []}
                                   )["samples"]}
    jentries = jdoc["metrics"].pop("tunedb_plan_entries", None)
    if build_plan:
        assert entries == {"built": 5.0, "promoted": 1.0}
        assert jentries["samples"][0]["value"] == 6.0
    assert _strip(tdoc) == _strip(jdoc)
    assert tdoc["tiers"]["counts"]["exact"] == 2
    assert _strip(plan_snapshot()) == _strip(jsnapshot.plan_snapshot())
    if build_plan:
        origins = {e["origin"] for e in plan_snapshot()["entries"]}
        assert origins == {"built", "promoted"}
    assert plan_snapshot(cap=1)["truncated"] is build_plan


def test_metrics_publishers_count_what_the_reference_counts():
    """Installs (``tunedb_installs_total``, ``tunedb_plan_built_entries``)
    and store-aware admission's bucket decisions: the same calls in both
    packages, the same series."""
    from repro.serve.engine import StoreAwareAdmission as JAdmission
    from repro_torch.serve.engine import StoreAwareAdmission as TAdmission
    ref_peaks = Peaks(PEAK_BF16_TFLOPS, PEAK_FP32_TFLOPS, HBM_GBPS)
    adms = {"jax": JAdmission(), "port": TAdmission(peaks=ref_peaks)}
    for k, mod in (("jax", jstore), ("port", tstore)):
        store = mod.RecordStore()
        for rec in _records(mod, SHAPES):
            store.add(rec)
        mod.install_serving(store=store, fingerprint=FP)
        mod.install_serving(store=store, fingerprint=FP, build_plan=False)
        mod.install_serving(store=store, fingerprint=FP)
        for m in (4, 8, 16, 32, 48):
            adms[k].bucket("gemm", gemm_input(m, 576, 576))

    def series(snap):
        return {name: snap[name] for name in (
            "tunedb_installs_total", "tunedb_plan_built_entries",
            "tunedb_admission_decisions_total")}

    jgot = series(jmetrics.get_registry().snapshot())
    tgot = series(get_registry().snapshot())
    assert tgot == jgot
    text = get_registry().render_prometheus()
    assert 'tunedb_installs_total{planned="no"} 1' in text
    assert 'tunedb_plan_built_entries 4' in text


class _Clock:
    """A monotonic clock that moves one second a call."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        self.now += 1.0
        return self.now

    def perf_counter(self):
        return self.now

    def thread_time(self):
        return 0.0


def _both_params():
    jp = jinit_params(jconfigs.SMOKE, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         tconfigs.SMOKE, "cpu")
    return jp, tp


@pytest.mark.parametrize("sc_kw,n_req,clock", [
    ({"shed_threshold": 3}, 6, False),
    ({"request_deadline_s": 0.0}, 3, False),
    ({"request_deadline_s": 3.5}, 3, True),
])
def test_degradation_counters_match_the_reference(monkeypatch, sc_kw, n_req,
                                                  clock):
    """Shedding and the deadline (rejected unserved, retired mid-serve)
    counted in ``tunedb_requests_shed_total`` and
    ``tunedb_request_deadline_exceeded_total{state}`` as the reference's
    engine counts them."""
    jp, tp = _both_params()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tconfigs.SMOKE.vocab, 5) for _ in range(n_req)]
    got = {}
    for k, mod, make in (
            ("jax", jengine, lambda: jengine.Engine(
                jconfigs.SMOKE, jp, jengine.ServeConfig(
                    max_len=64, slots=2, **sc_kw))),
            ("port", tengine, lambda: tengine.Engine(
                tconfigs.SMOKE, tp, tengine.ServeConfig(
                    max_len=64, slots=2, **sc_kw), device="cpu"))):
        if clock:
            monkeypatch.setattr(mod, "time", _Clock())
        make().generate(prompts, max_new=6)
        snap = (jmetrics.get_registry() if k == "jax"
                else get_registry()).snapshot()
        got[k] = {name: snap.get(name) for name in (
            "tunedb_requests_shed_total",
            "tunedb_request_deadline_exceeded_total")}
    assert got["port"] == got["jax"]
    assert any(v for v in got["port"].values())


def _get(url):
    """(status, body) of one GET; an HTTP error's code and reason."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.reason


def _smoke_store(path):
    store = tstore.RecordStore.open(path)
    for rec in _records(tstore, [(gemm_input(4, 64, 64), 32, 50.0)]):
        store.add(rec)


def test_live_engine_serves_every_route(tmp_path):
    """A SMOKE engine with ``status_port=0`` and ``trace_sample=1``: every
    route answers from another thread while it serves; ``/status`` has the
    reference's keys, ``/trace`` the four span names, ``/metrics`` the
    ``tunedb_*`` series; ``/healthz`` answers 503 while the engine sheds."""
    _, tp = _both_params()
    _smoke_store(tmp_path / "db.jsonl")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)     # untuned shapes
        eng = tengine.Engine(tconfigs.SMOKE, tp, tengine.ServeConfig(
            max_len=64, slots=2, trace_sample=1.0, status_port=0,
            shed_threshold=3, tunedb=str(tmp_path / "db.jsonl"),
            tunedb_backend=FP), device="cpu")
        try:
            url = eng.status_server.url
            assert eng.status_server.port > 0
            assert _get(url + "/healthz") == (200, "ok\n")
            health = []
            real_poll = eng.maybe_retune

            def poll():             # every tick, from the serving thread
                health.append((eng.shedding,
                               _get(url + "/healthz")[0]))
                return real_poll()

            eng.maybe_retune = poll
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, 64, n) for n in (5, 9, 3, 7, 4, 6)]
            outs = eng.generate(prompts, max_new=4)
            assert [len(o) for o in outs] == [4, 4, 4, 0, 0, 0]
            assert (True, 503) in health and (False, 200) in health
            assert all(code == (503 if shed else 200)
                       for shed, code in health)
            assert _get(url + "/healthz") == (200, "ok\n")

            code, body = _get(url + "/status")
            assert code == 200
            doc = json.loads(body)
            ref = jsnapshot.status_snapshot()
            assert set(doc) == set(ref)
            assert set(doc["serving"]) == set(ref["serving"])
            assert doc["schema"] == 1 and doc["trace"]["enabled"] is True
            # a root a tick, an admission each, the start-up probe
            assert doc["trace"]["sampled"] == (eng.ticks + len(eng.admitted)
                                               + 1)

            code, body = _get(url + "/trace")
            assert code == 200
            trace = json.loads(body)
            assert trace["otherData"]["schema"] == 1
            names = {ev["name"] for ev in trace["traceEvents"]}
            assert {"engine.admit", "engine.prefill", "engine.tick",
                    "dispatch.resolve", "dispatch.probe"} <= names
            assert all("tier" in ev["args"] for ev in trace["traceEvents"]
                       if ev["name"] == "dispatch.resolve")

            code, body = _get(url + "/metrics")
            assert code == 200
            for name in ("tunedb_serving_generation",
                         "tunedb_store_lookups_total",
                         "tunedb_plan_lookups_total",
                         "tunedb_telemetry_calls_total",
                         "tunedb_installs_total",
                         "tunedb_plan_built_entries",
                         "tunedb_requests_shed_total"):
                assert f"\n{name}" in body, name

            code, body = _get(url + "/plan")
            assert code == 200
            assert json.loads(body)["generation"] == \
                tstore.serving_state().generation
            assert _get(url + "/nope")[0] == 404
        finally:
            eng.status_server.stop()
    reset_tracing()
    srv = StatusServer(port=0).start()
    try:
        assert _get(srv.url + "/trace")[0] == 404       # tracing off
        assert _get(srv.url + "/healthz")[0] == 200
    finally:
        srv.stop()


def test_trace_sample_0_makes_no_tracer_call(monkeypatch):
    """E18.1 on the port: with ``trace_sample=0`` (tracing off) a
    ``generate`` calls no ``Tracer`` method; the same count with
    ``trace_sample=1`` is not zero (the counter counts)."""
    _, tp = _both_params()
    calls = []
    for name in ("root", "span", "begin", "end"):
        real = getattr(Tracer, name)

        def counted(self, *a, _real=real, **k):
            calls.append(1)
            return _real(self, *a, **k)

        monkeypatch.setattr(Tracer, name, counted)
    prompts = [np.arange(5), np.arange(9), np.arange(3)]
    counts = {}
    for sample in (0.0, 1.0):
        eng = tengine.Engine(tconfigs.SMOKE, tp, tengine.ServeConfig(
            max_len=64, slots=2, trace_sample=sample), device="cpu")
        calls.clear()
        eng.generate(prompts, max_new=4)
        counts[sample] = len(calls)
        assert (eng.tracer is None) == (sample == 0.0)
    assert counts[0.0] == 0 and counts[1.0] > 0


def test_two_drainers_lose_no_telemetry_call():
    """Writers on more threads than cores fill their rings while two
    threads drain at once (the status endpoint's snapshot and the serving
    tick): every call is counted exactly once."""
    tel = ttel.ShapeTelemetry()
    writers, per_writer = 8, 3000
    stop = threading.Event()
    x = gemm_input(4, 576, 576)

    def write():
        for _ in range(per_writer):
            tel.record_buffered("gemm", x)

    def drain():
        while not stop.is_set():
            tel.drain_pending()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        drainers = [threading.Thread(target=drain) for _ in range(2)]
        threads = [threading.Thread(target=write) for _ in range(writers)]
        for t in drainers + threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        for t in drainers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in drainers + threads)
    tel.drain_pending()
    assert tel.count("gemm", x) == writers * per_writer
    assert tel.total() == writers * per_writer


def _write_store(path):
    store = jstore.RecordStore.open(path)
    for rec in _records(jstore, SHAPES):
        store.add(rec)


def test_stats_json_prints_the_status_schema(tmp_path, capsys):
    """``stats --json`` prints ``status_snapshot``'s document for the store
    and a telemetry dump, as the reference's CLI does."""
    db = tmp_path / "db.jsonl"
    _write_store(db)
    tel = tmp_path / "tel.json"
    t = ttel.ShapeTelemetry()
    t.record("gemm", SHAPES[0][0], n=5)
    t.save(tel)
    outs = {}
    for k, main in (("jax", jcli_main), ("port", tcli_main)):
        assert main(["stats", "--store", str(db), "--telemetry", str(tel),
                     "--json"]) == 0
        outs[k] = json.loads(capsys.readouterr().out)
    assert _strip(outs["port"]) == _strip(outs["jax"])
    assert outs["port"]["schema"] == 1
    assert outs["port"]["serving"]["store"]["records"] == len(SHAPES)
    assert outs["port"]["telemetry"]["spaces"]["gemm"]["calls"] == 5
    assert tcli_main(["stats", "--store", str(db)]) == 0
    assert set(json.loads(capsys.readouterr().out)) == {"store"}


def test_serve_status_cli_answers_and_stops(tmp_path):
    """``serve-status`` on an ephemeral port: ``/status`` and ``/plan``
    read the store; Ctrl-C stops it."""
    db = tmp_path / "db.jsonl"
    _write_store(db)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tunedb", "serve-status",
         "--store", str(db), "--backend", FP, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert "status endpoint on http://" in line, proc.stderr.read()
        url = line.split(" on ")[1].split()[0]
        code, body = _get(url + "/status")
        assert code == 200
        assert json.loads(body)["serving"]["store"]["records"] == len(SHAPES)
        code, body = _get(url + "/plan")
        assert code == 200 and len(json.loads(body)["entries"]) == len(SHAPES)
        assert _get(url + "/healthz") == (200, "ok\n")
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    assert proc.returncode == 0
