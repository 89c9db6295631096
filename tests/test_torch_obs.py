"""The port's observability (``repro_torch.tunedb.obs``) against the JAX
package's ``repro.tunedb.obs``: the metrics registry (per-thread counter
shards that lose no increment, ring-buffer quantiles, the Prometheus and
JSON renders, the serving collector, dispatch's degraded-call counter)
and the regression sentry (its reports on the same records, the install
gate, ``tunedb diff``)."""

import json
import os
import sys
import threading
import warnings

import pytest

import repro.tunedb.obs.metrics as jmetrics
import repro.tunedb.obs.sentry as jsentry
import repro.tunedb.store as jstore
from repro.tunedb.obs.snapshot import plan_snapshot as jplan_snapshot
from repro_torch.core.space import gemm_input
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.tunedb import controller as tcontroller
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb.__main__ import main as cli_main
from repro_torch.tunedb.obs import (MetricsRegistry, RegressionSentry,
                                    get_registry, last_report, reset_metrics)
from repro_torch.tunedb.telemetry import clear_telemetry

CFG = {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
       "order": 0, "acc32": 1, "prefetch": 2}


def _reset():
    tstore.install_serving(store=None, models=None, fingerprint=None)
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    clear_telemetry()
    reset_metrics()
    tdispatch.reset_counts()


@pytest.fixture(autouse=True)
def _clean_globals():
    _reset()
    yield
    _reset()


def _rec(mod, m, n, k, *, backend="test", tflops=100.0, **cfg_over):
    return mod.TuneRecord(space="gemm", inputs=gemm_input(m, n, k),
                          config=dict(CFG, **cfg_over), tflops=tflops,
                          backend=backend)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_counter_threaded_writers_lose_no_increments():
    """More writer threads than cores, switching often, and a reader
    merging the shards meanwhile: no increment is lost."""
    counter = get_registry().counter("obs_test_total", "threaded increments")
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 5000

    def worker():
        for _ in range(per_thread):
            counter.inc(space="gemm")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            counter.value(space="gemm")
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert counter.value(space="gemm") == n_threads * per_thread


def test_counter_survives_dead_writer_threads():
    counter = get_registry().counter("obs_dead_total")
    t = threading.Thread(target=lambda: counter.inc(7))
    t.start()
    t.join(30)
    assert not t.is_alive()
    # the dead thread's shard folds into the base on read, once
    assert counter.value() == 7
    assert counter.value() == 7


def test_histogram_quantiles_and_renders_match_the_reference():
    """The same instruments fed the same values render the same
    Prometheus text and JSON snapshot in both packages."""
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        hist = reg.histogram("obs_lat_seconds", "latency")
        for i in range(1, 101):
            hist.observe(float(i))
        reg.counter("obs_calls_total", "calls").inc(3, space="gemm")
        reg.counter("obs_calls_total").inc(space="conv")
        reg.gauge("obs_depth", "depth").set(2.5, queue='a"b')
    q = regs[0].histogram("obs_lat_seconds").quantiles()
    assert q[0.5] == pytest.approx(50, abs=2)
    assert q[0.99] == pytest.approx(99, abs=2)
    text = regs[0].render_prometheus()
    assert "# TYPE obs_lat_seconds summary" in text
    assert 'obs_lat_seconds{quantile="0.5"}' in text
    assert "obs_lat_seconds_count 100" in text
    assert "obs_lat_seconds_sum 5050" in text
    assert 'obs_depth{queue="a\\"b"} 2.5' in text
    assert text == regs[1].render_prometheus()
    assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(TypeError, match="already registered"):
        regs[0].gauge("obs_calls_total")


def test_the_serving_collector_reads_the_stack_counters():
    store = tstore.RecordStore()
    store.add(_rec(tstore, 512, 16, 2048))
    tstore.install_store(store)
    tdispatch._tuned_cfg("gemm", gemm_input(512, 16, 2048))   # a plan hit
    gen = tstore.serving_state().generation
    text = get_registry().render_prometheus()
    assert 'tunedb_store_lookups_total{tier="exact"} 1\n' in text
    assert f"tunedb_serving_generation {gen}\n" in text
    assert f"tunedb_plan_generation {gen}\n" in text
    assert 'tunedb_plan_entries{origin="built"} 1\n' in text
    assert 'tunedb_plan_lookups_total{result="hit"} 1\n' in text
    assert 'tunedb_plan_tier_entries{tier="exact"} 1\n' in text
    snap = get_registry().snapshot()
    assert snap["tunedb_store_records"]["samples"][0]["value"] == 1.0


def test_degraded_calls_warn_once_but_count_every_call():
    tstore.install_store(tstore.RecordStore())     # every shape degrades
    with pytest.warns(RuntimeWarning, match="no launchable record"):
        tdispatch._tuned_cfg("gemm", gemm_input(96, 96, 96))
    with warnings.catch_warnings():
        warnings.simplefilter("error")             # a second warning fails
        tdispatch._tuned_cfg("gemm", gemm_input(96, 96, 96))
        tdispatch._tuned_cfg("gemm", gemm_input(96, 96, 96))
    counter = get_registry().counter("tunedb_dispatch_degraded_calls_total")
    assert counter.value(reason="untuned", space="gemm") == 3
    assert tdispatch.tier_counts[("gemm", "degraded")] == 3


# ---------------------------------------------------------------------------
# the sentry
# ---------------------------------------------------------------------------

def test_sentry_refuses_an_injected_regression_at_install():
    store = tstore.RecordStore()
    store.add(_rec(tstore, 512, 16, 2048, tflops=80.0))
    st1 = tstore.install_serving(store=store)
    store.add(_rec(tstore, 512, 16, 2048, tflops=40.0, bm=128))
    sentry = RegressionSentry(noise_margin=0.10)
    report = sentry.check_supersessions(store,
                                        since_version=st1.plan.store_version)
    assert not report.ok and len(report.regressions) == 1
    assert report.regressions[0].drop == pytest.approx(0.5)
    with pytest.warns(RuntimeWarning, match="sentry refused"):
        st2 = tstore.install_serving(store=store, sentry=sentry)
    assert st2 is st1 and tstore.serving_state() is st1
    assert last_report() is not None and not last_report().ok
    reg = get_registry()
    assert reg.counter("tunedb_sentry_blocked_total").value(
        where="install") == 1
    assert reg.counter("tunedb_sentry_regressions_total").value(
        where="install") == 1
    # the same install without the sentry promotes the regression
    assert tstore.install_serving(store=store).generation == \
        st1.generation + 1


def test_sentry_within_the_margin_promotes():
    store = tstore.RecordStore()
    store.add(_rec(tstore, 512, 16, 2048, tflops=80.0))
    st1 = tstore.install_serving(store=store)
    store.add(_rec(tstore, 512, 16, 2048, tflops=78.0))   # 2.5%: noise
    st2 = tstore.install_serving(store=store, sentry=RegressionSentry(0.10))
    assert st2.generation == st1.generation + 1


def test_supersession_log_skips_load_replays(tmp_path):
    path = tmp_path / "db.jsonl"
    store = tstore.RecordStore(path)
    store.add(_rec(tstore, 512, 16, 2048, tflops=80.0))
    store.add(_rec(tstore, 512, 16, 2048, tflops=90.0))
    store.add(_rec(tstore, 512, 16, 2048, tflops=70.0, backend="other"))
    [sup] = store.supersessions
    assert (sup.version, sup.old.tflops, sup.new.tflops) == (2, 80.0, 90.0)
    assert not tstore.RecordStore.open(path).supersessions


def _pair(mod, pairs):
    """Two stores of ``mod`` holding (m, tflops_old, tflops_new) records."""
    old, new = mod.RecordStore(), mod.RecordStore()
    for m, t_old, t_new in pairs:
        if t_old is not None:
            old.add(_rec(mod, m, 16, 2048, tflops=t_old))
        if t_new is not None:
            new.add(_rec(mod, m, 16, 2048, tflops=t_new, bm=128))
    return old, new


PAIRS = [(512, 80.0, 40.0), (1024, 70.0, 75.0), (2048, 60.0, 59.0),
         (4096, 50.0, None), (128, None, 10.0)]


def test_sentry_reports_match_the_reference():
    """diff_stores, check_supersessions and diff_plans give the
    reference's report on the same records."""
    got, want = [], []
    for mod, sentry_mod, out in ((tstore, None, got), (jstore, jsentry, want)):
        sentry = (RegressionSentry(0.10) if sentry_mod is None
                  else sentry_mod.RegressionSentry(0.10))
        old, new = _pair(mod, PAIRS)
        out.append(sentry.diff_stores(old, new).to_dict())
        store = mod.RecordStore()
        for m, t_old, t_new in PAIRS:
            for t in (t_old, t_new, t_old):
                if t is not None:
                    store.add(_rec(mod, m, 16, 2048, tflops=t))
        out.append(sentry.check_supersessions(store, since_version=2)
                   .to_dict())
    assert got == want
    assert got[0]["checked"] == 3 and got[0]["added"] == 1
    assert got[0]["removed"] == 1 and len(got[0]["regressions"]) == 1
    # plan coverage: the reference's /plan snapshots of two generations
    snaps = []
    for recs in ([(512, 80.0, None), (1024, 70.0, None)],
                 [(512, 80.0, None)]):
        store, _ = _pair(jstore, recs)
        jstore.install_serving(store=store)
        snaps.append(jplan_snapshot())
    jsent = jsentry.RegressionSentry(0.10).diff_plans(*snaps).to_dict()
    assert RegressionSentry(0.10).diff_plans(*snaps).to_dict() == jsent
    assert jsent["removed"] == 1 and not jsent["ok"]


# ---------------------------------------------------------------------------
# tunedb diff
# ---------------------------------------------------------------------------

def _two_stores(tmp_path):
    old = tstore.RecordStore(tmp_path / "old.jsonl")
    new = tstore.RecordStore(tmp_path / "new.jsonl")
    old.add(_rec(tstore, 512, 16, 2048, tflops=80.0))
    new.add(_rec(tstore, 512, 16, 2048, tflops=40.0, bm=128))
    return str(tmp_path / "old.jsonl"), str(tmp_path / "new.jsonl")


def test_diff_cli_exits_nonzero_on_a_regression(tmp_path, capsys):
    old, new = _two_stores(tmp_path)
    assert cli_main(["diff", old, new]) == 1
    out = capsys.readouterr().out
    assert "REGRESSED gemm" in out and "80.00 -> 40.00" in out
    assert "verdict: 1 regression(s)" in out
    assert cli_main(["diff", old, old]) == 0
    assert "verdict: OK" in capsys.readouterr().out


def test_diff_cli_json_golden(tmp_path, capsys):
    old, new = _two_stores(tmp_path)
    assert cli_main(["diff", old, new, "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc == {
        "checked": 1, "improved": 0, "unchanged": 0, "added": 0,
        "removed": 0, "noise_margin": 0.1, "ok": False,
        "regressions": [{
            "space": "gemm", "backend": "test",
            "inputs": gemm_input(512, 16, 2048), "old_tflops": 80.0,
            "new_tflops": 40.0, "old_config": CFG,
            "new_config": dict(CFG, bm=128), "drop": 0.5}]}
    assert cli_main(["diff", old, new, "--margin", "0.6"]) == 0


def _plan_doc(plan):
    """A plan snapshot of the port's plan, in the reference's format."""
    return {"generation": plan.generation, "fingerprint": plan.fingerprint,
            "entries": [{"space": space, "inputs": dict(key),
                         "config": dict(cfg), "tier": tier}
                        for (space, key), (cfg, tier) in plan._table.items()]}


def test_diff_cli_plan_snapshots_flag_coverage_loss(tmp_path, capsys):
    docs = []
    for ms in ((512, 1024), (512,)):
        store = tstore.RecordStore()
        for m in ms:
            store.add(_rec(tstore, m, 16, 2048))
        docs.append(_plan_doc(tstore.install_serving(store=store).plan))
    p_old, p_new = tmp_path / "old.json", tmp_path / "new.json"
    p_old.write_text(json.dumps(docs[0]))
    p_new.write_text(json.dumps(docs[1]))
    assert cli_main(["diff", str(p_old), str(p_new)]) == 1
    assert "DROPPED gemm" in capsys.readouterr().out
    assert cli_main(["diff", str(p_new), str(p_old)]) == 0
    old, _ = _two_stores(tmp_path)
    assert cli_main(["diff", old, str(p_old)]) == 2   # store vs plan


def test_retune_history_lands_in_the_controller_stats():
    store = tstore.RecordStore()
    tstore.install_store(store)
    ctl = tcontroller.RetuneController(
        store, cfg=tcontroller.RetuneConfig(min_calls=1))
    assert ctl.maybe_retune(decisions={}) is None    # no trigger, no epoch
    st = ctl.stats()
    assert st["history"] == [] and st["sentry_blocked"] == 0
    assert st["checks"] == 0 and json.dumps(st)
