"""The port's request tracing (``repro_torch.tunedb.obs.trace``) against the
JAX package's ``repro.tunedb.obs.trace``.

Each test drives both modules with the same calls or reads the same files
and compares what they give: the sampled roots and the span tree (names,
parent links, attributes), ``stats()``, the JSONL dump and the Chrome
trace, ``summarize_spans``, torn files, the ``trace`` CLI, and the span
taxonomy of a traced engine (dispatch resolutions included)."""

import json
import threading
import warnings

import jax
import numpy as np
import pytest

import repro.kernels.dispatch as jdispatch
import repro.tunedb.obs.trace as jtrace
import repro.tunedb.store as jstore
import repro_torch.tunedb.obs.trace as ttrace
from repro.configs import smollm_135m as jconfigs
from repro.models import init_params as jinit_params
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.tunedb.__main__ import main as jcli_main
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.core.space import gemm_input
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServeConfig
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb.__main__ import main as tcli_main
from repro_torch.tunedb.telemetry import clear_telemetry
from repro_torch.weights import params_from_jax

MODS = {"jax": jtrace, "port": ttrace}
CFG = {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
       "order": 0, "acc32": 1, "prefetch": 2}


def _reset():
    jtrace.reset_tracing()
    ttrace.reset_tracing()
    tstore.install_serving(store=None, models=None, fingerprint=None)
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    clear_telemetry()
    tdispatch.reset_counts()


@pytest.fixture(autouse=True)
def _clean_globals():
    _reset()
    yield
    _reset()


def _tree(spans):
    """Each span as (name, parent's name, attributes), in finishing order:
    the ids and times differ between runs, the tree does not."""
    by_id = {s.span_id: s for s in spans}
    return [(s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else "", dict(s.attrs)) for s in spans]


def _drive(mod, sample):
    """One call sequence: roots with children, an orphan span, a detached
    span ended on another thread, an explicit-id root."""
    tr = mod.Tracer(sample=sample)
    kept = []
    for i in range(12):
        with tr.root("engine.tick", tick=i) as sp:
            kept.append(sp is not None)
            with tr.span("dispatch.resolve", space="gemm") as d:
                if d is not None:
                    d.attrs["tier"] = "plan" if i % 3 else "exact"
            with tr.span("engine.prefill", prompt_len=i):
                with tr.span("dispatch.resolve", space="attention",
                             tier="nearest"):
                    pass
    with tr.span("orphan"):
        pass
    det = tr.begin("retune.epoch", trace_id=mod.new_trace_id(),
                   spaces="gemm", mode="async")
    th = threading.Thread(target=lambda: tr.end(det, outcome="swapped",
                                                tuned=2))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    with tr.root("measure.wallclock", trace_id=mod.new_trace_id(),
                 space="gemm"):
        pass
    return tr, kept


@pytest.mark.parametrize("sample", [1.0, 0.5, 0.25, 0.0])
def test_same_calls_keep_the_same_roots_and_tree(sample):
    got = {k: _drive(mod, sample) for k, mod in MODS.items()}
    (jtr, jkept), (ttr, tkept) = got["jax"], got["port"]
    assert tkept == jkept
    assert (ttr.sampled, ttr.dropped) == (jtr.sampled, jtr.dropped)
    assert _tree(ttr.spans()) == _tree(jtr.spans())
    for tr in (jtr, ttr):
        assert len({s.trace_id for s in tr.spans()
                    if s.name == "engine.tick"}) == sum(jkept)


def test_stats_and_tier_latency_have_the_reference_keys():
    jtr, _ = _drive(jtrace, 1.0)
    ttr, _ = _drive(ttrace, 1.0)
    js, ts = jtr.stats(), ttr.stats()
    assert set(ts) == set(js)
    for k in ("enabled", "sample", "sampled", "dropped", "spans", "buffered",
              "overflow", "max_spans"):
        assert ts[k] == js[k], k
    assert set(ts["tiers"]) == set(js["tiers"]) == {"plan", "exact",
                                                    "nearest"}
    for tier in ts["tiers"]:
        assert set(ts["tiers"][tier]) == set(js["tiers"][tier])
        assert ts["tiers"][tier]["count"] == js["tiers"][tier]["count"]


@pytest.mark.parametrize("cap", [10, 25])
def test_retention_cap_and_rings_drain_as_the_reference(cap):
    out = {}
    for k, mod in MODS.items():
        tr = mod.Tracer(sample=1.0, max_spans=cap)

        def work():
            for _ in range(20):
                with tr.root("w"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        buffered = tr.buffered()
        out[k] = (buffered, len(tr.spans()), tr.buffered(),
                  tr.stats()["overflow"])
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (60, cap, 0)


def test_null_span_is_shared_and_enable_retunes():
    assert ttrace.Tracer().span("x") is ttrace._NULL_SPAN
    for mod in MODS.values():
        assert mod.get_tracer() is None
        tr = mod.enable_tracing(1.0)
        assert mod.enable_tracing(0.25) is tr and tr.sample == 0.25
        assert mod._TRACER is tr
        mod.reset_tracing()
        assert mod.get_tracer() is None
    assert (ttrace.TRACE_SCHEMA_VERSION, ttrace.SPAN_RING_SIZE,
            ttrace.MAX_SPANS, ttrace.SPAN_DISPATCH) == (
        jtrace.TRACE_SCHEMA_VERSION, jtrace.SPAN_RING_SIZE,
        jtrace.MAX_SPANS, jtrace.SPAN_DISPATCH)


@pytest.fixture
def reference_dump(tmp_path):
    """A JSONL file the reference's ``export_jsonl`` wrote (two dumps)."""
    tr, _ = _drive(jtrace, 1.0)
    path = tmp_path / "w.jsonl"
    n = tr.export_jsonl(path)
    assert tr.spans() == []                 # the dump moved them out
    with tr.root("engine.admit", prompt_len=7):
        pass
    assert tr.export_jsonl(path) == 1       # appends, no duplicates
    return path, n + 1


def _fields(spans):
    return [sp.to_json() for sp in spans]


def test_a_reference_dump_loads_into_equal_spans(reference_dump):
    path, n = reference_dump
    jspans = jtrace.load_span_file(path)
    tspans = ttrace.load_span_file(path)
    assert len(tspans) == n
    assert _fields(tspans) == _fields(jspans)


def test_port_dump_reads_back_in_the_reference(tmp_path):
    tr, _ = _drive(ttrace, 1.0)
    want = _fields(tr.spans())
    path = tmp_path / "port.jsonl"
    assert tr.export_jsonl(path) == len(want)
    assert tr.spans() == []
    assert _fields(jtrace.load_span_file(path)) == want
    chrome = tmp_path / "port.json"
    tr2, _ = _drive(ttrace, 1.0)
    assert tr2.export(chrome) == len(want)
    doc = json.loads(chrome.read_text())
    assert doc["otherData"]["schema"] == 1
    back = jtrace.load_span_file(chrome)
    assert _tree(back) == _tree(tr2.spans())


def test_chrome_trace_and_summary_equal_the_reference(reference_dump):
    path, _ = reference_dump
    spans = ttrace.load_span_file(path)
    assert (ttrace.chrome_trace(spans, pid=7)
            == jtrace.chrome_trace(jtrace.load_span_file(path), pid=7))
    assert (ttrace.summarize_spans(spans)
            == jtrace.summarize_spans(jtrace.load_span_file(path)))
    summary = ttrace.summarize_spans(spans)
    assert summary["tiers"]["plan"]["count"] == 8


TORN = {
    "torn-jsonl-line": None,       # filled in below: a good line + a torn one
    "torn-chrome": '{"traceEvents": [{"name": "x", "ph": "X", "ts"',
    "junk": "\x00\x01 not json at all",
    "events-not-a-list": '{"traceEvents": {"a": 1}}',
    "bad-event": json.dumps({"traceEvents": [
        {"name": "ok", "ts": 1.0, "dur": 2.0, "tid": 3,
         "args": {"trace_id": "t", "span_id": "s", "parent_id": ""}},
        {"ts": 5.0}, {"name": "no-ts", "dur": "x"}]}),
    "bad-attrs": json.dumps({"name": "a", "trace_id": "t", "span_id": "s",
                             "t0": 1.0, "dur": 0.5, "attrs": [1, 2]}) + "\n",
    "empty": "",
}


@pytest.mark.parametrize("case", sorted(TORN) + ["missing"])
def test_torn_files_are_skipped_as_the_reference_skips_them(tmp_path, case):
    path = tmp_path / "t.jsonl"
    if case == "torn-jsonl-line":
        good = jtrace.Span("fleet.job", "t1", "s1")
        good.t0, good.dur = 1.0, 0.5
        path.write_text(json.dumps(good.to_json()) + "\n"
                        + '{"name": "fleet.job", "trace_id": "t2", "spa')
    elif case != "missing":
        path.write_text(TORN[case])
    jgot = _fields(jtrace.load_span_file(path))
    tgot = _fields(ttrace.load_span_file(path))
    assert tgot == jgot
    if case == "torn-jsonl-line":
        assert [s["trace_id"] for s in tgot] == ["t1"]


@pytest.mark.parametrize("verb", ["summary", "summary --json", "export"])
def test_trace_cli_prints_what_the_reference_prints(reference_dump, tmp_path,
                                                    capsys, verb):
    path, _ = reference_dump
    outs = {}
    for k, main in (("jax", jcli_main), ("port", tcli_main)):
        argv = ["trace", *verb.split(), "--input", str(path)]
        if verb == "export":
            argv += ["--out", str(tmp_path / f"{k}.json")]
        assert main(argv) == 0
        text = capsys.readouterr().out
        outs[k] = text.replace(str(tmp_path / f"{k}.json"), "OUT")
    assert outs["port"] == outs["jax"]
    if verb == "export":
        assert (json.loads((tmp_path / "port.json").read_text())
                == json.loads((tmp_path / "jax.json").read_text()))


def test_resolve_spans_carry_the_reference_attributes():
    """The same records installed in both packages: a dispatch resolution
    under a root gives a ``dispatch.resolve`` span with the same space,
    tier and shape, plan hit and slow path alike."""
    shapes = [gemm_input(4, 576, 576), gemm_input(8, 576, 576),
              gemm_input(32, 1536, 576)]
    for mod in (jstore, tstore):
        store = mod.RecordStore()
        store.add(mod.TuneRecord(space="gemm", inputs=shapes[0], config=CFG,
                                 tflops=100.0, backend="test"))
        mod.install_serving(store=store, fingerprint="test")
    trees = {}
    for k, (mod, disp) in {"jax": (jtrace, jdispatch),
                           "port": (ttrace, tdispatch)}.items():
        tr = mod.enable_tracing(1.0)
        with tr.root("engine.tick", tick=0), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # degraded
            for x in shapes:
                disp._tuned_cfg("gemm", x)
        trees[k] = _tree(tr.spans())
        mod.reset_tracing()
    assert trees["port"] == trees["jax"]
    assert [a["tier"] for n, _, a in trees["port"]
            if n == "dispatch.resolve"] == ["plan", "nearest", "degraded"]


def _taxonomy(spans):
    by_id = {s.span_id: s for s in spans}
    return {(s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else "", tuple(sorted(s.attrs))) for s in spans}


def test_engine_span_taxonomy_matches_the_reference(tmp_path):
    """The SMOKE model served by both engines with ``trace_sample=1`` and a
    store: the same span names, parent links and attribute keys.  The
    reference's model path on the CPU never enters dispatch (its jitted
    forward runs XLA ops), so its resolutions are the start-up probe's;
    the port's eager forward resolves every call (on the card a replayed
    graph resolves none), so its ``dispatch.resolve`` spans also sit under
    ``engine.tick`` and ``engine.prefill``, with the probe's attributes.
    Each tick is one root of its own."""
    x = gemm_input(4, 64, 64)
    for mod, name in ((jstore, "j.jsonl"), (tstore, "t.jsonl")):
        store = mod.RecordStore.open(tmp_path / name)
        store.add(mod.TuneRecord(space="gemm", inputs=x, config=CFG,
                                 tflops=100.0, backend="test"))
    jp = jinit_params(jconfigs.SMOKE, jax.random.PRNGKey(1))
    tcfg = tconfigs.SMOKE
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in (5, 9, 3)]
    jeng = JEngine(jconfigs.SMOKE, jp, JServeConfig(
        max_len=64, slots=2, trace_sample=1.0,
        tunedb=str(tmp_path / "j.jsonl"), tunedb_backend="test"))
    jeng.generate(prompts, max_new=4)
    jspans = jeng.tracer.spans()
    with pytest.warns(RuntimeWarning):       # untuned shapes: degraded
        teng = TEngine(tcfg, tp, TServeConfig(
            max_len=64, slots=2, trace_sample=1.0,
            tunedb=str(tmp_path / "t.jsonl"), tunedb_backend="test"),
            device="cpu")
        teng.generate(prompts, max_new=4)
    tspans = teng.tracer.spans()
    jtax, ttax = _taxonomy(jspans), _taxonomy(tspans)
    assert jtax <= ttax
    resolve = ("dispatch.resolve", ("shape", "space", "tier"))
    assert ttax - jtax == {(resolve[0], parent, resolve[1])
                           for parent in ("engine.tick", "engine.prefill")}
    assert ("dispatch.resolve", "dispatch.probe",
            ("shape", "space", "tier")) in jtax
    for spans, eng in ((jspans, jeng), (tspans, teng)):
        ticks = [s for s in spans if s.name == "engine.tick"]
        assert len(ticks) == eng.ticks == len({s.trace_id for s in ticks})
        assert all(s.parent_id == "" for s in ticks)
    probe = [(n, a) for n, p, a in _tree(tspans) if p == "dispatch.probe"]
    jprobe = [(n, a) for n, p, a in _tree(jspans) if p == "dispatch.probe"]
    assert probe == jprobe


def test_tracer_module_imports_no_torch():
    text = open(ttrace.__file__, encoding="utf-8").read()
    assert "import torch" not in text and "from torch" not in text


def test_measure_spans_and_counter_match_the_reference():
    """A serving-path measurement outside any sampled trace is kept in a
    root of its own, inside a sampled root it is a child; both packages
    give the same names (the reference's measurer off a TPU labels
    ``sim``, the port's ``wallclock``), attribute keys and counter
    increments."""
    from repro.tunedb.measure import ServingMeasurer as JMeasurer
    from repro.tunedb.obs import metrics as jmetrics
    from repro_torch.core.search import enumerate_legal
    from repro_torch.core.space import GEMM_SPACE
    from repro_torch.tunedb.measure import ServingMeasurer as TMeasurer
    from repro_torch.tunedb.obs import get_registry, reset_metrics
    x = gemm_input(17, 64, 48, 32)
    cfg = enumerate_legal(GEMM_SPACE, x)[0]
    reset_metrics()
    jmetrics.reset_metrics()
    got = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the sim fallback
        for k, mod, m, reg in (
                ("jax", jtrace, JMeasurer("wallclock"), jmetrics.get_registry),
                ("port", ttrace, TMeasurer(device="cpu"), get_registry)):
            tr = mod.enable_tracing(0.5)
            m("gemm", cfg, x)                       # no trace open: a root
            for i in range(2):                      # stride 2: 2nd kept
                with tr.root("engine.tick", tick=i):
                    m("gemm", cfg, x)
            spans = tr.spans()
            label = "sim" if k == "jax" else "wallclock"
            got[k] = ([(n.replace(label, "X"), p, sorted(a))
                       for n, p, a in _tree(spans)],
                      {s.attrs["backend"] for s in spans
                       if s.name.startswith("measure.")},
                      reg().snapshot()["tunedb_measurements_total"][
                          "samples"])
            mod.reset_tracing()
    keys = ["backend", "shape", "space", "tflops"]
    # an unsampled tick 0 opens no trace, so its measurement is a root too
    assert got["port"][0] == got["jax"][0] == [
        ("measure.X", "", keys), ("measure.X", "", keys),
        ("measure.X", "engine.tick", keys), ("engine.tick", "", ["tick"])]
    assert got["port"][1] == {"wallclock"}
    assert [s["value"] for s in got["port"][2]] == \
        [s["value"] for s in got["jax"][2]] == [3.0]
    assert got["port"][2][0]["labels"] == {"backend": "wallclock"}


def test_async_epoch_span_adopts_the_open_trace():
    """An async retune epoch submitted under an open ``engine.tick`` root
    is one detached ``retune.epoch`` span in that trace, begun on the
    polling thread and ended by the epoch's at the swap (outcome, tuned);
    submitted outside any trace it gets an always-kept trace of its own;
    an inline epoch opens no span (as in the reference)."""
    from repro.core.backend import SimulatedTPUBackend
    from repro_torch.core.space import SPACES
    from repro_torch.core.tuner import InputAwareTuner
    from repro_torch.tunedb import controller as tcontroller
    from repro_torch.tunedb.telemetry import get_telemetry
    tuner = InputAwareTuner.train(SPACES["gemm"], n_samples=200,
                                  hidden=(8,), epochs=2,
                                  backend=SimulatedTPUBackend(noise=0.0),
                                  seed=0)
    tr = ttrace.enable_tracing(1.0)
    tel = get_telemetry()
    spans = {}
    for mode, open_root in (("async", True), ("async", False),
                            ("inline", True)):
        store = tstore.RecordStore()
        tstore.install_serving(store=store, fingerprint=None)
        ctl = tcontroller.RetuneController(
            store, tuners={"gemm": tuner}, async_mode=mode == "async",
            cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1,
                                         workers=1, retrain=False))
        clear_telemetry()
        tel.record("gemm", gemm_input(64 + 32 * len(spans), 64, 64), n=20)
        tr.clear()
        if open_root:
            with tr.root("engine.tick", tick=0) as root:
                report = ctl.maybe_retune()
        else:
            root, report = None, ctl.maybe_retune()
        if mode == "async":
            assert report is None
            ctl._async.join(60)
            report = ctl.maybe_retune()
        assert report is not None and report.tuned == 1
        got = [s for s in tr.spans() if s.name == "retune.epoch"]
        spans[(mode, open_root)] = (got, root)
    (epoch,), root = spans[("async", True)]
    assert epoch.trace_id == root.trace_id and epoch.parent_id == ""
    assert epoch.attrs == {"spaces": "gemm", "mode": "async",
                           "outcome": "swapped", "tuned": 1}
    assert epoch.dur > 0
    (alone,), _ = spans[("async", False)]
    assert alone.trace_id and alone.trace_id != epoch.trace_id
    assert spans[("inline", True)][0] == []
