"""The port's retune loop (``repro_torch.tunedb.controller``) against the
JAX package's ``repro.tunedb.controller``, on the CPU.

Detection, the epoch budget and session planning get the same recorded
traffic and the same records in both packages and must decide the same.
The epochs run the port's own loop: its ``InputAwareTuner`` over the
port's Hopper spaces, trained on the reference's ``SimulatedTPUBackend``
as a label source (a test double: the port never uses it as a speed
model), commits ``source="retune"`` records, retrains, and swaps the
port's serving state; the SmolLM SMOKE engine retunes inside
``generate``.  The CLI's ``tune --shapes-from-telemetry``, ``retune`` and
``watch`` label on the CPU (``--device cpu``).
"""

import json
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

import repro.tunedb.controller as jcontroller
import repro.tunedb.model as jmodel
import repro.tunedb.session as jsession
import repro.tunedb.store as jstore
import repro.tunedb.telemetry as jtelemetry
from repro.core.backend import SimulatedTPUBackend
from repro.core.space import SPACES as JSPACES
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.core.search import enumerate_legal
from repro_torch.core.space import SPACES, attention_input, gemm_input
from repro_torch.core.tuner import InputAwareTuner
from repro_torch.models import init_params
from repro_torch.serve import Engine, ServeConfig
from repro_torch.tunedb import controller as tcontroller
from repro_torch.tunedb import model as tmodel
from repro_torch.tunedb import session as tsession
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb import telemetry as ttelemetry
from repro_torch.tunedb.__main__ import main as cli_main
from repro_torch.tunedb.obs.metrics import reset_metrics

CFG = {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
       "order": 0, "acc32": 1, "prefetch": 2}
FP = "test"

# the two packages' halves of the loop, side by side
JAX = types.SimpleNamespace(
    RecordStore=jstore.RecordStore, TuneRecord=jstore.TuneRecord,
    install_serving=jstore.install_serving, serving_state=jstore.serving_state,
    ShapeTelemetry=jtelemetry.ShapeTelemetry,
    RetuneController=jcontroller.RetuneController,
    RetuneConfig=jcontroller.RetuneConfig,
    TuningSession=jsession.TuningSession,
    backend_fingerprint=jsession.backend_fingerprint)
PORT = types.SimpleNamespace(
    RecordStore=tstore.RecordStore, TuneRecord=tstore.TuneRecord,
    install_serving=tstore.install_serving, serving_state=tstore.serving_state,
    ShapeTelemetry=ttelemetry.ShapeTelemetry,
    RetuneController=tcontroller.RetuneController,
    RetuneConfig=tcontroller.RetuneConfig,
    TuningSession=tsession.TuningSession,
    backend_fingerprint=tsession.backend_fingerprint)

A = gemm_input(512, 16, 512)
B = gemm_input(128, 128, 128)
C = gemm_input(2560, 16, 2560)
D = gemm_input(512, 128, 512)
ATT = attention_input(4, 9, 3, 1, 256, 64)


def _reset():
    tstore.install_serving(store=None, models=None, fingerprint=None)
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    ttelemetry.clear_telemetry()
    jtelemetry.clear_telemetry()
    reset_metrics()


@pytest.fixture(autouse=True)
def _clean_globals():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset()
    yield
    _reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tuners():
    """The port's tuners for the spaces the traffic touches: its Hopper
    spaces, labelled by the reference's simulator."""
    sim = SimulatedTPUBackend(noise=0.02)
    return {name: InputAwareTuner.train(SPACES[name], n_samples=600,
                                        hidden=(16, 16), epochs=4,
                                        backend=sim, seed=0)
            for name in ("gemm", "attention")}


def _rec(pkg, inputs, *, tflops=100.0, backend=FP, space="gemm"):
    return pkg.TuneRecord(space=space, inputs=dict(inputs), config=dict(CFG),
                          tflops=tflops, backend=backend)


def _feed(tel, traffic):
    for space, inputs, n in traffic:
        tel.record(space, inputs, n=n)


# ---------------------------------------------------------------------------
# detection and budget parity
# ---------------------------------------------------------------------------

# (cfg, tuned shapes, baseline traffic, window traffic, attempted shapes)
SCENARIOS = {
    "steady": ({}, [A, B], [("gemm", A, 10), ("gemm", B, 10)],
               [("gemm", A, 5), ("gemm", B, 5)], []),
    "steady-untuned-half": ({}, [A], [("gemm", A, 10), ("gemm", B, 10)],
                            [("gemm", A, 20), ("gemm", B, 20)], []),
    "shift": ({}, [A], [("gemm", A, 20), ("attention", ATT, 4)],
              [("gemm", C, 20), ("gemm", A, 5), ("attention", ATT, 40)], []),
    "untuned-no-drift": ({"drift_threshold": 1.1}, [],
                         [("gemm", D, 20)], [("gemm", D, 20)], []),
    "below-min-calls": ({"min_calls": 64}, [], [("gemm", A, 20)],
                        [("gemm", C, 10)], []),
    "attempted": ({"top_k_shapes": 1}, [A], [("gemm", A, 20)],
                  [("gemm", C, 20), ("gemm", D, 10)], [C]),
}


def _detect(pkg, cfg, tuned, before, window, attempted):
    store = pkg.RecordStore()
    for x in tuned:
        store.add(_rec(pkg, x))
    pkg.install_serving(store=store, models=None, fingerprint=FP,
                        build_plan=False)
    tel = pkg.ShapeTelemetry()
    _feed(tel, before)
    ctl = pkg.RetuneController(
        store, telemetry=tel,
        cfg=pkg.RetuneConfig(**{"min_calls": 16, **cfg}))
    ctl._attempted |= {("gemm", tstore.input_key("gemm", x))
                       for x in attempted}
    _feed(tel, window)
    return ctl.check()


def _fields(d):
    return (d.space, d.untuned_mass, d.window_calls, d.novel_shapes,
            d.trigger, d.reason)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_check_decides_as_the_reference(name):
    want = _detect(JAX, *SCENARIOS[name])
    got = _detect(PORT, *SCENARIOS[name])
    assert sorted(got) == sorted(want)
    for space in want:
        assert got[space].drift == pytest.approx(want[space].drift,
                                                 abs=1e-12)
        assert _fields(got[space]) == _fields(want[space])
    if name == "shift":
        assert got["gemm"].reason == "drift" and got["gemm"].novel_shapes == [C]
    if name == "attempted":
        assert got["gemm"].novel_shapes == [D]
    if name == "below-min-calls":
        assert got["gemm"].drift == 1.0 and not got["gemm"].trigger


def _both_legal(inputs):
    jsp = JSPACES["gemm"]
    return [c for c in enumerate_legal(SPACES["gemm"], inputs)
            if jsp.is_legal(c, inputs)]


@pytest.fixture(scope="module")
def model_records():
    """Made-up measurements around the target shape (every input feature
    varies, so none standardises to a spike), configs legal in both
    spaces."""
    rng = np.random.default_rng(0)
    out = []
    for x in (gemm_input(M, N, K) for M in (128, 512) for N in (192, 576)
              for K in (576, 1536)):
        legal = _both_legal(x)
        for i in rng.permutation(len(legal))[:12]:
            c = legal[int(i)]
            out.append((x, c, 0.5 * np.log2(c["bn"]) + 0.1 * c["prefetch"]))
    return out


@pytest.mark.parametrize("near_tflops,verdict", [(1e-6, True), (1e15, False)])
def test_min_gain_decides_as_the_reference(model_records, near_tflops,
                                           verdict):
    """A nearest record far slower than the model's projection leaves the
    epoch triggered; one far faster skips it, in both packages."""
    target = gemm_input(256, 192, 576)
    got = {}
    for pkg, model in ((JAX, jmodel), (PORT, tmodel)):
        store = pkg.RecordStore()
        for x, c, t in model_records:
            store.add(pkg.TuneRecord(space="gemm", inputs=x, config=c,
                                     tflops=float(t), backend=FP,
                                     source="sample"))
        models = model.train_models(store, space="gemm", epochs=10,
                                    hidden=(8,), min_samples=8)
        store.add(_rec(pkg, gemm_input(128, 192, 576), tflops=near_tflops))
        pkg.install_serving(store=store, models=models, fingerprint=FP,
                            build_plan=False)
        tel = pkg.ShapeTelemetry()
        ctl = pkg.RetuneController(
            store, telemetry=tel,
            cfg=pkg.RetuneConfig(min_calls=8, min_gain=0.1))
        tel.record("gemm", target, n=20)
        got[pkg is PORT] = ctl.check()["gemm"]
    want, port = got[False], got[True]
    assert _fields(port) == _fields(want)
    assert port.trigger is verdict and port.reason == (
        "drift" if verdict else "")
    assert (port.projected_gain > 0.1) is verdict


def _budget(pkg, cfg, starts, probes):
    ctl = pkg.RetuneController(pkg.RecordStore(), telemetry=pkg.ShapeTelemetry(),
                               cfg=pkg.RetuneConfig(**cfg))
    for tick in starts:
        ctl._note_session_start(tick)
    return [ctl._budget_blocks(t) for t in probes]


@pytest.mark.parametrize("cfg,starts,probes", [
    ({"cooldown_ticks": 16}, [8], [None, 9, 23, 24, 100]),
    ({"max_sessions_per_window": 2, "session_window_s": 60.0}, [None],
     [None, 5]),
    ({"max_sessions_per_window": 2, "session_window_s": 60.0}, [1, 2],
     [None, 5]),
    ({"cooldown_ticks": 4, "max_sessions_per_window": 1}, [3], [5, 7]),
])
def test_budget_blocks_as_the_reference(cfg, starts, probes):
    assert _budget(PORT, cfg, starts, probes) == _budget(JAX, cfg, starts,
                                                         probes)


# ---------------------------------------------------------------------------
# epochs
# ---------------------------------------------------------------------------

def test_drift_epoch_commits_retrains_and_swaps(tuners, tmp_path):
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    fp = tsession.backend_fingerprint(tuners["gemm"].backend)
    tstore.install_serving(store=store, models=None, fingerprint=None)
    tel = ttelemetry.get_telemetry()
    tel.record("gemm", A, n=40)
    ctl = tcontroller.RetuneController(
        store, tuners=tuners,
        cfg=tcontroller.RetuneConfig(min_calls=16, top_k_shapes=2, workers=1,
                                     train_epochs=3, min_train_samples=5))
    assert ctl.maybe_retune() is None            # steady: nothing to do
    new = gemm_input(2560, 16, 2560)
    tel.record("gemm", new, n=40)
    dec = ctl.check()["gemm"]
    assert dec.trigger and dec.reason == "drift"
    assert dec.untuned_mass == pytest.approx(1.0)
    assert dec.novel_shapes == [new]
    gen0 = tstore.serving_state().generation
    report = ctl.maybe_retune()
    assert report is not None and report.tuned == 1
    rec = store.get("gemm", new, backend=fp)
    assert rec is not None and rec.source == "retune"
    assert report.retrained == [f"gemm/{fp}"]
    state = tstore.serving_state()
    assert state.generation == report.generation > gen0
    assert state.store is store and len(state.models) == 1
    assert state.plan.lookup("gemm", tstore.shape_key(new)) == (
        rec.config, "exact")
    assert report.session_s > 0 and report.retrain_s > 0
    # the epoch advanced: the same traffic does not trip it again
    tel.record("gemm", new, n=40)
    assert ctl.maybe_retune() is None
    assert ctl.retunes == 1
    st = ctl.stats()
    assert st["last"]["tuned"] == 1 and st["history"][0]["tuned"] == ["gemm"]
    assert json.dumps(st)


def test_zero_tuned_epoch_keeps_the_generation(tuners):
    """Every job skipped (tuned under the session backend, not under the
    pin): no generation flip, the window is spent all the same."""
    store = tstore.RecordStore()
    fp = tsession.backend_fingerprint(tuners["gemm"].backend)
    store.add(tstore.TuneRecord(space="gemm", inputs=D, config=dict(CFG),
                                tflops=50.0, backend=fp))
    tstore.install_serving(store=store, models=None, fingerprint="pinned")
    tel = ttelemetry.get_telemetry()
    ctl = tcontroller.RetuneController(
        store, tuners=tuners,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1, workers=1))
    tel.record("gemm", D, n=20)
    gen0 = tstore.serving_state().generation
    with pytest.warns(RuntimeWarning, match="fingerprint pin"):
        report = ctl.maybe_retune()
    assert report is not None and report.tuned == 0
    assert report.sessions["gemm"].skipped == 1
    assert tstore.serving_state().generation == gen0 == report.generation
    assert ctl.retunes == 0
    assert ctl.maybe_retune() is None


def test_pin_mismatch_warns_once_and_does_not_livelock(tuners):
    store = tstore.RecordStore()
    tstore.install_serving(store=store, models=None, fingerprint="pinned")
    tel = ttelemetry.get_telemetry()
    ctl = tcontroller.RetuneController(
        store, tuners=tuners,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1, workers=1,
                                     retrain=False))
    tel.record("gemm", D, n=20)
    with pytest.warns(RuntimeWarning, match="fingerprint pin"):
        first = ctl.maybe_retune()
    assert first is not None and first.tuned == 1
    gen = tstore.serving_state().generation
    tel.record("gemm", D, n=20)            # still unserved under the pin
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no second warning
        assert ctl.maybe_retune() is None
    assert tstore.serving_state().generation == gen


def test_retarget_during_the_epoch_skips_the_swap(tuners, monkeypatch):
    store = tstore.RecordStore()
    tstore.install_serving(store=store, models=None, fingerprint=None)
    tel = ttelemetry.get_telemetry()
    ctl = tcontroller.RetuneController(
        store, tuners=tuners,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1, workers=1,
                                     retrain=False))
    tel.record("gemm", D, n=20)
    other = tstore.RecordStore()
    real = tsession.TuningSession.run

    def run_then_retarget(self, *a, **kw):
        out = real(self, *a, **kw)
        tstore.install_serving(store=other, fingerprint="bk-B")
        return out

    monkeypatch.setattr(tsession.TuningSession, "run", run_then_retarget)
    with pytest.warns(RuntimeWarning, match="retargeted"):
        report = ctl.maybe_retune()
    assert report is not None and report.tuned == 1
    state = tstore.serving_state()
    assert state.store is other and state.fingerprint == "bk-B"
    assert ctl.retunes == 0 and len(store) == 1


@pytest.mark.parametrize("tflops,refused", [(40.0, True), (78.0, False)])
def test_sentry_gates_the_epoch_swap(tuners, monkeypatch, tflops, refused):
    """A regressed record injected into the serving store during the epoch
    (another writer re-measured a served shape slower) makes the sentry
    refuse the epoch's swap, counted in sentry_blocked; a re-measurement
    within the 10% margin is promoted."""
    store = tstore.RecordStore()
    store.add(_rec(PORT, A, tflops=80.0, backend="bk"))
    tstore.install_serving(store=store, models=None, fingerprint=None)
    tel = ttelemetry.get_telemetry()
    ctl = tcontroller.RetuneController(
        store, tuners=tuners,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1, workers=1,
                                     retrain=False, sentry=0.1))
    tel.record("gemm", D, n=20)
    real = tsession.TuningSession.run

    def run_then_inject(self, *a, **kw):
        out = real(self, *a, **kw)
        store.add(_rec(PORT, A, tflops=tflops, backend="bk"))
        return out

    monkeypatch.setattr(tsession.TuningSession, "run", run_then_inject)
    gen0 = tstore.serving_state().generation
    if refused:
        with pytest.warns(RuntimeWarning, match="sentry refused"):
            report = ctl.maybe_retune()
    else:
        report = ctl.maybe_retune()
    assert report is not None and report.tuned == 1
    assert (ctl.sentry_blocked, ctl.retunes) == ((1, 0) if refused
                                                 else (0, 1))
    assert tstore.serving_state().generation == (gen0 if refused
                                                 else gen0 + 1)
    assert ctl.stats()["sentry_blocked"] == int(refused)


def test_async_epoch_reaped_once_and_the_watchdog(tuners):
    store = tstore.RecordStore()
    tstore.install_serving(store=store, models=None, fingerprint=None)
    tel = ttelemetry.get_telemetry()
    gate = threading.Event()

    class Slow:
        """The gemm tuner, held until the test releases it."""
        space, backend = tuners["gemm"].space, tuners["gemm"].backend

        def search(self, inputs, remeasure=True):
            gate.wait(30)
            return tuners["gemm"].search(inputs, remeasure=remeasure)

    ctl = tcontroller.RetuneController(
        store, tuners={"gemm": Slow()}, async_mode=True,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1, workers=1,
                                     retrain=False))
    tel.record("gemm", D, n=20)
    gen0 = tstore.serving_state().generation
    assert ctl.maybe_retune() is None            # submitted
    assert ctl.async_active() and ctl.async_submits == 1
    tel.record("gemm", C, n=20)
    assert ctl.maybe_retune() is None            # one epoch at a time
    assert ctl.async_submits == 1
    gate.set()
    ctl._async.join(30)
    report = ctl.maybe_retune()                  # reaped ...
    assert report is not None and report.mode == "async"
    assert report.tuned == 1 and report.generation == gen0 + 1
    assert ctl.wait_async() is None              # ... exactly once
    assert ctl.async_windows[0][1] >= ctl.async_windows[0][0]

    # the watchdog: a tuner that hangs on the controller's cancel event is
    # released once the epoch outlives session_window_s
    hung = tcontroller.RetuneController(
        store, async_mode=True,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1, workers=1,
                                     retrain=False, session_window_s=0.05))

    class Hangs:
        space, backend = tuners["gemm"].space, tuners["gemm"].backend

        def search(self, inputs, remeasure=True):
            if not hung._async_cancel.wait(30):
                raise AssertionError("never cancelled")
            raise TimeoutError("cancelled by the watchdog")

    hung._tuners["gemm"] = Hangs()
    tel.record("gemm", gemm_input(96, 96, 96), n=20)
    assert hung.maybe_retune() is None and hung.async_active()
    time.sleep(0.1)
    assert hung.maybe_retune() is None           # the watchdog fires
    assert hung.watchdog_cancels == 1
    hung._async.join(30)
    done = hung.maybe_retune()
    assert done is not None and done.tuned == 0
    assert done.sessions["gemm"].failed == 1
    assert "watchdog" in done.sessions["gemm"].errors[0]


def test_fleet_and_publish_are_refused(tuners, tmp_path):
    """The fleet mode refuses a store with no file behind it (the workers'
    shards live beside it): a warning, and the epoch runs in-process, as
    the reference's does; a publish to a registry that cannot be written
    is refused and counted, the local swap kept."""
    store = tstore.RecordStore()
    tstore.install_serving(store=store)
    (tmp_path / "blocked").write_text("a file, not a registry directory")
    ctl = tcontroller.RetuneController(
        store, fleet_dir=tmp_path / "fleet", tuners=tuners,
        cfg=tcontroller.RetuneConfig(min_calls=8, top_k_shapes=1,
                                     workers=1, retrain=False,
                                     publish=str(tmp_path / "blocked")))
    assert ctl.async_mode
    for _ in range(40):
        ttelemetry.get_telemetry().record("gemm", A)
    with pytest.warns(RuntimeWarning, match="disk-backed"):
        assert ctl.maybe_retune() is None
    with pytest.warns(RuntimeWarning, match="plan publish"):
        report = ctl.wait_async(timeout=120)
    assert report is not None and report.mode == "async" and report.tuned
    assert not (tmp_path / "fleet").exists()
    assert ctl.publish_failed == 1 and ctl.published_plans == 0
    assert ctl.retunes == 1 and store.contains("gemm", A)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_retunes_inside_generate(tuners):
    """SmolLM's SMOKE (fp32) notices its own untuned GEMMs and retunes
    mid-generate: every request served whole, the records in the engine's
    store, and the same greedy tokens as the engine without the loop (a
    parting, which a config change could only cause through a near-tie,
    fails with the logits' top-two gap at that step)."""
    cfg = tconfigs.SMOKE
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3, 12, 7)]
    eng = Engine(cfg, params, ServeConfig(
        max_len=64, slots=3, retune=True, retune_interval=8,
        retune_min_calls=8, retune_top_k=4), device="cpu",
        retune_tuners=tuners)
    store = eng.tunedb_store
    assert store is tstore.serving_state().store and len(store) == 0
    gen0 = tstore.serving_state().generation
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the degraded tier's warning
        outs = eng.generate(prompts, max_new=24)
    assert all(len(o) == 24 for o in outs)
    assert eng.controller.retunes >= 1
    assert tstore.serving_state().generation > gen0
    assert len(store) >= 1
    assert all(r.source == "retune" for r in store.records())

    _reset()
    plain = Engine(cfg, params, ServeConfig(max_len=64, slots=3),
                   device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = plain.generate(prompts, max_new=24)
    for i, (got, ref) in enumerate(zip(outs, want)):
        if got == ref:
            continue
        step = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        gap = _top_two_gap(cfg, params, [*prompts[i], *ref[:step]])
        if gap > PARTING_GAP:
            pytest.fail(f"request {i} parts at step {step} ({got[step]} vs "
                        f"{ref[step]}), top-two logit gap {gap:.3e}")
        warnings.warn(f"request {i} parts at step {step} on a near tie "
                      f"(top-two logit gap {gap:.3e})")


# a parting of greedy tokens is a near tie when the top-two logits of the
# plain engine's step differ by less than this (fp32: a retuned config
# only reorders sums, e.g. split-K partials)
PARTING_GAP = 1e-4


def _top_two_gap(cfg, params, tokens):
    """The top-two logit gap after ``tokens``, by one fp32 prefill."""
    from repro_torch.models import init_cache, prefill
    cache = init_cache(cfg, 1, 64, "cpu")
    logits = prefill(params, cfg,
                     {"tokens": torch.as_tensor(np.asarray(tokens))[None]},
                     cache)[0][0, :cfg.vocab]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

class _Stub:
    """A tuner stand-in for planning: a space name and a backend."""

    class Backend:
        noise = 0.0

    def __init__(self, space):
        self.space = types.SimpleNamespace(name=space)
        self.backend = self.Backend()


def test_telemetry_mined_plan_matches_the_reference():
    shapes = [(gemm_input(64 * (i + 1), 128, 256), 50 - 3 * i)
              for i in range(10)]
    plans = []
    for pkg in (JAX, PORT):
        tel = pkg.ShapeTelemetry()
        for x, n in shapes:
            tel.record("gemm", x, n=n)
        tuner = _Stub("gemm")
        store = pkg.RecordStore()
        fp = pkg.backend_fingerprint(tuner.backend)
        store.add(_rec(pkg, shapes[1][0], backend=fp))       # tuned here
        store.add(_rec(pkg, shapes[2][0], backend="other"))  # not this fp
        jobs, skipped = pkg.TuningSession(tuner, store, tel,
                                          top_k_shapes=6).plan()
        plans.append(([(j.space, j.inputs, j.count) for j in jobs], skipped))
    assert plans[1] == plans[0]
    assert plans[1][1] == 1 and len(plans[1][0]) == 5
    with pytest.raises(ValueError, match="telemetry or explicit shapes"):
        tsession.TuningSession(_Stub("gemm"), tstore.RecordStore()).plan()


def test_progress_file_resumes(tuners, tmp_path):
    progress = tmp_path / "tune.progress"
    tel = ttelemetry.ShapeTelemetry()
    for i, x in enumerate((A, B, D)):
        tel.record("gemm", x, n=10 - i)
    store = tstore.RecordStore()
    first = tsession.TuningSession(tuners["gemm"], store, tel, workers=1,
                                   collect_samples=False,
                                   progress_path=progress).run()
    assert first.tuned == 3 and store.n_samples == 0
    doc = json.loads(progress.read_text())
    assert doc["space"] == "gemm" and len(doc["done"]) == 3
    assert not progress.with_name(progress.name + ".tmp").exists()
    # a fresh store: only the progress file says the shapes are done, and
    # the reference's session reads the same file the same way
    again = tsession.TuningSession(tuners["gemm"], tstore.RecordStore(), tel,
                                   progress_path=progress).run()
    assert (again.jobs, again.skipped, again.tuned) == (0, 3, 0)
    jplan = jsession.TuningSession(_Stub("gemm"), jstore.RecordStore(),
                                   jtelemetry.ShapeTelemetry.load(
                                       _saved(tel, tmp_path)),
                                   progress_path=progress).plan()
    assert (jplan[0], jplan[1]) == ([], 3)


def test_session_releases_the_timers_operands(tuners):
    """A session through ``CheckedBackend(CudaEventBackend)`` (on the CPU:
    the plain versions at a shrunken instance) leaves the timer holding no
    operand sets and no timing log, and its records keep the latency read
    before the release; a later measurement draws the same operands."""
    import dataclasses

    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    backend = CheckedBackend(CudaEventBackend(device="cpu"))
    tuner = dataclasses.replace(tuners["gemm"], backend=backend, top_k=3,
                                _mem_cache={})
    x = gemm_input(48, 64, 96)
    first = backend.timer._operand_sets("gemm", backend.timer.instance(
        "gemm", x))[0]
    first = [t.clone() for t in first]
    store = tstore.RecordStore()
    report = tsession.TuningSession(tuner, store, None, workers=1,
                                    collect_samples=False).run(shapes=[x])
    assert report.tuned == 1 and not report.failed
    assert backend.timer._operands == ((), [])
    assert backend.timer._times == {}
    [rec] = store.records()
    assert rec.latency_us is not None and rec.latency_us > 0
    again = backend.timer._operand_sets("gemm", backend.timer.instance(
        "gemm", x))[0]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    backend.release()
    assert backend.timer._operands == ((), [])


def _saved(tel, tmp_path):
    path = tmp_path / "tel.json"
    tel.save(path)
    return path


# ---------------------------------------------------------------------------
# the CLI (labels on the CPU)
# ---------------------------------------------------------------------------

LABEL = ["--device", "cpu", "--train-samples", "48", "--epochs", "2"]


def _dump(path, counts):
    tel = ttelemetry.ShapeTelemetry()
    for x, n in counts:
        tel.record("gemm", x, n=n)
    tel.save(path)


def test_cli_tune_from_telemetry_with_progress(tmp_path, capsys):
    db, tel, progress = (tmp_path / "db.jsonl", tmp_path / "tel.json",
                         tmp_path / "p.json")
    small = [gemm_input(16, 64, 64), gemm_input(32, 64, 128)]
    _dump(tel, [(small[0], 9), (small[1], 4)])
    argv = ["tune", "--space", "gemm", "--store", str(db), "--telemetry",
            str(tel), "--shapes-from-telemetry", "--progress", str(progress),
            "--top-k", "2", "--workers", "1", *LABEL]
    assert cli_main(argv) == 0
    assert "2 tuned, 0 skipped, 0 failed" in capsys.readouterr().out
    assert len(json.loads(progress.read_text())["done"]) == 2
    recs = tstore.RecordStore.open(db).records()
    assert {r.source for r in recs} == {"session"} and len(recs) == 2
    assert cli_main(argv + ["--retune"]) == 0     # the progress file skips
    assert "0 tuned, 2 skipped" in capsys.readouterr().out


def test_cli_retune_advances_the_epoch_baseline(tmp_path, capsys):
    db, tel = tmp_path / "db.jsonl", tmp_path / "tel.json"
    shape = gemm_input(16, 64, 64)
    _dump(tel, [(shape, 40)])
    argv = ["retune", "--store", str(db), "--telemetry", str(tel),
            "--min-calls", "16", "--top-k", "1", "--workers", "1",
            "--no-train", *LABEL]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert "retuned 1 shape(s)" in out and "[retune:gemm] drift" in out
    store = tstore.RecordStore.open(db)
    assert [r.source for r in store.records()] == ["retune"]
    assert (tmp_path / "tel.json.epoch").exists()
    assert cli_main(argv) == 0                    # no drift vs the baseline
    assert "no retune" in capsys.readouterr().out


def test_cli_watch_polls_and_stops(tmp_path, capsys):
    db, tel = tmp_path / "db.jsonl", tmp_path / "tel.json"
    _dump(tel, [(gemm_input(16, 64, 64), 40)])
    assert cli_main(["watch", "--store", str(db), "--telemetry", str(tel),
                     "--interval", "0", "--max-polls", "2", "--min-calls",
                     "16", "--top-k", "1", "--workers", "1", "--no-train",
                     *LABEL]) == 0
    out = capsys.readouterr().out
    assert "watch poll 1/2" in out and "watch poll 2/2" in out
    assert "retuned 1 shape(s)" in out and "no retune" in out
    assert out.count("training gemm tuner") == 1  # trained once, reused


def test_cli_retune_without_telemetry_fails(tmp_path, capsys):
    assert cli_main(["retune", "--store", str(tmp_path / "db.jsonl"),
                     "--telemetry", str(tmp_path / "nope.json")]) == 1
    assert "not found" in capsys.readouterr().err
