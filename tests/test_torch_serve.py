"""The port's serving engine against the JAX engine: same small config,
same (converted) weights, same prompts -> identical greedy tokens."""

import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as jconfigs
from repro.models import init_params as jinit_params
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServeConfig
from repro_torch.tunedb.telemetry import clear_telemetry
from repro_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
PROMPT_LENS = (5, 9, 3, 12, 7)


@pytest.mark.parametrize("splits", [1, 4])
def test_greedy_tokens_match_the_jax_engine(splits):
    jcfg = dataclasses.replace(jconfigs.SMOKE, decode_kv_splits=splits)
    tcfg = dataclasses.replace(tconfigs.SMOKE, decode_kv_splits=splits)
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in PROMPT_LENS]

    jout = JEngine(jcfg, jp, JServeConfig(max_len=64, slots=3)).generate(
        prompts, max_new=8)
    eng = TEngine(tcfg, tp, TServeConfig(max_len=64, slots=3), device="cpu")
    tout = eng.generate(prompts, max_new=8)
    assert tout == [[int(t) for t in o] for o in jout]
    assert all(len(o) == 8 for o in tout)
    assert eng.prefills == len(prompts)


def test_sampling_is_seeded():
    tcfg = tconfigs.SMOKE
    gen = torch.Generator()
    gen.manual_seed(0)
    from repro_torch.models import init_params
    params = init_params(tcfg, gen)
    prompts = [np.arange(4), np.arange(6)]
    sc = TServeConfig(max_len=32, slots=2, temperature=1.0, seed=3)
    a = TEngine(tcfg, params, sc, device="cpu").generate(prompts, max_new=5)
    b = TEngine(tcfg, params, sc, device="cpu").generate(prompts, max_new=5)
    assert a == b and all(0 <= t < tcfg.vocab for o in a for t in o)


def test_launcher_smoke_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--smoke", "--device", "cpu", "--requests", "3",
         "--max-new", "4", "--max-len", "64"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "3 requests, 12 tokens" in r.stdout


def _smoke_models(db):
    """A tiny regressor of the SMOKE config's fp32 projection GEMMs, from
    made-up samples written to ``db``, saved to ``<db>.models/``."""
    from repro_torch.core.search import enumerate_legal
    from repro_torch.core.space import GEMM_SPACE, gemm_input
    from repro_torch.tunedb import model as tmodel
    from repro_torch.tunedb import store as tstore
    cfg = tconfigs.SMOKE
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    store = tstore.RecordStore(db)
    rng = np.random.default_rng(0)
    for M in (2, 16):
        for N, K in ((q, cfg.d_model), (kv, cfg.d_model),
                     (cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.d_ff)):
            x = gemm_input(M, N, K, 32)
            legal = enumerate_legal(GEMM_SPACE, x)
            for i in rng.permutation(len(legal))[:8]:
                store.add(tstore.TuneRecord(
                    space="gemm", inputs=x, config=legal[int(i)],
                    tflops=float(rng.uniform(1, 2)), backend="b",
                    source="sample"))
    tmodel.train_models(store, hidden=(8,), epochs=1, min_samples=8).save(
        tmodel.default_models_dir(db))


@pytest.mark.parametrize("models_dir,gates,tier", [
    (None, {}, "model"),
    ("", {}, "degraded"),
    # the confidence gates decline every pick: the margin's top-1 never
    # beats the top-2 by the whole of it, every shape lies off the mean
    (None, {"tunedb_margin": 1.0}, "degraded"),
    (None, {"tunedb_max_z": 1e-6}, "degraded"),
])
def test_engine_finds_the_store_models_or_turns_the_tier_off(
        tmp_path, models_dir, gates, tier):
    """``tunedb_models=None`` finds ``<store>.models/`` beside the store and
    serves every untuned GEMM from the model tier; ``""`` turns the tier
    off, replacing an earlier engine's models with none.  The engine hands
    ``tunedb_margin`` and ``tunedb_max_z`` to the model tier's gates."""
    from repro_torch.kernels import dispatch as tdispatch
    from repro_torch.models import init_params
    from repro_torch.tunedb import store as tstore
    db = tmp_path / "db.jsonl"
    _smoke_models(db)
    clear_telemetry()           # no earlier test's shapes in the plan
    tcfg = tconfigs.SMOKE
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(tcfg, gen)
    prompts = [np.arange(5), np.arange(9)]
    try:
        first = TEngine(tcfg, params, TServeConfig(
            max_len=32, slots=2, tunedb=str(db)), device="cpu")
        assert len(first.tunedb_models) == 1
        assert tstore.serving_state().models is first.tunedb_models
        tdispatch.reset_counts()
        eng = TEngine(tcfg, params, TServeConfig(
            max_len=32, slots=2, tunedb=str(db), tunedb_models=models_dir,
            **gates), device="cpu")
        state = tstore.serving_state()
        assert state.store is eng.tunedb_store
        assert state.models is eng.tunedb_models
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out = eng.generate(prompts, max_new=4)
        assert [len(o) for o in out] == [4, 4]
        tiers = {t for (sp, t) in tdispatch.tier_counts if sp == "gemm"}
        # a shape's first model pick is promoted into the engine's plan,
        # so its repeats are plan hits; a degraded call is never promoted
        assert tiers == ({tier, "plan"} if tier == "model" else {tier})
        if models_dir is None:
            models = eng.tunedb_models
            assert models is not first.tunedb_models and len(models) == 1
            assert models.margin_threshold == gates.get("tunedb_margin", 0.0)
            assert models.max_feature_z == gates.get("tunedb_max_z", 6.0)
            assert (models.gated > 0) == bool(gates)
        else:
            assert eng.tunedb_models is None and state.models is None
    finally:
        tstore.install_serving(store=None, models=None, fingerprint=None)


# ---------------------------------------------------------------------------
# The serving lookup's plan tier: telemetry, plan artifacts, admission
# ---------------------------------------------------------------------------

FP = "repro_torch-cuda-test"
_CFG_BUCKET = {"bm": 16, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 1,
               "order": 0, "acc32": 1, "prefetch": 1}


def _both_engines_params(splits=1, **jextra):
    jcfg = dataclasses.replace(jconfigs.SMOKE, decode_kv_splits=splits,
                               **jextra)
    tcfg = dataclasses.replace(tconfigs.SMOKE, decode_kv_splits=splits)
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _telemetry_view(tel):
    return {s: tel.hot_shapes(s, 1000) for s in tel.spaces()}


def test_engine_telemetry_matches_the_jax_engine():
    """The same prompts through both engines count the same shapes the
    same number of times: the reference counts its jitted programs' traces
    and replays, the port its eager prefills and ticks as they run.  The
    reference runs its layers under ``lax.scan`` and ``jax.checkpoint``,
    whose body traces once for all layers; with ``unroll_scan`` and no
    ``remat`` each layer is a call of its own, as in the port (and as the
    kernels run on the device)."""
    import repro.tunedb.telemetry as jtel
    from repro_torch.tunedb import telemetry as ttel
    jcfg, jp, tcfg, tp = _both_engines_params(splits=4, unroll_scan=True,
                                                  remat=False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in PROMPT_LENS + (9,)]
    jtel.clear_telemetry()
    ttel.clear_telemetry()
    try:
        JEngine(jcfg, jp, JServeConfig(max_len=64, slots=3)).generate(
            prompts, max_new=6)
        eng = TEngine(tcfg, tp, TServeConfig(max_len=64, slots=3),
                      device="cpu")
        eng.generate(prompts, max_new=6)
        want = _telemetry_view(jtel.get_telemetry())
        assert _telemetry_view(ttel.get_telemetry()) == want
        per_fwd = 7 * tcfg.n_layers
        assert (ttel.get_telemetry().total("gemm")
                == per_fwd * (len(prompts) + eng.ticks))
        assert (ttel.get_telemetry().total("attention")
                == tcfg.n_layers * eng.ticks)
        # FIFO admission keeps no prefill shapes: only pick reads them
        assert eng._prefill_shapes == {}
    finally:
        jtel.clear_telemetry()
        ttel.clear_telemetry()


def test_engine_telemetry_under_the_reference_defaults_scales_by_layers(
        tmp_path):
    """Under its defaults (layers under ``lax.scan`` and
    ``jax.checkpoint``) the reference counts a scanned layer body once a
    forward; the port counts each layer's call, as the device runs them.
    So every port count is the reference's times the layer count: the
    same shapes in the same hot-shape order, and a plan compiled from a
    merge of both packages' dumps is the plan compiled from the port's
    alone."""
    import repro.tunedb.telemetry as jtel
    from repro_torch.tunedb import store as tstore
    from repro_torch.tunedb import telemetry as ttel
    jcfg, jp, tcfg, tp = _both_engines_params(splits=4)
    assert jcfg.unroll_scan is False and jcfg.remat is True
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in PROMPT_LENS + (9,)]
    jtel.clear_telemetry()
    ttel.clear_telemetry()
    try:
        JEngine(jcfg, jp, JServeConfig(max_len=64, slots=3)).generate(
            prompts, max_new=6)
        jtel.get_telemetry().save(tmp_path / "ref.json")
        TEngine(tcfg, tp, TServeConfig(max_len=64, slots=3),
                device="cpu").generate(prompts, max_new=6)
        port = ttel.get_telemetry()
        ref = ttel.ShapeTelemetry.load(tmp_path / "ref.json")
        assert port.spaces() == ref.spaces() == ["attention", "gemm"]
        for space in port.spaces():
            assert port.hot_shapes(space, 1000) == [
                (i, c * tcfg.n_layers) for i, c in ref.hot_shapes(space, 1000)]
        merged = ttel.ShapeTelemetry()
        merged.merge(port)
        merged.merge(ref)
        # a store holding one prompt length and the tick: the hot set's
        # four tick shapes are exact, its next two (the 9-token prompts',
        # served twice) resolve on the nearest tier at compile time
        store = _smoke_store(tmp_path / "db.jsonl", (5,), slots=3)
        tables = [tstore.compile_plan(store, None, FP, telemetry=tel,
                                      hot_k=6)._table
                  for tel in (port, merged)]
        assert tables[0] == tables[1]
        assert {t for _, t in tables[0].values()} == {"exact", "nearest"}
    finally:
        jtel.clear_telemetry()
        ttel.clear_telemetry()


def _smoke_store(db, lengths, slots, seed=0, backend=FP):
    """Records of the SMOKE config's fp32 projection GEMMs at prompt
    lengths ``lengths`` and the decode tick's M = ``slots``, each under a
    random launchable config, written by the port."""
    from repro_torch.core.search import enumerate_legal
    from repro_torch.core.space import GEMM_SPACE, gemm_input
    from repro_torch.tunedb import store as tstore
    cfg = tconfigs.SMOKE
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    store = tstore.RecordStore(db)
    rng = np.random.default_rng(seed)
    for t, M in enumerate(sorted(set(lengths) | {slots})):
        for j, (N, K) in enumerate(((q, cfg.d_model), (kv, cfg.d_model),
                                    (cfg.d_ff, cfg.d_model),
                                    (cfg.d_model, cfg.d_ff))):
            x = gemm_input(M, N, K, 32)
            legal = enumerate_legal(GEMM_SPACE, x)
            store.add(tstore.TuneRecord(
                space="gemm", inputs=x,
                config=legal[int(rng.integers(len(legal)))],
                tflops=float(rng.uniform(1, 2)), backend=backend,
                created_at=1000.0 + 10 * t + j))
    return store


def test_plan_dir_cold_start_and_plan_only_serve_the_same_tokens(tmp_path):
    """A store-served engine compiles a plan and serves every GEMM from
    it; its plan exported as an artifact serves the same tokens cold
    (``plan_dir`` with the store, every resolution a plan hit) and
    plan-only (no store); a damaged artifact warns and the engine compiles
    a plan from the store instead."""
    from repro_torch.kernels import dispatch as tdispatch
    from repro_torch.models import init_params
    from repro_torch.tunedb import plans as tplans
    from repro_torch.tunedb import store as tstore
    db = tmp_path / "db.jsonl"
    lens = (5, 9)
    _smoke_store(db, lens, slots=2)
    clear_telemetry()
    tcfg = tconfigs.SMOKE
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(tcfg, gen)
    prompts = [np.arange(n) % tcfg.vocab for n in lens]

    def serve(**kw):
        eng = TEngine(tcfg, params, TServeConfig(
            max_len=32, slots=2, tunedb_models="", tunedb_backend=FP, **kw),
            device="cpu")
        tdispatch.reset_counts()
        out = eng.generate(prompts, max_new=4)
        return eng, out, dict(tdispatch.tier_counts)

    try:
        eng, base, tiers = serve(tunedb=str(db))
        plan = tstore.serving_state().plan
        assert plan.source == "compiled" and plan.stats()["tiers"] == {
            "exact": 12}
        per_fwd = 7 * tcfg.n_layers
        assert tiers == {("gemm", "plan"): per_fwd * (len(lens) + eng.ticks)}
        dest = tplans.export_plan(plan, tplans.default_plan_dir(db),
                                  store=eng.tunedb_store)
        for kw in ({"tunedb": str(db), "plan_dir": str(dest)},
                   {"plan_dir": str(dest)}):
            eng, out, tiers = serve(**kw)
            state = tstore.serving_state()
            assert state.plan.source == "loaded" and out == base
            assert state.store is eng.tunedb_store
            assert (state.store is None) == ("tunedb" not in kw)
            assert tiers == {("gemm", "plan"):
                             per_fwd * (len(lens) + eng.ticks)}
        (dest / tplans.ENTRIES_NAME).write_text("{}\n")
        with pytest.warns(RuntimeWarning, match="rejected"):
            eng, out, tiers = serve(tunedb=str(db), plan_dir=str(dest))
        assert tstore.serving_state().plan.source == "compiled"
        assert out == base and set(tiers) == {("gemm", "plan")}
    finally:
        tstore.install_serving(store=None, models=None, fingerprint=None)


def test_store_admission_matches_the_reference_and_keeps_tokens(tmp_path):
    """``admission="store"`` with the reference's peaks admits the same
    prompt lengths in the same order as the reference's engine and makes
    the same bucket decisions; every request's tokens equal its FIFO
    tokens."""
    import repro.tunedb.store as jstore
    import repro.tunedb.telemetry as jtel
    from repro.core.backend import (HBM_GBPS, PEAK_BF16_TFLOPS,
                                    PEAK_FP32_TFLOPS)
    from repro.serve.engine import StoreAwareAdmission as JAdmission
    from repro_torch.core.backend import Peaks
    from repro_torch.core.space import gemm_input
    from repro_torch.serve.engine import StoreAwareAdmission as TAdmission
    from repro_torch.tunedb import store as tstore
    from repro_torch.tunedb import telemetry as ttel
    db = tmp_path / "db.jsonl"
    # tuned: length 3 and the tick (M=2); 24 and 30 have no neighbour
    # within the store's radius, so neither package plans them
    _smoke_store(db, (3,), slots=2)
    jcfg, jp, tcfg, tp = _both_engines_params()
    rng = np.random.default_rng(3)
    lens = (24, 3, 30, 3, 24, 3, 30)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in lens]
    ref_peaks = Peaks(PEAK_BF16_TFLOPS, PEAK_FP32_TFLOPS, HBM_GBPS)
    jtel.clear_telemetry()
    ttel.clear_telemetry()
    try:
        jeng = JEngine(jcfg, jp, JServeConfig(
            max_len=64, slots=2, tunedb=str(db), tunedb_models="",
            tunedb_backend=FP, admission="store"))
        order = []
        prefill_one = jeng._prefill_one
        jeng._prefill_one = lambda slot, req: (
            order.append(len(req.prompt)), prefill_one(slot, req))[1]
        jeng.generate(prompts, max_new=3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fifo = TEngine(tcfg, tp, TServeConfig(
                max_len=64, slots=2, tunedb=str(db), tunedb_models="",
                tunedb_backend=FP), device="cpu").generate(prompts, max_new=3)
            eng = TEngine(tcfg, tp, TServeConfig(
                max_len=64, slots=2, tunedb=str(db), tunedb_models="",
                tunedb_backend=FP, admission="store"), device="cpu")
            eng.admission = TAdmission(peaks=ref_peaks)
            out = eng.generate(prompts, max_new=3)
        assert eng.admitted == order and order != list(lens)
        assert set(eng._prefill_shapes) == set(lens)
        assert out == fifo
        # bucket decisions at the SMOKE projections from a store whose M=16
        # records run far faster than its M=8 ones, installed in both
        db2 = tmp_path / "bucket.jsonl"
        t = 0
        for M, tflops in ((8, 1.0), (16, 40.0)):
            for N, K in ((72, 72), (24, 72), (192, 72), (72, 192)):
                x = gemm_input(M, N, K, 32)
                tstore.RecordStore(db2).add(tstore.TuneRecord(
                    space="gemm", inputs=x, config=_CFG_BUCKET,
                    tflops=tflops, backend=FP, created_at=1000.0 + t))
                t += 1
        jstore.install_serving(store=jstore.RecordStore.open(db2),
                               fingerprint=FP)
        tstore.install_serving(store=tstore.RecordStore.open(db2),
                               fingerprint=FP)
        jadm, tadm = JAdmission(), TAdmission(peaks=ref_peaks)
        decisions = []
        for M in (1, 4, 8, 10, 12, 16, 24, 40):
            for N, K in ((72, 72), (24, 72), (192, 72), (72, 192)):
                x = gemm_input(M, N, K, 32)
                jgot, tgot = jadm.bucket("gemm", x), tadm.bucket("gemm", x)
                assert tgot == jgot, x
                decisions.append(tgot[1])
        assert {"hit", "padded", "exact"} <= set(decisions)
        assert (tadm.padded, tadm.exact) == (jadm.padded, jadm.exact)
    finally:
        jstore.install_serving(store=None, models=None, fingerprint=None,
                               build_plan=False)
        tstore.install_serving(store=None, models=None, fingerprint=None)
        jtel.clear_telemetry()
        ttel.clear_telemetry()


def test_launcher_serves_from_a_plan_artifact_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.tunedb import plans as tplans
    from repro_torch.tunedb import store as tstore
    db = tmp_path / "db.jsonl"
    store = _smoke_store(db, (6,), slots=2)
    try:
        tstore.install_serving(store=store, fingerprint=FP)
        dest = tplans.export_plan(tstore.serving_state().plan,
                                  tplans.default_plan_dir(db), store=store)
        serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                    "--slots", "2", "--prompt-len", "6", "--max-new", "3",
                    "--max-len", "32", "--plan-dir", str(dest),
                    "--admission", "store"])
    finally:
        tstore.install_serving(store=None, models=None, fingerprint=None)
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "plan: loaded, 8 entries {'exact': 8}" in out
    assert ", 0 misses" in out


# ---------------------------------------------------------------------------
# Graceful degradation: request deadlines and load shedding
# ---------------------------------------------------------------------------

class _Clock:
    """A ``time`` stand-in whose ``monotonic`` advances one second a call
    (the engines' other clocks stay real)."""

    def __init__(self):
        import time as _time
        self.now = 0.0
        self.perf_counter = _time.perf_counter
        self.thread_time = _time.thread_time

    def monotonic(self):
        self.now += 1.0
        return self.now


def _degraded_run(monkeypatch, sc_kw, prompts, max_new, clock=False):
    """The same requests through both engines under ``sc_kw``: each
    engine's outputs, the requests' (shed, deadline_exceeded) flags, and
    its counters and health."""
    import repro.serve.engine as jengine
    import repro_torch.serve.engine as tengine
    jcfg, jp, tcfg, tp = _both_engines_params()
    runs = []
    for mod, make in ((jengine, lambda: JEngine(
            jcfg, jp, JServeConfig(max_len=64, slots=2, **sc_kw))),
            (tengine, lambda: TEngine(
                tcfg, tp, TServeConfig(max_len=64, slots=2, **sc_kw),
                device="cpu"))):
        made = []
        real = mod.Request
        monkeypatch.setattr(mod, "Request", lambda *a, **k: made.append(
            real(*a, **k)) or made[-1])
        if clock:
            monkeypatch.setattr(mod, "time", _Clock())
        eng = make()
        outs = [[int(t) for t in o] for o in eng.generate(prompts,
                                                          max_new=max_new)]
        runs.append({"outs": outs,
                     "flags": [(r.shed, r.deadline_exceeded) for r in made],
                     "counters": (eng.shed_requests, eng.deadline_retired,
                                  eng.shedding, eng._health())})
    return runs


def test_shed_threshold_matches_the_reference(monkeypatch):
    """The reference's shedding scenario: with 6 requests and a backlog
    cap of 3, both engines shed the 3 newest and serve the 3 oldest whole,
    and end healthy."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tconfigs.SMOKE.vocab, 5) for _ in range(6)]
    ref, port = _degraded_run(monkeypatch, {"shed_threshold": 3}, prompts,
                              max_new=4)
    assert port == ref
    assert port["counters"] == (3, 0, False, True)
    assert [len(o) for o in port["outs"]] == [4, 4, 4, 0, 0, 0]
    assert port["flags"] == [(False, False)] * 3 + [(True, False)] * 3


@pytest.mark.parametrize("deadline", [0.0, 3600.0])
def test_request_deadline_matches_the_reference(monkeypatch, deadline):
    """The reference's deadline scenarios: an expired deadline rejects
    every request unserved; a generous one changes no token."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tconfigs.SMOKE.vocab, 5) for _ in range(3)]
    ref, port = _degraded_run(monkeypatch, {"request_deadline_s": deadline},
                              prompts, max_new=4)
    assert port == ref
    if deadline == 0.0:
        assert port["outs"] == [[], [], []]
        assert port["flags"] == [(False, True)] * 3
        assert port["counters"] == (0, 3, False, True)
    else:
        plain = _degraded_run(monkeypatch, {}, prompts, max_new=4)[1]
        assert port["outs"] == plain["outs"]
        assert port["counters"] == (0, 0, False, True)


def test_an_overdue_active_request_retires_with_its_tokens(monkeypatch):
    """On a clock that advances a second a reading, both engines retire
    the same active requests with the tokens they have and reject the
    same pending ones unserved."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tconfigs.SMOKE.vocab, n) for n in (5, 7, 4,
                                                                 6, 3)]
    ref, port = _degraded_run(monkeypatch, {"request_deadline_s": 6.5,
                                            "shed_threshold": 4},
                              prompts, max_new=6, clock=True)
    assert port == ref
    lens = [len(o) for o in port["outs"]]
    assert any(0 < n < 6 for n in lens) and 0 in lens
    assert (True, False) in port["flags"] and (False, True) in port["flags"]


def test_tick_times_carry_thread_cpu_seconds():
    """Each recorded tick is (start, wall seconds, thread-CPU seconds), as
    in the reference."""
    _, _, tcfg, tp = _both_engines_params()
    eng = TEngine(tcfg, tp, TServeConfig(max_len=32, slots=2,
                                         record_tick_times=True),
                  device="cpu")
    eng.generate([np.arange(5), np.arange(3)], max_new=3)
    assert len(eng.tick_times) == eng.ticks > 0
    assert all(len(t) == 3 and t[1] > 0 and t[2] >= 0
               for t in eng.tick_times)


# ---------------------------------------------------------------------------
# The model tier's deferred re-measurement in idle decode gaps
# ---------------------------------------------------------------------------

def test_measure_drains_in_idle_gaps_into_the_plan(tmp_path):
    """With ``measure="wallclock"`` (on the CPU: the gated timer on the
    plain versions) every shape the model tier resolves is served its
    argmax and queued; the engine drains the queue after its ticks, and
    each drained shape then resolves on the plan tier to its measured
    winner, the best of its re-measured candidates.  Tokens are those of
    an engine without ``measure``; one calibration GEMM ran at start."""
    from repro_torch.kernels import dispatch as tdispatch
    from repro_torch.tunedb import store as tstore
    db = tmp_path / "db.jsonl"
    _smoke_models(db)
    clear_telemetry()
    _, _, tcfg, tp = _both_engines_params()
    prompts = [np.arange(5) % tcfg.vocab, np.arange(9) % tcfg.vocab]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            plain = TEngine(tcfg, tp, TServeConfig(
                max_len=32, slots=2, tunedb=str(db)),
                device="cpu").generate(prompts, max_new=4)
            clear_telemetry()
            eng = TEngine(tcfg, tp, TServeConfig(
                max_len=32, slots=2, tunedb=str(db), measure="wallclock"),
                device="cpu")
        models = eng.tunedb_models
        assert models.measurer is eng.measurer
        assert models.measure_queue is eng.measure_queue
        assert eng.calibration_tflops > 0
        assert eng.measurer.counts["wallclock"] == 1
        models.remeasure_top_k = 4
        measured = {}
        real = eng.measurer

        def recording(space, cfg, inputs):
            tflops = real(space, cfg, inputs)
            measured.setdefault(tuple(sorted(inputs.items())), []).append(
                (dict(cfg), tflops))
            return tflops

        eng.measurer = recording
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out = eng.generate(prompts, max_new=4)
        assert out == plain
        q = eng.measure_queue
        # 3 prompt/tick M values x 4 projections, each queued once
        assert q.pushed == 12 and q.dropped == 0
        assert 0 < q.processed < 12        # 2 a tick over 3 ticks
        while len(q):
            eng.maybe_retune()
        assert q.processed == 12 and len(measured) == 12
        assert real.counts["wallclock"] == 1 + sum(
            len(v) for v in measured.values())
        tdispatch.reset_counts()
        for key, got in measured.items():
            winner = max(got, key=lambda t: t[1])[0]
            assert len(got) == 4
            assert tdispatch._resolve_cfg("gemm", dict(key)) == (winner,
                                                                "plan")
            assert tstore.serving_state().plan.lookup("gemm", key) == (
                winner, "model")
        assert set(tdispatch.tier_counts) == {("gemm", "plan")}
    finally:
        tstore.install_serving(store=None, models=None, fingerprint=None)
