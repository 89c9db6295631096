"""The port's performance models (``repro_torch.tunedb.model``) against the
JAX package's: the same store harvests to the same training sets, an
artifact written by either package loads in the other and scores the same
candidates the same way, the confidence gate declines the same shapes, and
the port's dispatch serves a shape nobody tuned from its model tier.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import repro.tunedb.model as jmodel
import repro.tunedb.store as jstore
from repro.core.space import SPACES as JSPACES
from repro_torch.core.search import enumerate_legal
from repro_torch.core.space import GEMM_SPACE, gemm_fits, gemm_input
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ref as tref
from repro_torch.tunedb import model as tmodel
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb.telemetry import clear_telemetry

FP = "repro_torch-cuda-test"
# shapes the made-up records were "tuned" at (the reference's space has no
# legal tile at M=4, so parity records start at M=32)
TUNED = [gemm_input(M, N, 576, 16) for M in (32, 128) for N in (192, 576)]


@pytest.fixture(autouse=True)
def _clean_serving_state():
    tstore.install_serving(store=None, models=None, fingerprint=None)
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    tdispatch.reset_counts()
    yield
    tstore.install_serving(store=None, models=None, fingerprint=None)
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)


def _both_legal(inputs):
    """Configs legal in the port's space and the reference's at ``inputs``."""
    jsp = JSPACES["gemm"]
    return [c for c in enumerate_legal(GEMM_SPACE, inputs)
            if jsp.is_legal(c, inputs)]


def _records(seed=0, per_shape=16, backend=FP):
    """Random (inputs, config, TFLOPS) records at ``TUNED``, with configs
    legal in both spaces and a smooth made-up throughput."""
    rng = np.random.default_rng(seed)
    out = []
    for x in TUNED:
        legal = _both_legal(x)
        for i in rng.permutation(len(legal))[:per_shape]:
            c = legal[int(i)]
            tflops = (0.05 * x["M"] ** 0.5 * np.log2(c["bn"]) / c["k_split"]
                      * rng.uniform(0.8, 1.2))
            out.append((x, c, float(tflops), backend))
    return out


def _store(mod, path, records, *, t0=1000.0):
    store = mod.RecordStore(path)
    for t, (x, c, tflops, fp) in enumerate(records):
        store.add(mod.TuneRecord(space="gemm", inputs=x, config=c,
                                 tflops=tflops, backend=fp, source="sample",
                                 created_at=t0 + t))
    return store


@pytest.mark.parametrize("where", ["disk", "memory"])
def test_harvest_matches_the_reference(tmp_path, where):
    records = _records(per_shape=5)
    x0, c0 = TUNED[0], records[0][1]
    extra = [
        # a tuning record and its superseding re-tune: both train
        (x0, c0, 1.25, FP, "tuner"),
        (x0, records[1][1], 1.5, FP, "retune"),
        # another backend's sample, a dead record, a config short of a param
        (TUNED[1], c0, 0.75, "other-backend", "sample"),
        (TUNED[1], c0, 0.0, FP, "sample"),
        (TUNED[2], {k: v for k, v in c0.items() if k != "prefetch"}, 2.0, FP,
         "sample"),
    ]
    path = tmp_path / "db.jsonl" if where == "disk" else None
    stores = []
    for mod in (jstore, tstore):
        store = _store(mod, path if mod is jstore else None, records)
        for t, (x, c, tflops, fp, src) in enumerate(extra):
            store.add(mod.TuneRecord(space="gemm", inputs=x, config=c,
                                     tflops=tflops, backend=fp, source=src,
                                     created_at=5000.0 + t))
        stores.append(store)
    if where == "disk":
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"space": "gemm", "inputs": {"M": 4')     # torn tail
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # quarantined
            stores = [jstore.RecordStore.open(path),
                      tstore.RecordStore.open(path)]
    assert len(stores[1].training_records()) == len(records) + len(extra)
    jh, th = jmodel.harvest(stores[0]), tmodel.harvest(stores[1])
    assert sorted(jh) == sorted(th) == sorted([("gemm", FP),
                                               ("gemm", "other-backend")])
    for key in jh:
        assert th[key].inputs == jh[key].inputs
        assert th[key].configs == jh[key].configs
        np.testing.assert_array_equal(th[key].tflops, jh[key].tflops)
    assert len(th[("gemm", FP)]) == len(records) + 2
    assert tmodel.harvest(stores[1], backend="other-backend").keys() == {
        ("gemm", "other-backend")}
    assert stores[1].backends() == stores[0].backends() == [FP]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One tiny GEMM regressor per package, trained on the same records
    (hidden (8,), 2 epochs) and saved: {"reference": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("artifacts")
    records = _records(per_shape=16)
    out = {}
    for name, smod, mmod in (("reference", jstore, jmodel),
                             ("port", tstore, tmodel)):
        store = _store(smod, None, records)
        models = mmod.train_models(store, space="gemm", hidden=(8,),
                                   epochs=2, min_samples=8)
        assert len(models) == 1
        out[name] = models.save(root / name)
    return out


# untuned shapes the candidates are scored at
UNTUNED = [gemm_input(17, 576, 576, 16), gemm_input(100, 192, 576, 16),
           gemm_input(64, 1536, 576, 16)]


@pytest.mark.parametrize("inputs", UNTUNED)
@pytest.mark.parametrize("written_by", ["reference", "port"])
def test_artifact_loads_across_packages_and_scores_the_same(
        artifacts, written_by, inputs):
    meta = next(artifacts[written_by].glob("*.json"))
    jpm = jmodel.PerfModel.load(meta)
    if written_by == "reference":
        tms = tmodel.ModelSet.load(artifacts[written_by])
        assert len(tms) == 1 and not tms.skipped
        tpm = tms.resolve_model("gemm", FP)
    else:
        tpm = tmodel.PerfModel.load(meta)
    assert tpm.key == jpm.key == ("gemm", FP)
    cands = _both_legal(inputs)[::3]
    assert len(cands) >= 30
    jres = jpm.predict_config(inputs, top_k=5, candidates=cands)
    tres = tpm.predict_config(inputs, top_k=5, candidates=cands)
    assert [c for c, _ in tres.top_k] == [c for c, _ in jres.top_k]
    np.testing.assert_allclose([p for _, p in tres.top_k],
                               [p for _, p in jres.top_k], rtol=1e-5)
    assert tres.n_candidates == jres.n_candidates == len(cands)


@pytest.mark.parametrize("gate", ["max_feature_z", "margin_threshold"])
def test_confidence_gates_decline_the_same_shapes(artifacts, gate):
    """The feature gate declines the same shapes in both packages.  The
    margin gate is held against the reference's scores of the port's own
    legal configs (each package's ``predict`` scans its own space): the
    port declines exactly where the reference model's top-1 beats its
    top-2 by less than the threshold."""
    shapes = UNTUNED + [gemm_input(4096, 576, 576, 16),
                        gemm_input(32, 576, 65536, 16),
                        gemm_input(4, 192, 8, 16)]
    tms = tmodel.ModelSet.load(artifacts["reference"])
    if gate == "max_feature_z":
        jms = jmodel.ModelSet.load(artifacts["reference"])
        jms.max_feature_z = tms.max_feature_z = 3.0
        declined = []
        for x in shapes:
            jgot = jms.predict("gemm", x, backend=FP)
            tgot = tms.predict("gemm", x, backend=FP)
            assert (jgot is None) == (tgot is None), x
            declined.append(tgot is None)
        assert jms.gated == tms.gated == sum(declined)
        assert declined == [False, False, False, True, True, True]
        return
    jpm = jmodel.PerfModel.load(next(artifacts["reference"].glob("*.json")))
    top2 = [jpm.predict_config(x, top_k=2, candidates=enumerate_legal(
        GEMM_SPACE, x)).top_k for x in shapes]
    margins = [(a[1] - b[1]) / a[1] if a[1] > 0 else -1.0 for a, b in top2]
    lo, hi = min(margins[:len(UNTUNED)]), max(margins[:len(UNTUNED)])
    assert lo < hi
    tms.margin_threshold = (lo + hi) / 2
    want = [m < tms.margin_threshold for m in margins]
    declined = [tms.predict("gemm", x, backend=FP) is None for x in shapes]
    assert declined == want
    assert tms.gated == sum(want)
    for x, d, top in zip(shapes, declined, top2):
        if not d:            # a served pick is the reference's top-1
            assert tms.predict("gemm", x, backend=FP)[0] == top[0][0]


def _damage(kind, meta):
    if kind == "schema":
        payload = json.loads(meta.read_text())
        payload["model_schema_version"] = tmodel.MODEL_SCHEMA_VERSION + 99
        meta.write_text(json.dumps(payload))
    elif kind == "json":
        meta.write_text('{"model_schema_version": 1, "space"')
    else:
        npz = meta.with_suffix(".npz")
        npz.write_bytes(npz.read_bytes()[:20])


@pytest.mark.parametrize("kind,match", [("schema", "schema"),
                                        ("json", "unreadable"),
                                        ("npz", "damaged")])
def test_a_damaged_artifact_is_skipped_with_one_warning(artifacts, tmp_path,
                                                        kind, match):
    d = tmp_path / "models"
    meta = tmodel.ModelSet.load(artifacts["port"]).resolve_model(
        "gemm", FP).save(d)
    _damage(kind, meta)
    with pytest.warns(RuntimeWarning) as rec:
        loaded = tmodel.ModelSet.load(d)
    assert len(rec) == 1 and match in str(rec[0].message)
    assert len(loaded) == 0 and len(loaded.skipped) == 1
    assert loaded.predict("gemm", UNTUNED[0]) is None


def test_dispatch_serves_an_untuned_shape_from_the_model_tier(artifacts):
    models = tmodel.ModelSet.load(artifacts["port"])
    pm = models.resolve_model("gemm", FP)
    scans = []
    predict = pm.predict_config
    pm.predict_config = lambda *a, **k: scans.append(a) or predict(*a, **k)
    tstore.install_serving(store=tstore.RecordStore(), models=models,
                           fingerprint=FP, build_plan=False)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(100, 576)), dtype=torch.bfloat16)
    b = torch.as_tensor(rng.normal(size=(576, 192)) / 24.0,
                        dtype=torch.bfloat16)
    got = tdispatch.matmul(a, b).float()
    want = tref.matmul_ref(a, b).float()
    assert float((got - want).abs().max() / want.abs().max()) <= 2e-2
    assert tdispatch.tier_counts[("gemm", "model")] == 1
    assert models.hits == 1 and len(scans) == 1
    cfg, tier = tdispatch._resolve_cfg("gemm", gemm_input(100, 192, 576, 16))
    assert tier == "model" and gemm_fits(cfg, 16)
    assert models.hits == 2 and len(scans) == 1          # a memo hit


class _StubModels:
    """A model set whose every pick is a TPU tile no CTA holds."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, 0

    def predict(self, space, inputs, *, backend=None):
        self.calls += 1
        return dict(self.cfg), 9.0


def test_a_pick_that_cannot_launch_falls_through_to_nearest_once():
    tpu = {"bm": 128, "bn": 1024, "bk": 512, "k_unroll": 1, "k_split": 1,
           "order": 0, "acc32": 1, "prefetch": 2}
    good = _records(per_shape=1)[0][1]
    store = tstore.RecordStore()
    store.add(tstore.TuneRecord(space="gemm", inputs=TUNED[1], config=good,
                                tflops=1.0, backend=FP))
    stub = _StubModels(tpu)
    tstore.install_serving(store=store, models=stub, fingerprint=FP,
                           build_plan=False)
    x = gemm_input(40, 576, 576, 16)
    with pytest.warns(RuntimeWarning, match="cannot launch") as rec:
        assert tdispatch._resolve_cfg("gemm", x) == (good, "nearest")
    assert sum("cannot launch" in str(w.message) for w in rec) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a second warning would raise
        assert tdispatch._resolve_cfg("gemm", x) == (good, "nearest")
    assert stub.calls == 2
    # a new generation warns again
    tstore.install_serving(models=stub, build_plan=False)
    with pytest.warns(RuntimeWarning, match="cannot launch"):
        tdispatch._resolve_cfg("gemm", x)


def test_install_serving_swaps_in_one_generation_and_drops_memos(artifacts):
    models = tmodel.ModelSet.load(artifacts["port"])
    store = tstore.RecordStore()
    # no hot set: the installs' plans scan no shape into the memo
    clear_telemetry()
    gen = tstore.serving_state().generation
    tstore.install_serving(store=store, models=models, fingerprint=FP)
    assert models.predict("gemm", UNTUNED[0], backend=FP) is not None
    assert models._memo
    tstore.install_store(store, fingerprint=FP)     # keeps the models
    state = tstore.serving_state()
    assert state.generation == gen + 2 and state.models is models
    assert not models._memo
    tmodel.clear_models()
    assert tmodel.get_models() is None and tstore.serving_state().store is store


@pytest.mark.parametrize("inputs", UNTUNED)
def test_predict_with_a_queue_pushes_the_reference_top_k(artifacts, inputs):
    """With a measurer and a ``MeasureQueue`` attached, ``predict`` serves
    the model's argmax at once and pushes its top-k, never measuring:
    the port pushes the candidate list the reference pushes and serves its
    argmax (the reference's scan held to the port's legal configs, which
    its own space does not enumerate), and a repeat is a memo hit that
    pushes nothing."""
    import functools

    from repro.tunedb.measure import MeasureQueue as JQueue
    from repro_torch.tunedb.measure import MeasureQueue as TQueue
    calls = []

    def measurer(*args):
        calls.append(args)
        return 1.0

    jms = jmodel.ModelSet.load(artifacts["reference"])
    tms = tmodel.ModelSet.load(artifacts["reference"])
    jpm = jms.resolve_model("gemm", FP)
    jpm.predict_config = functools.partial(
        jpm.predict_config, candidates=enumerate_legal(GEMM_SPACE, inputs))
    queues = (JQueue(), TQueue())
    for ms, q in zip((jms, tms), queues):
        ms.measurer, ms.measure_queue, ms.remeasure_top_k = measurer, q, 6
    jgot = jms.predict("gemm", inputs, backend=FP)
    tgot = tms.predict("gemm", inputs, backend=FP)
    assert tgot[0] == jgot[0]
    assert tgot[1] == pytest.approx(jgot[1], rel=1e-5)
    (jitem,), (titem,) = (list(q._items) for q in queues)
    assert titem == jitem and len(titem[4]) == 6
    assert titem[4][0] == tgot[0]
    assert tms.predict("gemm", inputs, backend=FP) == tgot
    assert [q.stats() for q in queues] == [queues[0].stats()] * 2
    assert queues[1].pushed == 1 and not calls
