"""The port's frozen dispatch plans and plan artifacts against the JAX
package's: the same store file and hot set compile to the same (space,
shape) -> (config, tier) table, dispatch resolves the same (config, tier)
sequence through tier 0 (hits, promotions, stand-aside until the next
install), an artifact exported by either package loads in the other with
the same table and digest, and every damaged artifact is refused (the
cases of ``tests/test_plans.py``).  The port's own rule holds on top: no
plan entry the kernel cannot launch is ever served.  A plan registry's
pointers and digests equal the reference's and each package pulls the
other's; the plan follower installs and refuses (a rollback, a torn
artifact, a coverage loss) as the reference's does; ``plan publish`` and
``plan follow`` round-trip."""

import json
import threading
import time
import warnings

import pytest

import repro.tunedb.model as jmodel
import repro.tunedb.plans as jplans
import repro.tunedb.store as jstore
import repro.tunedb.telemetry as jtel
from repro.core.space import SPACES as JSPACES
from repro.core.tuner import clear_tuners
from repro.kernels import dispatch as jdispatch
from repro_torch.core.search import enumerate_legal
from repro_torch.core.space import GEMM_SPACE, gemm_fits, gemm_input
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.tunedb import model as tmodel
from repro_torch.tunedb import plans as tplans
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb import telemetry as ttel

FP = "repro_torch-cuda-test"

# Hopper-legal configs, legal in the reference's space too
CFG_A = {"bm": 32, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 2,
         "order": 0, "acc32": 1, "prefetch": 2}
CFG_B = {"bm": 64, "bn": 128, "bk": 256, "k_unroll": 2, "k_split": 1,
         "order": 1, "acc32": 0, "prefetch": 1}
CFG_C = {"bm": 16, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 4,
         "order": 0, "acc32": 1, "prefetch": 1}
# tuned for the TPU: no CTA holds bn=1024
CFG_TPU = {"bm": 128, "bn": 1024, "bk": 512, "k_unroll": 1, "k_split": 1,
           "order": 0, "acc32": 1, "prefetch": 2}

RECORDS = [
    (gemm_input(32, 576, 576, 16), CFG_A, FP),
    (gemm_input(32, 1536, 576, 16), CFG_B, FP),
    (gemm_input(512, 4096, 4096, 16), CFG_C, FP),
    (gemm_input(32, 576, 576, 16), CFG_C, "other-backend"),
    (gemm_input(128, 192, 576, 16), CFG_B, FP),
]
# the telemetry hot set: tuned shapes, neighbours of them, one shape no
# record is near
HOT = [(gemm_input(32, 576, 576, 16), 50), (gemm_input(40, 576, 576, 16), 30),
       (gemm_input(48, 1536, 576, 16), 20), (gemm_input(100, 192, 576, 16), 9),
       (gemm_input(300, 4096, 4096, 16), 5), (gemm_input(4, 8, 8, 16), 3),
       (gemm_input(64, 576, 576, 16), 3)]


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        clear_tuners()
        jstore.install_serving(store=None, models=None, fingerprint=None,
                               build_plan=False)
        tstore.install_serving(store=None, models=None, fingerprint=None,
                               build_plan=False)
        jtel.clear_telemetry()
        ttel.clear_telemetry()
        tdispatch.reset_counts()
    reset()
    assert all(gemm_fits(c, 16) for c in (CFG_A, CFG_B, CFG_C))
    assert not gemm_fits(CFG_TPU, 16)
    yield
    reset()


def _write(mod, path, records=RECORDS, t0=1000.0):
    store = mod.RecordStore(path)
    for t, (inputs, cfg, fp) in enumerate(records):
        store.add(mod.TuneRecord(space="gemm", inputs=inputs, config=cfg,
                                 tflops=1.5 + t, backend=fp, source="tuner",
                                 created_at=t0 + t))
    return store


def _hot(mod):
    tel = mod.ShapeTelemetry()
    for x, n in HOT:
        tel.record("gemm", x, n=n)
    return tel


def _reference_models(root):
    """A tiny reference-trained GEMM regressor on made-up samples at
    configs legal in both spaces, saved as an artifact directory."""
    mem = jstore.RecordStore()
    for t, M in enumerate((32, 64, 128)):
        for N in (576, 1536):
            x = gemm_input(M, N, 576, 16)
            legal = [c for c in enumerate_legal(GEMM_SPACE, x)
                     if JSPACES["gemm"].is_legal(c, x)]
            for j, c in enumerate(legal[::9]):
                mem.add(jstore.TuneRecord(
                    space="gemm", inputs=x, config=c, backend=FP,
                    tflops=0.01 * M * c["bn"] / (c["k_split"] + j % 3),
                    source="sample", created_at=1.0 + t))
    models = jmodel.train_models(mem, space="gemm", hidden=(8,), epochs=2,
                                 min_samples=8)
    return models.save(root / "models")


@pytest.mark.parametrize("fingerprint", [FP, None])
@pytest.mark.parametrize("with_models", [False, True])
def test_compile_plan_matches_the_reference(tmp_path, fingerprint,
                                            with_models):
    path = tmp_path / "db.jsonl"
    _write(jstore, path)
    jm = tm = None
    if with_models:
        d = _reference_models(tmp_path)
        jm, tm = jmodel.ModelSet.load(d), tmodel.ModelSet.load(d)
    jplan = jstore.compile_plan(jstore.RecordStore.open(path), jm,
                                fingerprint, telemetry=_hot(jtel))
    tplan = tstore.compile_plan(tstore.RecordStore.open(path), tm,
                                fingerprint, telemetry=_hot(ttel))
    tiers = {t for _, t in tplan._table.values()}
    # the model covers every GEMM shape: with it no hot shape is nearest
    assert tiers == ({"exact", "model"} if with_models
                     else {"exact", "nearest"})
    # the same shapes on the same tiers
    assert ({k: t for k, (_, t) in tplan._table.items()}
            == {k: t for k, (_, t) in jplan._table.items()})
    assert tplan.stats()["tiers"] == jplan.stats()["tiers"]
    pm = jm.resolve_model("gemm", FP) if with_models else None
    for key, (cfg, tier) in tplan._table.items():
        if tier == "model":
            # each package's model scans its own space (the reference's
            # holds TPU tiles such as bk=512, bn=256 at M=100 that the
            # port's GEMM has no CTA for): the port's pick is the reference
            # model's argmax over the port's launchable configs
            x = dict(key[1])
            assert cfg == pm.predict_config(x, candidates=enumerate_legal(
                GEMM_SPACE, x)).best
        else:
            assert (cfg, tier) == jplan._table[key]
    # a freshly opened store is at version 0 in both packages
    assert tplan.store_version == jplan.store_version == 0
    assert tplan.compile_ms is not None and tplan.compile_ms >= 0


def _run(dispatch, shapes):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return [dispatch._resolve_cfg("gemm", x) for x in shapes]


def test_resolution_sequence_matches_the_reference(tmp_path):
    """Plan hits, slow-path resolutions promoted into the plan, the plan
    standing aside once the store gains a record, and a reinstall that
    compiles it back: the same (config, tier) sequence in both."""
    path = tmp_path / "db.jsonl"
    _write(jstore, path)
    stores = {"j": jstore.RecordStore.open(path),
              "t": tstore.RecordStore.open(path)}
    jstore.install_serving(store=stores["j"], fingerprint=FP)
    tstore.install_serving(store=stores["t"], fingerprint=FP)
    tuned, near, near2 = (gemm_input(32, 576, 576, 16),
                          gemm_input(40, 576, 576, 16),
                          gemm_input(48, 1536, 576, 16))
    first = [tuned, near, near, near2, tuned, near2]
    want = ["plan", "nearest", "plan", "nearest", "plan", "plan"]
    got_j, got_t = _run(jdispatch, first), _run(tdispatch, first)
    assert got_t == got_j and [t for _, t in got_t] == want
    gen = tstore.serving_state().generation
    assert gen == tstore.serving_state().plan.generation  # no bump on promote

    # the store gains a record: the plan stands aside, nothing is promoted
    new = gemm_input(40, 576, 576, 16)
    for mod, key in ((jstore, "j"), (tstore, "t")):
        stores[key].add(mod.TuneRecord(space="gemm", inputs=new,
                                       config=CFG_B, tflops=3.0, backend=FP,
                                       created_at=5000.0))
    second = [tuned, new, near2, near2]
    got_j, got_t = _run(jdispatch, second), _run(tdispatch, second)
    assert got_t == got_j
    assert [t for _, t in got_t] == ["exact", "exact", "nearest", "nearest"]

    # the next install compiles a plan of the store as it is now
    jstore.install_serving(store=stores["j"])
    tstore.install_serving(store=stores["t"])
    got_j, got_t = _run(jdispatch, second), _run(tdispatch, second)
    assert got_t == got_j
    assert [t for _, t in got_t] == ["plan", "plan", "nearest", "plan"]
    jplan, tplan = jstore.serving_state().plan, tstore.serving_state().plan
    assert (tplan.hits, tplan.misses) == (jplan.hits, jplan.misses) == (3, 1)
    for attr in ("hits", "misses", "nearest_hits"):
        assert getattr(stores["t"], attr) == getattr(stores["j"], attr)
    assert tdispatch.tier_counts[("gemm", "plan")] == 7


def _compiled(mod, store, fingerprint=FP):
    mod.install_serving(store=store, fingerprint=fingerprint)
    plan = mod.serving_state().plan
    assert plan is not None and plan.source == "compiled"
    return plan


@pytest.mark.parametrize("exported_by", ["reference", "port"])
def test_artifact_loads_across_packages(tmp_path, exported_by):
    path = tmp_path / "db.jsonl"
    _write(jstore, path)
    src_mod, src_plans = ((jstore, jplans) if exported_by == "reference"
                          else (tstore, tplans))
    store = src_mod.RecordStore.open(path)
    plan = _compiled(src_mod, store)
    promoted = gemm_input(40, 576, 576, 16)
    plan.promote("gemm", tstore.shape_key(promoted), CFG_B, "nearest")
    dest = src_plans.export_plan(plan, src_plans.default_plan_dir(path),
                                 store=store)
    assert dest == tmp_path / "db.jsonl.plan" / "00000001"
    jp, tp = jplans.load_plan(dest), tplans.load_plan(dest)
    assert tp.source == jp.source == "loaded"
    assert tp.digest == jp.digest == jplans.read_manifest(dest).digest
    assert tp._table == jp._table and len(tp) == len(plan)
    assert tp.lookup("gemm", tstore.shape_key(promoted)) == (CFG_B,
                                                             "nearest")
    # the same table serialises to the same bytes in both packages
    assert (tplans.entries_blob(tplans.plan_entries(tp))
            == jplans.entries_blob(jplans.plan_entries(jp)))
    assert tplans.read_manifest(dest) == tplans.PlanManifest.from_dict(
        jplans.read_manifest(dest).to_dict())


@pytest.fixture
def artifact(tmp_path):
    store = _write(tstore, tmp_path / "s.jsonl")
    dest = tplans.export_plan(_compiled(tstore, store), tmp_path / "out",
                              store=store)
    return store, dest


def test_export_refuses_when_the_store_outran_the_plan(tmp_path):
    store = _write(tstore, tmp_path / "s.jsonl")
    plan = _compiled(tstore, store)
    store.add(tstore.TuneRecord(space="gemm", inputs=gemm_input(64, 64, 64),
                                config=CFG_A, tflops=1.0, backend=FP))
    with pytest.raises(tplans.StalePlanError, match="recompile"):
        tplans.export_plan(plan, tmp_path / "out", store=store)
    assert not (tmp_path / "out").exists() or not any(
        (tmp_path / "out").iterdir())
    assert tplans.export_plan(_compiled(tstore, store), tmp_path / "out",
                              store=store).exists()


@pytest.mark.parametrize("damage,match", [
    ("tamper", "digest mismatch"),
    ("torn", "torn or unreadable"),
    ("missing", "no manifest"),
    ("schema", "refusing to misread"),
    ("count", "promises"),
])
@pytest.mark.parametrize("mod", ["reference", "port"])
def test_damaged_artifact_is_refused(artifact, damage, match, mod):
    _, dest = artifact
    manifest = dest / tplans.MANIFEST_NAME
    entries = dest / tplans.ENTRIES_NAME
    if damage == "tamper":
        entries.write_bytes(entries.read_bytes().replace(b'"bm": 64',
                                                         b'"bm": 8'))
    elif damage == "torn":
        text = manifest.read_text()
        manifest.write_text(text[:len(text) // 2])
    elif damage == "missing":
        manifest.unlink()
    else:
        doc = json.loads(manifest.read_text())
        if damage == "schema":
            doc["plan_schema_version"] = tplans.PLAN_SCHEMA_VERSION + 1
        else:
            doc["n_entries"] += 1
        manifest.write_text(json.dumps(doc))
    plans = jplans if mod == "reference" else tplans
    with pytest.raises(plans.PlanArtifactError, match=match):
        plans.load_plan(dest)
    if mod == "port":
        with pytest.raises(tplans.PlanArtifactError, match=match):
            tstore.install_serving(store=None, plan_dir=dest)


def test_freshness_warns_when_the_store_gained_records(artifact):
    store, dest = artifact
    assert tplans.check_freshness(tplans.read_manifest(dest), store) is None
    store.add(tstore.TuneRecord(space="gemm", inputs=gemm_input(64, 64, 64),
                                config=CFG_A, tflops=5.0, backend=FP,
                                created_at=9e9))
    note = tplans.check_freshness(tplans.read_manifest(dest), store)
    assert note is not None and "newer" in note


class _CountingModels:
    """A model set stand-in that counts every consultation."""

    def __init__(self):
        self.calls = 0

    def predict(self, *a, **k):
        self.calls += 1
        return None

    def __len__(self):
        return 1


def test_plan_dir_cold_start_skips_model_scans(tmp_path):
    store = _write(tstore, tmp_path / "s.jsonl")
    tel = ttel.get_telemetry()
    for x, n in HOT:
        tel.record("gemm", x, n=n)
    plan = _compiled(tstore, store)
    warm = [tdispatch._resolve_cfg("gemm", x)[0] for x, _ in HOT[:4]]
    dest = tplans.export_plan(plan, tmp_path / "out", store=store)
    ttel.clear_telemetry()
    cold = tstore.RecordStore.open(tmp_path / "s.jsonl")
    models = _CountingModels()
    state = tstore.install_serving(store=cold, models=models, plan_dir=dest)
    assert state.plan.source == "loaded" and models.calls == 0
    assert state.plan.store_version == cold.version == 0
    assert state.plan.digest == tplans.read_manifest(dest).digest
    tdispatch.reset_counts()
    assert [tdispatch._resolve_cfg("gemm", x) for x, _ in HOT[:4]] == [
        (c, "plan") for c in warm]


def test_plan_only_serving_adopts_the_artifact_fingerprint(artifact):
    _, dest = artifact
    tstore.clear_store()
    state = tstore.install_serving(store=None, plan_dir=dest)
    assert state.store is None and state.fingerprint == FP
    assert tdispatch._resolve_cfg("gemm", gemm_input(32, 576, 576, 16)) == (
        CFG_A, "plan")
    assert state.plan.hits == 1
    # a shape the plan does not hold degrades: there is no store to ask
    with pytest.warns(RuntimeWarning, match="no launchable record"):
        cfg, tier = tdispatch._resolve_cfg("gemm", gemm_input(7, 7, 7, 16))
    assert tier == "degraded" and state.plan.misses == 1


def test_bad_plan_dir_raises_not_degrades(tmp_path):
    store = _write(tstore, tmp_path / "s.jsonl")
    before = tstore.serving_state()
    with pytest.raises(tplans.PlanArtifactError):
        tstore.install_serving(store=store, plan_dir=tmp_path / "nope")
    assert tstore.serving_state() is before


def test_no_plan_entry_serves_a_config_the_kernel_cannot_launch(tmp_path):
    """A TPU-tuned record never enters a compiled plan, a promotion of such
    a config is refused, and an artifact holding one (the reference's)
    loses the entry, with one warning, when the port installs it; each such
    shape resolves on the slow path to a launchable neighbour."""
    tpu_shape, near = gemm_input(32, 576, 576, 16), gemm_input(40, 576, 576,
                                                               16)
    records = [(tpu_shape, CFG_TPU, FP), (near, CFG_A, FP)]
    path = tmp_path / "db.jsonl"
    jstore_ = _write(jstore, path, records)
    key = tstore.shape_key(tpu_shape)

    tstore_ = tstore.RecordStore.open(path)
    plan = _compiled(tstore, tstore_)
    assert plan.lookup("gemm", key) is None
    assert plan.lookup("gemm", tstore.shape_key(near)) == (CFG_A, "exact")
    plan.promote("gemm", key, CFG_TPU, "nearest")
    assert plan.lookup("gemm", key) is None
    with pytest.warns(RuntimeWarning, match="cannot launch"):
        assert tdispatch._resolve_cfg("gemm", tpu_shape) == (CFG_A,
                                                             "nearest")
    assert tdispatch._resolve_cfg("gemm", tpu_shape) == (CFG_A, "plan")

    # the reference compiles and exports the TPU config as it stands
    jplan = _compiled(jstore, jstore_)
    assert jplan.lookup("gemm", key) == (CFG_TPU, "exact")
    dest = jplans.export_plan(jplan, tmp_path / "out", store=jstore_)
    with pytest.warns(RuntimeWarning, match="cannot launch") as rec:
        state = tstore.install_serving(store=tstore.RecordStore.open(path),
                                       fingerprint=FP, plan_dir=dest)
    assert sum("cannot launch" in str(w.message) for w in rec) == 1
    assert state.plan.lookup("gemm", key) is None and len(state.plan) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert tdispatch._resolve_cfg("gemm", tpu_shape) == (CFG_A,
                                                             "nearest")
    assert tdispatch._resolve_cfg("gemm", tpu_shape) == (CFG_A, "plan")
    # plan-only: nothing to fall back to but the heuristics, never bn=1024
    with pytest.warns(RuntimeWarning, match="cannot launch"):
        tstore.install_serving(store=None, plan_dir=dest)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cfg, tier = tdispatch._resolve_cfg("gemm", tpu_shape)
    assert tier == "degraded" and gemm_fits(cfg, 16)


def test_store_merge_export_and_stats(tmp_path):
    """merge / export / stats of the port's store against the
    reference's: the same files in, the same bytes out."""
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _write(jstore, a, RECORDS[:3])
    _write(jstore, b, RECORDS[2:], t0=2000.0)
    outs = {}
    for name, mod in (("j", jstore), ("t", tstore)):
        merged = mod.RecordStore.open(tmp_path / f"{name}-merged.jsonl")
        n = merged.merge(mod.RecordStore.open(a))
        n += merged.merge(mod.RecordStore.open(b))
        out = tmp_path / f"{name}-export.jsonl"
        outs[name] = (n, len(merged), merged.export(out), out.read_bytes())
        assert not out.with_name(out.name + ".tmp").exists()
    assert outs["t"] == outs["j"]
    js = jstore.RecordStore.open(tmp_path / "j-merged.jsonl").stats()
    ts = tstore.RecordStore.open(tmp_path / "t-merged.jsonl").stats()
    for k in ("shapes", "records", "lines", "skipped_lines",
              "sample_records", "per_space", "per_backend", "lookups",
              "schema_version"):
        assert ts[k] == js[k], k


# ---------------------------------------------------------------------------
# the registry and the follower (the cases of ``tests/test_plans.py``)
# ---------------------------------------------------------------------------

REG_SHAPES = [gemm_input(128 * (i + 1), 64, 512, 16) for i in range(4)]
GEN_BM = (16, 32, 64, 128)


def _gen_plan(mod, gen, shapes=REG_SHAPES):
    """A plan whose every entry names its generation through ``bm``."""
    table = {("gemm", mod.shape_key(x)): (dict(CFG_A, bm=GEN_BM[gen % 4]),
                                          "exact") for x in shapes}
    return mod.DispatchPlan(generation=0, fingerprint=FP, store_version=-1,
                            table=table)


def _gen_of(plan, shape=REG_SHAPES[0]):
    return GEN_BM.index(plan.lookup("gemm", tstore.shape_key(shape))[0]["bm"])


@pytest.mark.parametrize("published_by", ["jax", "port"])
def test_registry_pointers_and_digests_match_the_reference(tmp_path,
                                                           published_by):
    assert all(gemm_fits(dict(CFG_A, bm=b), 16) for b in GEN_BM)
    pointers = []
    for mod, pl in ((jstore, jplans), (tstore, tplans)):
        reg = pl.PlanRegistry(tmp_path / pl.__name__)
        assert reg.current() is None
        m1 = reg.publish(_gen_plan(mod, 1))
        m2 = reg.publish(_gen_plan(mod, 2))
        assert (m1.generation, m2.generation) == (1, 2)
        pointer = reg.current()
        pointers.append({k: v for k, v in pointer.items()
                         if k not in ("published_at", "created_at")})
    assert pointers[1] == pointers[0]
    assert pointers[1]["path"] == "generations/00000002"
    # each package pulls the other's registry, digest checked
    pub = jplans if published_by == "jax" else tplans
    root = tmp_path / pub.__name__
    for pl in (jplans, tplans):
        reg = pl.PlanRegistry(root)
        plan = reg.pull(reg.current())
        assert plan.digest == pointers[1]["digest"]
    bad = dict(tplans.PlanRegistry(root).current(),
               digest="sha256:" + "0" * 64)
    with pytest.raises(tplans.PlanArtifactError, match="does not match"):
        tplans.PlanRegistry(root).pull(bad)


def _follow_sequence(mod, pl, root, sentry):
    """Publish 1, 2; roll CURRENT back to 1; publish 3 torn; publish 4
    dropping three planned shapes; publish 5 whole: what the follower
    installs, and its counters."""
    reg = pl.PlanRegistry(root)
    holder = {}
    f = pl.PlanFollower(reg, name="t", sentry=sentry,
                        install=lambda p, ptr: holder.update(p=p) or True,
                        current_plan=lambda: holder.get("p"))
    seen = [f.poll_once()]                          # nothing published
    reg.publish(_gen_plan(mod, 1))
    seen.append(f.poll_once()["generation"])
    seen.append(f.poll_once())                      # the same: no reinstall
    reg.publish(_gen_plan(mod, 2))
    seen.append(f.poll_once()["generation"])
    old = json.loads((reg.generation_dir(1) / jplans.MANIFEST_NAME)
                     .read_text())
    old["path"] = "generations/00000001"
    (root / "CURRENT.json").write_text(json.dumps(old))
    seen.append(f.poll_once())                      # a rollback: refused
    reg.publish(_gen_plan(mod, 3))
    torn = reg.generation_dir(3) / jplans.ENTRIES_NAME
    torn.write_bytes(torn.read_bytes()[:10])
    seen.append(f.poll_once())                      # torn: refused
    reg.publish(_gen_plan(mod, 0, REG_SHAPES[:1]))  # loses 3 shapes
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seen.append(f.poll_once())
    seen.append(any("lose coverage" in str(w.message) for w in caught))
    reg.publish(_gen_plan(mod, 1))
    seen.append(f.poll_once()["generation"])
    st = {k: v for k, v in f.stats().items()
          if k not in ("lag_s", "registry")}
    f.stop()
    return seen, st, _gen_of(holder["p"])


def test_follower_refusals_match_the_reference(tmp_path):
    from repro.tunedb.obs import RegressionSentry as JSentry
    from repro_torch.tunedb.obs import RegressionSentry as TSentry
    got = [_follow_sequence(jstore, jplans, tmp_path / "j", JSentry()),
           _follow_sequence(tstore, tplans, tmp_path / "t", TSentry())]
    assert got[1] == got[0]
    seen, st, gen = got[1]
    assert seen == [None, 1, None, 2, None, None, None, True, 5]
    assert (st["refused_stale"], st["refused_digest"],
            st["refused_sentry"]) == (1, 1, 1)
    assert st["installs"] == 3 and st["generation"] == 5 and gen == 1


def test_follower_installs_into_the_serving_state(tmp_path):
    """The default target: ``install_serving(plan=...)``, the artifact's
    fingerprint adopted, dispatch resolving on the plan; the collector
    and ``/status`` carry the follower."""
    from repro_torch.tunedb.obs import get_registry, status_snapshot
    reg = tplans.PlanRegistry(tmp_path / "reg")
    reg.publish(_gen_plan(tstore, 2))
    f = tplans.PlanFollower(reg, name="rep-0")
    assert f.poll_once()["generation"] == 1
    state = tstore.serving_state()
    assert state.plan.source == "loaded" and state.fingerprint == FP
    cfg = tdispatch._tuned_cfg("gemm", REG_SHAPES[1])
    assert cfg["bm"] == GEN_BM[2]
    doc = status_snapshot()
    assert doc["follower"]["name"] == "rep-0"
    assert doc["follower"]["generation"] == 1
    text = get_registry().render_prometheus()
    assert 'tunedb_follower_generation{follower="rep-0"} 1' in text
    assert 'tunedb_follower_installs_total{follower="rep-0"} 1' in text
    assert 'tunedb_plan_source{source="loaded"} 1' in text
    f.stop()
    assert status_snapshot()["follower"] is None


def test_threaded_follower_never_serves_a_torn_or_stale_plan(tmp_path):
    reg = tplans.PlanRegistry(tmp_path / "reg")
    holder = {}
    f = tplans.PlanFollower(
        reg, name="t", poll_s=0.001,
        install=lambda p, ptr: holder.update(p=(p, int(ptr["generation"])))
        or True,
        current_plan=lambda: holder["p"][0] if "p" in holder else None)
    torn, stale, reads, last = [], [], [0], [0]
    stop = threading.Event()

    def read_loop():
        while not stop.is_set():
            got = holder.get("p")
            if got is None:
                continue
            plan, gen = got
            if gen < last[0]:
                stale.append(gen)
            last[0] = max(last[0], gen)
            marks = {plan.lookup("gemm", tstore.shape_key(x))[0]["bm"]
                     for x in REG_SHAPES}
            if len(marks) > 1:
                torn.append(marks)
            reads[0] += 1

    reader = threading.Thread(target=read_loop, daemon=True)
    f.start()
    reader.start()
    for gen in range(1, 9):
        reg.publish(_gen_plan(tstore, gen))
    deadline = time.time() + 5
    while f.generation != 8 and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    reader.join(5)
    f.stop()
    assert f.generation == 8 and reads[0] > 0
    assert torn == [] and stale == []


def test_coordinator_publish_plan_matches_the_reference(tmp_path):
    import repro.tunedb.fleet as jfleet
    from repro_torch.tunedb import fleet as tfleet
    out = []
    for mod, fl, pl in ((jstore, jfleet, jplans), (tstore, tfleet, tplans)):
        path = tmp_path / pl.__name__ / "db.jsonl"
        _write(mod, path)
        coord = fl.Coordinator(tmp_path / pl.__name__ / "fleet",
                               mod.RecordStore.open(path))
        man = coord.publish_plan(tmp_path / pl.__name__ / "reg",
                                 fingerprint=FP)
        reg = pl.PlanRegistry(tmp_path / pl.__name__ / "reg")
        out.append((man.generation, man.n_entries, man.digest,
                    reg.pull(reg.current()).fingerprint))
    # the port plans no entry its kernel cannot launch: the same records
    # here are all launchable, so the artifacts are byte for byte equal
    assert out[1] == out[0]
    assert out[1][1] == 4 and out[1][3] == FP


def test_cli_plan_publish_and_follow(tmp_path, capsys):
    from repro.tunedb.__main__ import main as jmain
    from repro_torch.tunedb.__main__ import main as tmain
    path = tmp_path / "db.jsonl"
    _write(tstore, path)
    outs = []
    for main, reg in ((jmain, tmp_path / "jreg"), (tmain, tmp_path / "treg")):
        assert main(["plan", "publish", "--store", str(path), "--no-models",
                     "--backend", FP, "--registry", str(reg)]) == 0
        published = capsys.readouterr().out
        assert "published generation 1" in published
        outs.append(json.loads((reg / "CURRENT.json").read_text())["digest"])
    assert outs[1] == outs[0]
    assert tmain(["plan", "follow", "--registry", str(tmp_path / "treg"),
                  "--store", str(path), "--interval", "0.01",
                  "--max-polls", "5"]) == 0
    out = capsys.readouterr().out
    stats = json.loads(out[out.index("{"):])
    assert stats["installs"] == 1 and stats["generation"] == 1
    assert tstore.serving_state().plan.source == "loaded"
    assert tmain(["plan", "follow", "--registry", str(tmp_path / "none"),
                  "--interval", "0.01", "--max-polls", "2"]) == 1
