"""The port's record store and config tiers against the JAX package's:
the same JSONL file opens in both, and the same installed store resolves
the same config and tier for exact and nearest shapes; with the same
reference-trained performance model installed in both, a shape nobody
tuned resolves on the model tier, the port's pick being the reference
model's argmax over the port's launchable configs."""

import dataclasses
import warnings

import pytest

import repro.tunedb.model as jmodel
import repro.tunedb.store as jstore
from repro.core.space import SPACES as JSPACES
from repro.core.tuner import clear_tuners
from repro.kernels import dispatch as jdispatch
from repro_torch.core.search import enumerate_legal
from repro_torch.core.space import GEMM_SPACE, gemm_fits, gemm_input
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import matmul as kmatmul
from repro_torch.tunedb import model as tmodel
from repro_torch.tunedb import store as tstore

FP = "repro_torch-cuda-test"

# Hopper-legal configs (and legal in the reference's space too)
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
]


@pytest.fixture(autouse=True)
def _clean_serving_state():
    clear_tuners()
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    tstore.install_serving(store=None, models=None, fingerprint=None)
    assert all(gemm_fits(cfg, 16) for cfg in (CFG_A, CFG_B, CFG_C))
    yield
    jstore.install_serving(store=None, models=None, fingerprint=None,
                           build_plan=False)
    tstore.install_serving(store=None, models=None, fingerprint=None)


def _write_jax_store(path):
    js = jstore.RecordStore(path)
    for t, (inputs, cfg, fp) in enumerate(RECORDS):
        js.add(jstore.TuneRecord(space="gemm", inputs=inputs, config=cfg,
                                 tflops=1.5 + t, backend=fp, source="tuner",
                                 created_at=1000.0 + t))
    return js


def test_store_written_by_reference_opens_in_port(tmp_path):
    path = tmp_path / "db.jsonl"
    _write_jax_store(path)
    ts = tstore.RecordStore.open(path)
    assert ts.n_skipped == 0 and ts.n_lines == len(RECORDS)
    for inputs, cfg, fp in RECORDS:
        rec = ts.get("gemm", inputs, backend=fp)
        assert rec is not None and rec.config == cfg and rec.backend == fp
    # any-backend lookup sees the newest record, as in the reference
    newest = ts.get("gemm", gemm_input(32, 576, 576, 16))
    assert newest.backend == "other-backend"


def test_store_written_by_port_opens_in_reference(tmp_path):
    path = tmp_path / "db.jsonl"
    ts = tstore.RecordStore(path)
    for t, (inputs, cfg, fp) in enumerate(RECORDS):
        ts.add(tstore.TuneRecord(space="gemm", inputs=inputs, config=cfg,
                                 tflops=2.0, backend=fp, source="tuner",
                                 created_at=2000.0 + t))
    js = jstore.RecordStore.open(path)
    assert js.n_skipped == 0 and js.n_lines == len(RECORDS)
    for t, (inputs, cfg, fp) in enumerate(RECORDS):
        rec = js.get("gemm", inputs, backend=fp)
        assert rec is not None and rec.config == cfg
        assert rec.created_at == 2000.0 + t
    # line-for-line the same bytes as the reference writes
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            assert jstore.TuneRecord.from_json(line).to_json() == line.strip()


QUERIES = [
    (gemm_input(32, 576, 576, 16), "exact"),
    (gemm_input(32, 1536, 576, 16), "exact"),
    (gemm_input(40, 576, 576, 16), "nearest"),
    (gemm_input(32, 1536, 640, 16), "nearest"),
    (gemm_input(300, 4096, 4096, 16), "nearest"),
    (gemm_input(4, 192, 576, 16), "degraded"),
    (gemm_input(32, 576, 576, 32), "degraded"),     # dtype must match
    # with the reference's model installed in both (see below)
    (gemm_input(100, 576, 576, 16), "model"),
    (gemm_input(48, 1536, 576, 16), "model"),
    (gemm_input(512, 4096, 4096, 16), "exact"),     # exact beats the model
]
# the model cases: the queries from the first "model" one on
MODEL_CASES = next(i for i, (_, t) in enumerate(QUERIES) if t == "model")


@pytest.fixture(scope="module")
def reference_models(tmp_path_factory):
    """A tiny GEMM regressor trained by the reference on made-up samples of
    FP at configs legal in both spaces, saved as an artifact."""
    jstore_mem = jstore.RecordStore()
    for t, M in enumerate((32, 64, 128)):
        for N in (576, 1536):
            x = gemm_input(M, N, 576, 16)
            legal = [c for c in enumerate_legal(GEMM_SPACE, x)
                     if JSPACES["gemm"].is_legal(c, x)]
            for j, c in enumerate(legal[::9]):
                jstore_mem.add(jstore.TuneRecord(
                    space="gemm", inputs=x, config=c, backend=FP,
                    tflops=0.01 * M * c["bn"] / (c["k_split"] + j % 3),
                    source="sample", created_at=1.0 + t))
    models = jmodel.train_models(jstore_mem, space="gemm", hidden=(8,),
                                 epochs=2, min_samples=8)
    return models.save(tmp_path_factory.mktemp("models"))


@pytest.mark.parametrize("inputs,tier", QUERIES)
def test_tiers_match_the_reference(tmp_path, request, inputs, tier):
    path = tmp_path / "db.jsonl"
    _write_jax_store(path)
    jmodels = tmodels = None
    if QUERIES.index((inputs, tier)) >= MODEL_CASES:
        d = request.getfixturevalue("reference_models")
        jmodels, tmodels = jmodel.ModelSet.load(d), tmodel.ModelSet.load(d)
    jstore.install_serving(store=jstore.RecordStore.open(path),
                           models=jmodels, fingerprint=FP, build_plan=False)
    tstore.install_serving(store=tstore.RecordStore.open(path),
                           models=tmodels, fingerprint=FP, build_plan=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jcfg, jtier = jdispatch._resolve_cfg("gemm", inputs)
        tcfg, ttier = tdispatch._resolve_cfg("gemm", inputs)
    assert jtier == ttier == tier
    if tier == "model":             # the spaces differ: argmax over the port's
        pm = jmodels.resolve_model("gemm", FP)
        want = pm.predict_config(inputs, candidates=enumerate_legal(
            GEMM_SPACE, inputs)).best
        assert tcfg == want and tmodels.hits == 1
    elif tier != "degraded":        # heuristics differ by design (menus)
        assert tcfg == jcfg
    assert gemm_fits(tcfg, inputs["dtype_bits"])


def test_tpu_only_config_falls_through_and_warns_once(tmp_path):
    path = tmp_path / "db.jsonl"
    ts = tstore.RecordStore(path)
    shape = gemm_input(32, 576, 576, 16)
    ts.add(tstore.TuneRecord(space="gemm", inputs=shape, config=CFG_TPU,
                             tflops=9.0, backend=FP))
    ts.add(tstore.TuneRecord(space="gemm", inputs=gemm_input(48, 576, 576, 16),
                             config=CFG_A, tflops=1.0, backend=FP))
    tstore.install_serving(store=ts, fingerprint=FP,
                           build_plan=False)
    with pytest.warns(RuntimeWarning, match="cannot launch") as rec:
        cfg, tier = tdispatch._resolve_cfg("gemm", shape)
    assert tier == "nearest" and cfg == CFG_A
    assert sum("cannot launch" in str(w.message) for w in rec) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a second warning would raise
        assert tdispatch._resolve_cfg("gemm", shape) == (CFG_A, "nearest")

    # with no launchable neighbor the heuristics serve: never the TPU config
    ts2 = tstore.RecordStore()
    ts2.add(tstore.TuneRecord(space="gemm", inputs=shape, config=CFG_TPU,
                              tflops=9.0, backend=FP))
    tstore.install_serving(store=ts2, fingerprint=FP,
                           build_plan=False)
    before = kmatmul.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cfg, tier = tdispatch._resolve_cfg("gemm", shape)
        import torch
        a = torch.ones((32, 576))
        out = tdispatch.matmul(a, torch.ones((576, 576)))
    assert tier == "degraded" and cfg != CFG_TPU and gemm_fits(cfg, 16)
    assert torch.allclose(out, torch.full((32, 576), 576.0))
    assert kmatmul.launches == before           # CPU: the plain version ran


def test_corrupted_line_crc_is_refused(tmp_path):
    path = tmp_path / "db.jsonl"
    _write_jax_store(path)
    lines = path.read_text(encoding="utf-8").splitlines()
    # flip a config value but keep the JSON valid: only the CRC can tell
    assert '"bm": 32' in lines[0]
    lines[0] = lines[0].replace('"bm": 32', '"bm": 64', 1)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    with pytest.raises(ValueError, match="CRC"):
        tstore.TuneRecord.from_json(lines[0])
    ts = tstore.RecordStore.open(path)
    assert ts.n_skipped == 1 and ts.n_lines == len(RECORDS) - 1
    assert ts.get("gemm", RECORDS[0][0], backend=FP) is None


def test_install_store_is_the_ports_own():
    """Installing in the port leaves the reference's serving state alone."""
    before = jstore.serving_state()
    ts = tstore.RecordStore()
    tstore.install_store(ts, fingerprint=FP)
    assert jstore.serving_state() is before
    assert tstore.serving_state().store is ts
    assert dataclasses.replace(tstore.serving_state()).fingerprint == FP
