"""The port's tuning entry point and session on the CPU: ``python -m
repro_torch.tunedb tune --device cpu`` labels its samples with the kernels'
plain versions (the card times the kernels themselves), and the records it
writes are what serving looks up — under one fingerprint that names the
package and the device.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.backend import SimulatedTPUBackend
from repro.tunedb.session import backend_fingerprint as jax_fingerprint
from repro_torch.core.backend import CheckedBackend, CudaEventBackend
from repro_torch.core.generative import CategoricalSampler
from repro_torch.core.dataset import generate_dataset
from repro_torch.core.search import enumerate_legal, exhaustive_search
from repro_torch.core.space import (GEMM_SPACE, SPACES, ConfigRejected,
                                    attention_input, conv_input, gemm_input,
                                    ssd_input)
from repro_torch.core.tuner import InputAwareTuner
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.tunedb import model as tmodel
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb.__main__ import main as cli_main
from repro_torch.tunedb.session import TuningSession, backend_fingerprint

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions' small CPU matmuls run steadier on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tstore.install_serving(store=None, models=None, fingerprint=None)


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "repro_torch.tunedb", *args],
                          capture_output=True, text=True, env=env,
                          timeout=600)


@pytest.mark.parametrize("space,shape,want", [
    ("gemm", "M=4,N=576,K=576", gemm_input(4, 576, 576)),
    ("conv", "N=2,H=8,W=8,C=16,K=32,R=3,S=3", conv_input(2, 8, 8, 16, 32, 3, 3)),
    ("attention", "B=1,Hq=40,Hkv=8,Lq=256,Lkv=256,D=128,causal=1",
     attention_input(1, 40, 8, 256, 256, 128)),
    ("ssd", "B=1,L=300,H=64,P=64,S=128", ssd_input(1, 300, 64, 64, 128)),
])
def test_cli_tune_on_cpu_writes_a_record_naming_package_and_device(
        tmp_path, space, shape, want):
    path = tmp_path / "db.jsonl"
    r = _cli("tune", "--device", "cpu", "--space", space, "--shape", shape,
             "--train-samples", "64", "--epochs", "2", "--store", str(path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 tuned, 0 skipped, 0 failed" in r.stdout
    store = tstore.RecordStore.open(path)
    fp = CudaEventBackend(device="cpu").fingerprint
    assert fp.startswith("repro_torch.CudaEventBackend/") and "device=cpu" in fp
    rec = store.get(space, want, backend=fp)
    assert rec is not None and rec.source == "session"
    assert rec.tflops > 0 and rec.latency_us > 0
    assert SPACES[space].is_legal(rec.config, want)
    # a second run skips the tuned shape; --retune tunes it again
    r = _cli("tune", "--device", "cpu", "--space", space, "--shape", shape,
             "--train-samples", "32", "--epochs", "1", "--store", str(path))
    assert r.returncode == 0 and "0 tuned, 1 skipped" in r.stdout


def test_cli_rejects_a_shape_missing_an_input(tmp_path):
    with pytest.raises(SystemExit, match="missing input param 'K'"):
        cli_main(["tune", "--device", "cpu", "--shape", "M=4,N=8",
                  "--store", str(tmp_path / "db.jsonl")])
    with pytest.raises(SystemExit, match="missing input param 'D'"):
        cli_main(["tune", "--device", "cpu", "--space", "attention",
                  "--shape", "B=1,Hq=2,Hkv=1,Lq=1,Lkv=8",
                  "--store", str(tmp_path / "db.jsonl")])


def test_cli_tunes_the_decode_shape_that_decode_splits_resolve_exact(
        tmp_path):
    """Repair: ``causal`` defaults to 1 in a ``--shape`` (it stopped the
    attention CLI with "missing input param"), and the record tuned at
    SmolLM-135M's decode shape gives the engine's decode ticks their KV
    split count on the exact tier."""
    from repro_torch.serve.flash_decode import resolve_decode_splits
    path = tmp_path / "db.jsonl"
    r = _cli("tune", "--device", "cpu", "--space", "attention", "--shape",
             "B=4,Hq=9,Hkv=3,Lq=1,Lkv=256,D=64", "--train-samples", "32",
             "--epochs", "1", "--top-k", "3", "--store", str(path))
    assert r.returncode == 0 and "1 tuned" in r.stdout, r.stdout + r.stderr
    fp = CudaEventBackend(device="cpu").fingerprint
    store = tstore.RecordStore.open(path)
    rec = store.get("attention", attention_input(4, 9, 3, 1, 256, 64),
                    backend=fp)
    assert rec is not None and rec.inputs["causal"] == 1
    tstore.install_serving(store=store, fingerprint=fp,
                           build_plan=False)
    tdispatch.reset_counts()
    n = resolve_decode_splits(B=4, Hq=9, Hkv=3, Lkv=256, D=64, dtype_bits=16,
                              default=16)
    assert n == 256 // rec.config["b_kv"]
    assert dict(tdispatch.tier_counts) == {("attention", "exact"): 1}


def _tuner(space, backend, pool, n=48):
    """A small tuner trained on ``pool`` (the card's smoke run does the
    same with the library's public pieces)."""
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.mlp import MLP
    rng = np.random.default_rng(0)
    sampler = CategoricalSampler(space).fit(pool, 400, rng)
    inputs, cfgs, y = [], [], []
    while len(cfgs) < n:
        shape = pool[rng.integers(len(pool))]
        cfg = sampler.sample_legal(shape, rng)
        inputs.append(shape)
        cfgs.append(cfg)
        y.append(backend.measure(space.name, cfg, shape))
    feat, X, yl = Dataset(space, inputs, cfgs, np.asarray(y)).featurize()
    model = MLP.create(0, feat.dim, (32, 32))
    model.fit(X, yl, epochs=2)
    return InputAwareTuner(space=space, model=model, featurizer=feat,
                           sampler=sampler, backend=backend, top_k=4)


def test_session_stores_measured_losers_as_samples_that_never_serve(tmp_path):
    backend = CheckedBackend(CudaEventBackend(device="cpu"))
    shape = gemm_input(4, 576, 576)
    tuner = _tuner(GEMM_SPACE, backend, [shape, gemm_input(32, 192, 576)])
    store = tstore.RecordStore(tmp_path / "db.jsonl")
    report = TuningSession(tuner, store, workers=2).run([shape])
    assert (report.tuned, report.failed) == (1, 0)
    winner = report.records[0]
    reopened = tstore.RecordStore.open(tmp_path / "db.jsonl")
    assert reopened.n_lines == 4                    # winner + 3 losers
    fp = backend_fingerprint(backend)
    assert winner.backend == fp == backend.fingerprint
    assert reopened.get("gemm", shape, backend=fp).config == winner.config
    assert [r.source for r in reopened.records()] == ["session"]
    tstore.install_serving(store=reopened, fingerprint=fp,
                           build_plan=False)
    tdispatch.reset_counts()
    cfg, tier = tdispatch._resolve_cfg("gemm", shape)
    assert (cfg, tier) == (winner.config, "exact")


class _FailsOn:
    """A label source that cannot measure one shape (a kernel fault)."""

    def __init__(self, bad):
        self.bad = bad
        self.timer = CudaEventBackend(device="cpu")

    def measure(self, space, cfg, inputs):
        if dict(inputs) == self.bad:
            raise RuntimeError("kernel launch failed: CUDA error 1")
        return self.timer.measure(space, cfg, inputs)


def test_session_reports_a_failed_job_as_failed(tmp_path):
    good, bad = gemm_input(4, 576, 576), gemm_input(32, 192, 576)
    backend = _FailsOn(bad)
    tuner = _tuner(GEMM_SPACE, backend.timer, [good, bad])
    tuner.backend = backend
    report = TuningSession(tuner, tstore.RecordStore(), workers=2).run(
        [good, bad])
    assert (report.jobs, report.tuned, report.failed) == (2, 1, 1)
    assert "CUDA error 1" in report.errors[0] and "'N': 192" in report.errors[0]


def test_serving_installs_the_fingerprint_the_tuner_writes(tmp_path,
                                                           monkeypatch):
    """Repair: one function names the backend everywhere, so the launcher's
    default pin is the string tuned records carry."""
    timer = CudaEventBackend(device="cpu")
    fp = backend_fingerprint(CheckedBackend(timer))
    assert fp == timer.fingerprint == backend_fingerprint(timer)
    # never a reference fingerprint, even for a class of the same name
    assert fp != jax_fingerprint(timer)
    assert backend_fingerprint(SimulatedTPUBackend(noise=0.0)).startswith(
        "repro.SimulatedTPUBackend/")
    from repro_torch.launch import serve
    seen = {}

    class Stop(Exception):
        pass

    def fake_engine(cfg, params, serve_cfg, device=None):
        seen["fp"] = serve_cfg.tunedb_backend
        raise Stop
    monkeypatch.setattr(serve, "Engine", fake_engine)
    with pytest.raises(Stop):
        serve.main(["--smoke", "--device", "cpu", "--tunedb",
                    str(tmp_path / "db.jsonl")])
    assert seen["fp"] == fp
    with pytest.raises(Stop):
        serve.main(["--smoke", "--device", "cpu", "--tunedb",
                    str(tmp_path / "db.jsonl"), "--tunedb-backend", "x"])
    assert seen["fp"] == "x"


def test_backend_times_the_plain_version_on_a_shrunken_cpu_instance():
    be = CudaEventBackend(device="cpu")
    inputs = conv_input(16, 79, 341, 1, 32, 5, 20)
    cfg = {"b_npq": 64, "b_k": 32, "b_c": 8, "rs_unroll": 2, "c_split": 1,
           "order": 0, "acc32": 1, "prefetch": 2}
    small = be.instance("conv", inputs)
    assert (small["N"], small["H"], small["W"]) == (2, 16, 16)
    tflops = be.measure("conv", cfg, inputs)
    us = be.time_us("conv", cfg, inputs)        # the measurement just made
    flops = 2.0 * 2 * 16 * 16 * 32 * 1 * 5 * 20
    assert tflops == pytest.approx(flops / (us * 1e-6) / 1e12)
    with pytest.raises(ValueError, match="no ported kernel"):
        be.measure("fft", {}, inputs)


def test_cli_seed_leaves_the_fingerprint_the_launcher_pins(tmp_path,
                                                          monkeypatch):
    """``--seed`` seeds the training draws, not what a config measures: a
    store tuned with ``--seed 1`` serves on the exact tier under the
    launcher's default pin."""
    path = tmp_path / "db.jsonl"
    shape = gemm_input(4, 576, 576)
    r = _cli("tune", "--device", "cpu", "--space", "gemm", "--shape",
             "M=4,N=576,K=576", "--train-samples", "48", "--epochs", "1",
             "--seed", "1", "--store", str(path))
    assert r.returncode == 0 and "1 tuned" in r.stdout, r.stdout + r.stderr
    from repro_torch.launch import serve
    seen = {}

    class Stop(Exception):
        pass

    def fake_engine(cfg, params, serve_cfg, device=None):
        seen["fp"] = serve_cfg.tunedb_backend
        raise Stop
    monkeypatch.setattr(serve, "Engine", fake_engine)
    with pytest.raises(Stop):
        serve.main(["--smoke", "--device", "cpu", "--tunedb", str(path)])
    store = tstore.RecordStore.open(path)
    tstore.install_serving(store=store, fingerprint=seen["fp"],
                           build_plan=False)
    tdispatch.reset_counts()
    cfg, tier = tdispatch._resolve_cfg("gemm", shape)
    assert tier == "exact"
    assert cfg == store.get("gemm", shape, backend=seen["fp"]).config


class _Rejects:
    """A label source whose gate rejects every ``acc32=0`` config."""

    def __init__(self):
        self.timer = CudaEventBackend(device="cpu")
        self.rejected = 0

    def measure(self, space, cfg, inputs):
        if not cfg["acc32"]:
            self.rejected += 1
            raise ConfigRejected(f"cfg {cfg}: rel err 0.05 > 0.02")
        return 1.0 + cfg["bm"] / 64.0

    def time_us(self, space, cfg, inputs):
        self.measure(space, cfg, inputs)
        return 1.0


def test_gate_rejections_are_neither_labelled_nor_picked():
    backend = _Rejects()
    ds, _ = generate_dataset(GEMM_SPACE, 40, backend=backend, seed=0,
                             n_uniform_fit=200, n_workloads=16)
    assert len(ds) == 40 and backend.rejected > 0
    assert all(c["acc32"] for c in ds.configs)
    shape = gemm_input(32, 576, 576)
    tuner = _tuner(GEMM_SPACE, CudaEventBackend(device="cpu"),
                   [shape], n=16)
    cands = [c for c in tuner.featurizer.space.enumerate()
             if GEMM_SPACE.is_legal(c, shape)][:12]
    mixed = [dict(c, acc32=i % 2) for i, c in enumerate(cands)]
    res = exhaustive_search(GEMM_SPACE, shape, model=tuner.model,
                            featurizer=tuner.featurizer, top_k=12,
                            measure=lambda c: backend.measure("gemm", c, shape),
                            candidates=mixed)
    assert res.best["acc32"] == 1 and all(c["acc32"] for c, _ in res.measured)
    assert len(res.measured) == sum(c["acc32"] for c in mixed)
    with pytest.raises(ConfigRejected, match="rejected all"):
        exhaustive_search(GEMM_SPACE, shape, model=tuner.model,
                          featurizer=tuner.featurizer, top_k=4,
                          measure=lambda c: backend.measure("gemm", c, shape),
                          candidates=[dict(c, acc32=0) for c in cands[:4]])


def test_session_without_remeasure_never_records_a_rejected_winner(
        monkeypatch):
    """``CheckedBackend.time_us`` gates the winner the search did not
    re-measure; a rejected winner fails its job instead of being stored."""
    shape = gemm_input(4, 576, 576)
    backend = CheckedBackend(CudaEventBackend(device="cpu"))
    tuner = _tuner(GEMM_SPACE, backend, [shape], n=16)
    calls = []

    def rejects(space_name, cfg, inputs, **kw):
        calls.append(dict(cfg))
        raise ConfigRejected("gemm: rel err 0.05 > 0.02 against the fp32 "
                             "oracle")
    backend._passed.clear()
    monkeypatch.setattr(tdispatch, "check_config", rejects)
    store = tstore.RecordStore()
    report = TuningSession(tuner, store, workers=1,
                           remeasure=False).run([shape])
    assert (report.tuned, report.failed) == (0, 1) and calls
    assert "ConfigRejected" in report.errors[0] and store.n_lines == 0


def test_cli_tune_train_predict_models_round_trip_on_cpu(tmp_path, capsys):
    """``tune`` -> ``train --device cpu`` -> ``predict`` -> ``models`` on one
    store file: train labels samples at the tuned shapes through the gated
    plain versions and writes ``<store>.models/``, which predict and models
    read."""
    db = tmp_path / "db.jsonl"
    assert cli_main(["tune", "--device", "cpu", "--space", "gemm",
                     "--store", str(db), "--train-samples", "64",
                     "--epochs", "2", "--workers", "1", "--top-k", "4",
                     "--shape", "M=32,N=192,K=576",
                     "--shape", "M=128,N=192,K=576"]) == 0
    assert cli_main(["train", "--device", "cpu", "--store", str(db),
                     "--space", "gemm", "--samples-per-shape", "12",
                     "--min-samples", "8", "--epochs", "3",
                     "--hidden", "16,16"]) == 0
    assert tmodel.default_models_dir(db).is_dir()
    fp = CudaEventBackend(device="cpu").fingerprint
    samples = [r for r in tstore.RecordStore.open(db).training_records()
               if r.source == "sample"]
    assert len(samples) >= 24 and {r.backend for r in samples} == {fp}
    capsys.readouterr()
    assert cli_main(["predict", "--store", str(db), "--shape",
                     "M=64,N=192,K=576", "--top-k", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["backend"] == fp and out["predicted_tflops"] > 0
    assert GEMM_SPACE.is_legal(out["config"], out["inputs"])
    assert len(out["top_k"]) == 3 and out["top_k"][0]["config"] == out["config"]
    assert cli_main(["models", "--store", str(db)]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert list(stats["models"]) == [f"gemm/{fp}"]
    assert stats["skipped_artifacts"] == []


@pytest.mark.parametrize("case,err", [("no model", "no model"),
                                      ("no legal config", "predict failed")])
def test_cli_predict_fails_cleanly(tmp_path, capsys, case, err):
    db = tmp_path / "db.jsonl"
    shape = "M=64,N=192,K=576"
    if case == "no legal config":
        store = tstore.RecordStore(db)
        rng = np.random.default_rng(0)
        for M in (32, 128):
            x = gemm_input(M, 192, 576)
            legal = enumerate_legal(GEMM_SPACE, x)
            for i in rng.permutation(len(legal))[:12]:
                store.add(tstore.TuneRecord(
                    space="gemm", inputs=x, config=legal[int(i)],
                    tflops=float(rng.uniform(1, 2)), backend="b",
                    source="sample"))
        tmodel.train_models(store, hidden=(8,), epochs=1, min_samples=8
                            ).save(tmodel.default_models_dir(db))
        shape += ",dtype_bits=8"            # no kernel runs 8-bit operands
    capsys.readouterr()
    assert cli_main(["predict", "--store", str(db), "--shape", shape]) == 1
    assert err in capsys.readouterr().err


# ---------------------------------------------------------------------------
# plan export / plan inspect / stats / export / merge against the reference
# ---------------------------------------------------------------------------

_CFGS = [{"bm": 32, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 2,
          "order": 0, "acc32": 1, "prefetch": 2},
         {"bm": 64, "bn": 128, "bk": 256, "k_unroll": 2, "k_split": 1,
          "order": 1, "acc32": 0, "prefetch": 1},
         {"bm": 16, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 4,
          "order": 0, "acc32": 1, "prefetch": 1}]


def _mixed_store(path, seed, t0):
    """Served records (re-tunes of one shape among them, two backends) and
    a few samples, in a numpy-seeded order."""
    rng = np.random.default_rng(seed)
    store = tstore.RecordStore(path)
    shapes = [gemm_input(M, N, 576) for M in (4, 32, 100) for N in (192, 576)]
    for t in range(14):
        x = shapes[int(rng.integers(len(shapes)))]
        store.add(tstore.TuneRecord(
            space="gemm", inputs=x, config=_CFGS[int(rng.integers(3))],
            tflops=float(rng.uniform(1, 50)),
            backend=("b1", "b2")[int(rng.integers(2))],
            source=("tuner", "session", "sample")[int(rng.integers(3))],
            created_at=t0 + float(rng.integers(0, 40))))
    return store


def _ref_cli(argv):
    from repro.tunedb.__main__ import main as jcli_main
    return jcli_main(list(argv))


def test_cli_export_and_merge_match_the_reference(tmp_path, capsys):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _mixed_store(a, 0, 1000.0)
    _mixed_store(b, 1, 1020.0)
    for name, run in (("t", cli_main), ("j", _ref_cli)):
        assert run(["export", "--store", str(a), "--out",
                    str(tmp_path / f"{name}-export.jsonl")]) == 0
        assert run(["merge", str(a), str(b), "--out",
                    str(tmp_path / f"{name}-merged.jsonl")]) == 0
    out = capsys.readouterr().out
    assert out.count("[tunedb] exported") == 2
    assert (tmp_path / "t-export.jsonl").read_bytes() == (
        tmp_path / "j-export.jsonl").read_bytes()
    merged = {n: (tmp_path / f"{n}-merged.jsonl").read_text().splitlines()
              for n in "tj"}
    assert merged["t"] == merged["j"] and len(merged["t"]) > 0
    assert all(json.loads(line)["merged_from"] in (str(a), str(b))
               for line in merged["t"])


def test_cli_plan_export_inspect_and_stats_round_trip(tmp_path, capsys):
    from repro_torch.tunedb import plans as tplans
    from repro_torch.tunedb import telemetry as ttel
    db = tmp_path / "db.jsonl"
    _mixed_store(db, 2, 1000.0)
    tel = ttel.ShapeTelemetry()
    for M, n in ((40, 9), (4, 5), (100, 3)):
        tel.record("gemm", gemm_input(M, 576, 576), n=n)
    shapes = tmp_path / "shapes.json"
    tel.save(shapes)
    capsys.readouterr()
    assert cli_main(["plan", "export", "--store", str(db), "--backend", "b1",
                     "--telemetry", str(shapes), "--no-models"]) == 0
    assert "exported plan" in capsys.readouterr().out
    dest = tplans.default_plan_dir(db) / "00000001"
    inspected = {}
    for name, run in (("t", cli_main), ("j", _ref_cli)):
        assert run(["plan", "inspect", str(dest)]) == 0
        inspected[name] = json.loads(capsys.readouterr().out)
    assert inspected["t"] == inspected["j"]
    assert inspected["t"]["verified"] and inspected["t"]["fingerprint"] == "b1"
    assert set(inspected["t"]["tiers"]) <= {"exact", "nearest"}
    plan = tplans.load_plan(dest)
    assert len(plan) == inspected["t"]["n_entries"]
    (dest / tplans.ENTRIES_NAME).write_bytes(b"")
    assert cli_main(["plan", "inspect", str(dest)]) == 1
    assert "rejected" in capsys.readouterr().err
    stats = {}
    for name, run in (("t", cli_main), ("j", _ref_cli)):
        assert run(["stats", "--store", str(db), "--telemetry",
                    str(shapes)]) == 0
        stats[name] = json.loads(capsys.readouterr().out)
    assert stats["t"] == stats["j"]
    assert stats["t"]["telemetry"]["spaces"]["gemm"] == {"shapes": 3,
                                                         "calls": 17}
