"""The port's tuning entry point and session on the CPU: ``python -m
repro_torch.tunedb tune --device cpu`` labels its samples with the kernels'
plain versions (the card times the kernels themselves), and the records it
writes are what serving looks up — under one fingerprint that names the
package and the device.
"""

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
from repro_torch.core.search import exhaustive_search
from repro_torch.core.space import (GEMM_SPACE, SPACES, ConfigRejected,
                                    attention_input, conv_input, gemm_input,
                                    ssd_input)
from repro_torch.core.tuner import InputAwareTuner
from repro_torch.kernels import dispatch as tdispatch
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
    tstore.clear_store()


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
    tstore.install_store(store, fingerprint=fp)
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
    tstore.install_store(reopened, fingerprint=fp)
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
    tstore.install_store(store, fingerprint=seen["fp"])
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
