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
        assert tiers == {tier}
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
