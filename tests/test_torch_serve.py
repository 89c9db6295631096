"""The port's serving engine against the JAX engine: same small config,
same (converted) weights, same prompts -> identical greedy tokens."""

import dataclasses
import os
import subprocess
import sys
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
