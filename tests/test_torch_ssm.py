"""The port's Mamba-2 mixer (``repro_torch.models.ssm``), the mamba2-1.3b
model and its serving against the JAX package on the CPU, on the same
seeded numpy inputs and (converted) parameters."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1p3b as jconfigs
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import ssm as JS
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import mamba2_1p3b as tconfigs
from repro_torch.models import decode_step as tdecode
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit_params
from repro_torch.models import prefill as tprefill
from repro_torch.models import ssm as TS
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServeConfig
from repro_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-4          # per module, fp32
LOGIT_TOL = 1e-3    # logits, fp32
BF16_TOL = 3e-2     # logits, bf16


def _rel(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(dtype: str = "float32"):
    jcfg = dataclasses.replace(jconfigs.SMOKE, dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.SMOKE, dtype=getattr(torch, dtype))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def smoke():
    return _pair()


def _layer0(jp, tp):
    jl = jax.tree_util.tree_map(lambda v: v[0], jp["layers"]["pos0"]["mamba"])
    tl = {k: v[0] for k, v in tp["layers"]["pos0"]["mamba"].items()}
    return jl, tl


def _block_kwargs(cfg):
    return dict(d_model=cfg.d_model, state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim, chunk=cfg.ssd_chunk)


def _ssd_operands(rng, B, L, H, P, S):
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, L, H)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32)
    bm = rng.normal(size=(B, L, S)).astype(np.float32)
    cm = rng.normal(size=(B, L, S)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv(carried, rng):
    B, L, C = 2, 7, 24
    xbc = rng.normal(size=(B, L, C)).astype(np.float32)
    w = rng.normal(size=(TS.CONV_WIDTH, C)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    st = (rng.normal(size=(B, TS.CONV_WIDTH - 1, C)).astype(np.float32)
          if carried else None)
    got, got_state = TS._causal_conv(_t(xbc), _t(w), _t(b),
                                     None if st is None else _t(st))
    want, want_state = JS._causal_conv(
        jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


# L below the chunk, equal to it, and ragged past it (two chunks, padded)
@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("L", [12, 32, 75])
def test_ssd_chunked(L, final, rng):
    ops = _ssd_operands(rng, 2, L, 4, 8, 16)
    got = TS.ssd_chunked(*map(_t, ops), chunk=32, return_final_state=final)
    want = JS.ssd_chunked(*map(jnp.asarray, ops), chunk=32,
                          return_final_state=final)
    if final:
        (got, got_state), (want, want_state) = got, want
        assert got_state.dtype == torch.float32
        assert _rel(got_state, want_state) < TOL
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


def test_ssd_decode_step(rng):
    B, H, P, S = 3, 4, 8, 16
    state = rng.normal(size=(B, H, P, S)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, H)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32)
    bm = rng.normal(size=(B, S)).astype(np.float32)
    cm = rng.normal(size=(B, S)).astype(np.float32)
    args = (state, x, dt, a, bm, cm)
    got_state, got = TS.ssd_decode_step(*map(_t, args))
    want_state, want = JS.ssd_decode_step(*map(jnp.asarray, args))
    assert _rel(got_state, want_state) < TOL
    assert _rel(got, want) < TOL


# a 1-token prefill takes the decode branch; 40 tokens span two chunks
@pytest.mark.parametrize("L", [1, 9, 40])
def test_mamba_block_prefill_then_decode(smoke, L, rng):
    jcfg, tcfg, jp, tp = smoke
    jl, tl = _layer0(jp, tp)
    B = 2
    jcache = JS.init_mamba_cache(B, jcfg.d_model, jcfg.ssm_state,
                                 jcfg.ssm_head_dim, jcfg.dtype)
    tcache = TS.init_mamba_cache(B, tcfg.d_model, tcfg.ssm_state,
                                 tcfg.ssm_head_dim, tcfg.dtype, CPU)
    conv, ssm = tcache["conv"], tcache["ssm"]
    x = rng.normal(size=(B, L, tcfg.d_model)).astype(np.float32)
    jo, jcache = JS.mamba_block(jl, jnp.asarray(x), cache=jcache,
                                **_block_kwargs(jcfg))
    to, tcache = TS.mamba_block(tl, _t(x), cache=tcache,
                                **_block_kwargs(tcfg))
    assert _rel(to, jo) < TOL
    # the state is written into the caller's tensors
    assert tcache["conv"] is conv and tcache["ssm"] is ssm
    assert _rel(conv, jcache["conv"]) < TOL
    assert _rel(ssm, jcache["ssm"]) < TOL
    for _ in range(3):
        xd = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
        jo, jcache = JS.mamba_block(jl, jnp.asarray(xd), cache=jcache,
                                    **_block_kwargs(jcfg))
        to, tcache = TS.mamba_block(tl, _t(xd), cache=tcache,
                                    **_block_kwargs(tcfg))
        assert _rel(to, jo) < TOL
        assert _rel(ssm, jcache["ssm"]) < TOL
    # no cache: the training/prefill scan from zero state
    jo, _ = JS.mamba_block(jl, jnp.asarray(x), **_block_kwargs(jcfg))
    to, none = TS.mamba_block(tl, _t(x), **_block_kwargs(tcfg))
    assert none is None and _rel(to, jo) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_convert_exactly(dtype):
    jcfg, tcfg, jp, tp = _pair(dtype)
    jm = jp["layers"]["pos0"]["mamba"]
    tm = tp["layers"]["pos0"]["mamba"]
    assert set(tp["layers"]["pos0"]) == {"norm1", "norm2", "mamba"}
    for k in TS.FP32_LEAVES:
        assert tm[k].dtype == torch.float32
    for k, v in tm.items():
        want = np.asarray(jm[k], np.float32)
        np.testing.assert_array_equal(v.float().numpy(), want)
        if k not in TS.FP32_LEAVES:
            assert v.dtype == tcfg.dtype
    # a leaf at another dtype than the reference's is refused
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["layers"]["pos0"]["mamba"]["a_log"] = np.asarray(
        jm["a_log"]).astype(np.float16)
    with pytest.raises(TypeError, match="a_log"):
        params_from_jax(bad, tcfg, CPU)
    del bad["layers"]["pos0"]["mamba"]["d_skip"]
    with pytest.raises(KeyError, match="d_skip"):
        params_from_jax(bad, tcfg, CPU)


def test_init_params_have_the_reference_layout_and_dtypes():
    jcfg, tcfg, jp, _ = _pair("bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tinit_params(tcfg, gen)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        got = flat_t[jax.tree_util.keystr(path)]
        assert tuple(got.shape) == leaf.shape
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype)
    # the fixed leaves equal the reference's
    for k in TS.FP32_LEAVES:
        np.testing.assert_allclose(
            tp["layers"]["pos0"]["mamba"][k].numpy(),
            np.asarray(jp["layers"]["pos0"]["mamba"][k]), rtol=1e-6)
    cache_j = jinit_cache(jcfg, 3, 16)
    cache_t = tinit_cache(tcfg, 3, 16, CPU)
    for k in ("conv", "ssm"):
        j, t = cache_j["pos0"]["mamba"][k], cache_t["pos0"]["mamba"][k]
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)


def _logits_pair(dtype: str, S: int):
    jcfg, tcfg, jp, tp = _pair(dtype)
    B = 2
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab, (B, S))
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                      jinit_cache(jcfg, B, 64))
    tl, tc = tprefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                      tinit_cache(tcfg, B, 64, CPU))
    out = [(tl, jl)]
    for t in range(3):
        step = rng.integers(0, tcfg.vocab, (B, 1))
        idx = np.array([S + t] * B)
        jl, jc = jdecode(jp, jcfg, jnp.asarray(step), jc, jnp.asarray(idx))
        tl, tc = tdecode(tp, tcfg, torch.from_numpy(step), tc,
                         torch.from_numpy(idx))
        out.append((tl, jl))
    return out


# S=40 > ssd_chunk=32: two chunks, the second ragged
@pytest.mark.parametrize("dtype,tol", [("float32", LOGIT_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("S", [11, 40])
def test_prefill_and_decode_logits(dtype, tol, S):
    for got, want in _logits_pair(dtype, S):
        assert got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) < tol


def test_greedy_tokens_match_the_jax_engine():
    """Slots reused (5 requests, 2 slots), a prompt longer than ssd_chunk
    (33 and 45 > 32) and a 1-token prompt (the decode branch)."""
    jp = jinit_params(jconfigs.SMOKE, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         tconfigs.SMOKE, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tconfigs.SMOKE.vocab, n)
               for n in (5, 33, 1, 45, 9)]
    jout = JEngine(jconfigs.SMOKE, jp, JServeConfig(
        max_len=64, slots=2)).generate(prompts, max_new=6)
    eng = TEngine(tconfigs.SMOKE, tp, TServeConfig(max_len=64, slots=2),
                  device="cpu")
    tout = eng.generate(prompts, max_new=6)
    assert tout == [[int(t) for t in o] for o in jout]
    assert all(len(o) == 6 for o in tout)
    assert eng.prefills == len(prompts)


def test_launcher_serves_mamba_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-1.3b", "--smoke", "--device", "cpu", "--requests", "3",
         "--max-new", "4", "--max-len", "64"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "mamba2-1.3b-smoke on cpu: 3 requests, 12 tokens" in r.stdout
