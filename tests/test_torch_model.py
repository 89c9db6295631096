"""The port's model modules and logits against the JAX model on the CPU,
on the same parameters (converted with ``params_from_jax``) and inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as jconfigs
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import prefill as jprefill
from repro.serve.flash_decode import flash_decode_attention as jflash
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.models import decode_step as tdecode
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import layers as TL
from repro_torch.models import prefill as tprefill
from repro_torch.serve.flash_decode import flash_decode_attention as tflash
from repro_torch.weights import params_from_jax

CPU = torch.device("cpu")
TOL = 1e-4          # per module, fp32
LOGIT_TOL = 1e-3    # logits, fp32
BF16_TOL = 3e-2     # logits, bf16


def _rel(got, want) -> float:
    g = np.asarray(got, np.float32) if not isinstance(got, torch.Tensor) \
        else got.float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _pair(splits: int = 1, dtype: str = "float32"):
    jcfg = dataclasses.replace(jconfigs.SMOKE, decode_kv_splits=splits,
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.SMOKE, decode_kv_splits=splits,
                               dtype=getattr(torch, dtype))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def smoke():
    return _pair()


def _layer0(jp, tp):
    jl = jax.tree_util.tree_map(lambda v: v[0], jp["layers"]["pos0"])
    tl = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
              else v[0]) for k, v in tp["layers"]["pos0"].items()}
    return jl, tl


def _attn_kwargs(cfg, **kw):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                causal=True, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                norm_eps=cfg.norm_eps, attn_chunk=cfg.attn_chunk, **kw)


def test_params_convert_exactly(smoke):
    jcfg, tcfg, jp, tp = smoke
    np.testing.assert_array_equal(
        tp["layers"]["pos0"]["attn"]["wq"].numpy(),
        np.asarray(jp["layers"]["pos0"]["attn"]["wq"]))
    assert tp["embed"].shape == (tcfg.padded_vocab, tcfg.d_model)
    # bf16 goes through float32 and back, exactly
    _, _, jb, tb = _pair(dtype="bfloat16")
    np.testing.assert_array_equal(
        tb["embed"].float().numpy(), np.asarray(jb["embed"], np.float32))


def test_rms_norm_and_rope(rng):
    x = rng.normal(size=(2, 5, 3, 24)).astype(np.float32)
    scale = rng.normal(size=(24,)).astype(np.float32)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    assert _rel(got, JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))) < TOL
    pos_s = np.arange(5)
    pos_b = np.stack([np.arange(5) + 7, np.arange(5) + 2])
    for pos in (pos_s, pos_b):
        got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        assert _rel(got, want) < TOL


def test_mlp(smoke, rng):
    jcfg, tcfg, jp, tp = smoke
    jl, tl = _layer0(jp, tp)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    got = TL.mlp(tl["mlp"], torch.from_numpy(x))
    assert _rel(got, JL.mlp(jl["mlp"], jnp.asarray(x))) < TOL


@pytest.mark.parametrize("splits", [1, 4])
def test_attention_prefill_then_per_slot_decode(splits, rng):
    jcfg, tcfg, jp, tp = _pair(splits)
    jl, tl = _layer0(jp, tp)
    B, S, Lmax = 3, 9, 32
    G, D = tcfg.n_kv, tcfg.hd
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    jcache = {"k": jnp.zeros((B, Lmax, G, D)), "v": jnp.zeros((B, Lmax, G, D))}
    tcache = {"k": torch.zeros((B, Lmax, G, D)), "v": torch.zeros((B, Lmax, G, D))}
    pos = np.arange(S)
    jo, jcache = JL.attention(jl["attn"], jnp.asarray(x),
                              positions=jnp.asarray(pos), cache=jcache,
                              cache_index=jnp.zeros((), jnp.int32),
                              **_attn_kwargs(jcfg, decode_kv_splits=splits))
    to, tcache = TL.attention(tl["attn"], torch.from_numpy(x),
                              positions=torch.from_numpy(pos), cache=tcache,
                              cache_index=0,
                              **_attn_kwargs(tcfg, decode_kv_splits=splits))
    assert _rel(to, jo) < TOL
    assert _rel(tcache["k"], jcache["k"]) < TOL

    # per-slot decode: every slot at its own position, one near the end
    idx = np.array([S, 4, Lmax - 1])
    xd = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    jo, jcache = JL.attention(jl["attn"], jnp.asarray(xd),
                              positions=jnp.asarray(idx[:, None]),
                              cache=jcache, cache_index=jnp.asarray(idx),
                              **_attn_kwargs(jcfg, decode_kv_splits=splits))
    to, tcache = TL.attention(tl["attn"], torch.from_numpy(xd),
                              positions=torch.from_numpy(idx[:, None]),
                              cache=tcache, cache_index=torch.from_numpy(idx),
                              **_attn_kwargs(tcfg, decode_kv_splits=splits))
    assert _rel(to, jo) < TOL
    assert _rel(tcache["v"], jcache["v"]) < TOL


def test_flash_decode_attention(rng):
    B, H, G, L, D = 3, 6, 2, 32, 16
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, G, D)).astype(np.float32)
    v = rng.normal(size=(B, L, G, D)).astype(np.float32)
    for kv_len in (np.array([5, 32, 17]), 20):
        got = tflash(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), torch.as_tensor(kv_len), n_splits=4)
        want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(kv_len), n_splits=4)
        assert _rel(got, want) < TOL


def _logits_pair(splits: int, dtype: str):
    jcfg, tcfg, jp, tp = _pair(splits, dtype)
    B, S, Lmax = 2, 11, 32
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab, (B, S))
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                      jinit_cache(jcfg, B, Lmax))
    tl, tc = tprefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                      tinit_cache(tcfg, B, Lmax, CPU))
    out = [(tl, jl)]
    idx = np.array([S, S])
    for t in range(3):
        step = rng.integers(0, tcfg.vocab, (B, 1))
        jl, jc = jdecode(jp, jcfg, jnp.asarray(step), jc, jnp.asarray(idx + t))
        tl, tc = tdecode(tp, tcfg, torch.from_numpy(step), tc,
                         torch.from_numpy(idx + t))
        out.append((tl, jl))
    return out


@pytest.mark.parametrize("splits", [1, 4])
def test_prefill_and_decode_logits_fp32(splits):
    for got, want in _logits_pair(splits, "float32"):
        assert got.shape == want.shape
        assert _rel(got, want) < LOGIT_TOL


def test_prefill_and_decode_logits_bf16():
    for got, want in _logits_pair(4, "bfloat16"):
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) < BF16_TOL
