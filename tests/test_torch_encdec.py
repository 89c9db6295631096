"""The encoder-decoder (whisper-base) and vision-frontend (internvl2-76b)
families of the port against the JAX package on the CPU, at SMOKE, on the
same seeded numpy inputs and (converted) parameters: ``encode``, the
enc-dec ``prefill`` (logits and K/V cache rows) and
``decode_step(memory=)``, a greedy loop, the frontend ``prefill`` with
patch embeddings, ``params_from_jax`` on both trees, ``param_count`` for
every arch, and the refusals (decode without memory, the engine and the
launcher on an enc-dec config).

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (the reference's
tests/test_moe.py's); bf16 3e-2 of the largest |logit| (as
tests/test_torch_ssm.py), since each package rounds every bf16
activation on its own path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.models import model as TM
from repro_torch.models.layers import stacked_init
from repro_torch.weights import params_from_jax

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5       # fp32
BF16_TOL = 3e-2               # bf16, relative to the largest |value|
GREEDY_STEPS = 8
MAX_LEN = 32


def _pair(arch: str, dtype: str = "float32", seed: int = 0):
    jcfg = dataclasses.replace(jregistry.smoke_config(arch),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(smoke_config(arch),
                               dtype=getattr(torch, dtype))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, tree


def _close(got: torch.Tensor, want, dtype: str = "float32") -> None:
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    else:
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
        assert err < BF16_TOL, err


def _inputs(cfg, B: int = 2, T: int = 7, seed: int = 1):
    """Frame (or patch) embeddings and prompt tokens, from ``seed``."""
    rng = np.random.default_rng(seed)
    n = cfg.encoder_len or cfg.n_frontend_tokens
    embeds = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, T))
    steps = rng.integers(0, cfg.vocab, (B, 4))
    return embeds, tokens, steps


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg, jp, tree = _pair("whisper-base")
    return jcfg, tcfg, jp, params_from_jax(tree, tcfg, CPU)


# ---------------------------------------------------------------------------
# whisper-base: encode, prefill, decode_step(memory=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_the_reference(dtype):
    jcfg, tcfg, jp, tree = _pair("whisper-base", dtype)
    tp = params_from_jax(tree, tcfg, CPU)
    frames, _, _ = _inputs(tcfg)
    got = TM.encode(tcfg, tp, torch.from_numpy(frames))
    want = JM.encode(jcfg, jp, jnp.asarray(frames))
    assert got.shape == (2, tcfg.encoder_len, tcfg.d_model)
    assert got.dtype == tcfg.dtype
    _close(got, want, dtype)


def test_cross_attention_matches_the_reference(whisper):
    """Layer 0's cross block alone: K/V from the memory, no RoPE (the
    positions passed change nothing), no mask, no cache."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jcfg, tcfg, jp, tp = whisper
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda v: v[0],
                                jp["layers"]["pos0"]["cross"])
    tl = {k: v[0] for k, v in tp["layers"]["pos0"]["cross"].items()}
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv, head_dim=tcfg.hd,
              causal=False, rope_theta=tcfg.rope_theta, qk_norm=False,
              norm_eps=tcfg.norm_eps, attn_chunk=tcfg.attn_chunk)
    want, _ = JL.attention(jl, jnp.asarray(x), positions=jnp.arange(5),
                           memory=jnp.asarray(mem), **kw)
    for pos in (torch.arange(5), torch.arange(5) + 100):
        got, cache = TL.attention(tl, torch.from_numpy(x), positions=pos,
                                  memory=torch.from_numpy(mem), **kw)
        assert cache is None
        _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_prefill_and_decode_match_the_reference(dtype):
    """Prefill of a 7-token prompt with ``encoder_embeds`` (the logits and
    every layer's K/V cache rows), then 4 ``decode_step(memory=)`` ticks
    at per-slot positions."""
    jcfg, tcfg, jp, tree = _pair("whisper-base", dtype)
    tp = params_from_jax(tree, tcfg, CPU)
    frames, toks, steps = _inputs(tcfg)
    B, T = toks.shape
    jc = JM.init_cache(jcfg, B, MAX_LEN)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "encoder_embeds": jnp.asarray(frames)},
                        jc)
    tc = TM.init_cache(tcfg, B, MAX_LEN, CPU)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "encoder_embeds": torch.from_numpy(frames)},
                        tc)
    _close(tl, jl, dtype)
    for k in ("k", "v"):
        rows = tc["pos0"]["attn"][k]
        _close(rows[:, :, :T], jc["pos0"]["attn"][k][:, :, :T], dtype)
        assert not rows[:, :, T:].any()
    jmem = JM.encode(jcfg, jp, jnp.asarray(frames))
    tmem = TM.encode(tcfg, tp, torch.from_numpy(frames))
    for j in range(steps.shape[1]):
        idx = np.full((B,), T + j, np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(steps[:, j:j + 1]),
                                jc, jnp.asarray(idx), memory=jmem)
        tl, tc = TM.decode_step(tp, tcfg,
                                torch.from_numpy(steps[:, j:j + 1]), tc,
                                torch.from_numpy(idx).long(), memory=tmem)
        assert tl.shape == (B, tcfg.padded_vocab)
        _close(tl, jl, dtype)


def test_encdec_greedy_tokens_equal_the_reference(whisper):
    """An 8-token greedy loop from one prompt: the same tokens.  Where
    they part, the failure gives the reference's gap between its top two
    logits at that step (a near-tie may flip on the last bit)."""
    jcfg, tcfg, jp, tp = whisper
    frames, toks, _ = _inputs(tcfg, B=1, T=5, seed=4)
    jc = JM.init_cache(jcfg, 1, MAX_LEN)
    tc = TM.init_cache(tcfg, 1, MAX_LEN, CPU)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "encoder_embeds": jnp.asarray(frames)},
                        jc)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "encoder_embeds": torch.from_numpy(frames)},
                        tc)
    jmem = JM.encode(jcfg, jp, jnp.asarray(frames))
    tmem = TM.encode(tcfg, tp, torch.from_numpy(frames))
    got, want = [], []
    for i in range(GREEDY_STEPS):
        jv = np.asarray(jl)[0, : tcfg.vocab]
        tv = tl[0, : tcfg.vocab]
        top2 = np.sort(jv)[-2:]
        jt, tt = int(jv.argmax()), int(tv.argmax())
        assert tt == jt, (f"step {i}: token {tt} vs the reference's {jt}, "
                          f"its top-two gap {top2[1] - top2[0]:.3e}")
        got.append(tt)
        want.append(jt)
        pos = toks.shape[1] + i
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray([[jt]]), jc, pos,
                                memory=jmem)
        tl, tc = TM.decode_step(tp, tcfg, torch.tensor([[tt]]), tc, pos,
                                memory=tmem)
    assert got == want and len(got) == GREEDY_STEPS


def test_encdec_decode_without_memory_raises(whisper):
    _, tcfg, _, tp = whisper
    tc = TM.init_cache(tcfg, 1, MAX_LEN, CPU)
    with pytest.raises(ValueError, match="enc-dec decode requires encoder "
                                         "memory"):
        TM.decode_step(tp, tcfg, torch.zeros((1, 1), dtype=torch.long), tc,
                       0)


def test_engine_refuses_encdec(whisper):
    from repro_torch.serve import Engine, ServeConfig
    _, tcfg, _, tp = whisper
    with pytest.raises(ValueError, match="enc-dec serving"):
        Engine(tcfg, tp, ServeConfig(max_len=MAX_LEN, slots=2), device=CPU)


@pytest.mark.parametrize("argv,msg", [
    (["--arch", "whisper-base", "--smoke", "--device", "cpu"],
     "enc-dec serving"),
    (["--arch", "whisper-base", "--device", "cpu"], "enc-dec serving"),
    (["--arch", "internvl2-76b", "--device", "cpu"], "use --smoke"),
    (["--arch", "mamba2-1.3b", "--device", "cpu"], "use --smoke"),
])
def test_launcher_refuses_as_the_reference(argv, msg):
    """The reference launcher's two refusals: a config over 1e9
    parameters on the CPU without --smoke, and any enc-dec config."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=msg):
        serve.main(argv)


# ---------------------------------------------------------------------------
# internvl2-76b: the vision frontend's prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_prefill_and_decode_match_the_reference(dtype):
    """Prefill of 8 patch embeddings and 7 tokens (positions 0..14, the
    cache filled from 0), then 4 decode steps from index 15."""
    jcfg, tcfg, jp, tree = _pair("internvl2-76b", dtype)
    tp = params_from_jax(tree, tcfg, CPU)
    patches, toks, steps = _inputs(tcfg)
    B, T = toks.shape
    n = tcfg.n_frontend_tokens + T
    jc = JM.init_cache(jcfg, B, MAX_LEN)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "patch_embeds": jnp.asarray(patches)}, jc)
    tc = TM.init_cache(tcfg, B, MAX_LEN, CPU)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "patch_embeds": torch.from_numpy(patches)},
                        tc)
    _close(tl, jl, dtype)
    rows = tc["pos0"]["attn"]["k"]
    _close(rows[:, :, :n], jc["pos0"]["attn"]["k"][:, :, :n], dtype)
    assert not rows[:, :, n:].any()
    for j in range(steps.shape[1]):
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(steps[:, j:j + 1]),
                                jc, n + j)
        tl, tc = TM.decode_step(tp, tcfg,
                                torch.from_numpy(steps[:, j:j + 1]), tc,
                                n + j)
        _close(tl, jl, dtype)


def test_frontend_prefill_without_patches_is_the_token_prefill():
    """A vision config given tokens only prefills them alone (the engine
    serves it so), and the patches change the logits."""
    jcfg, tcfg, jp, tree = _pair("internvl2-76b")
    tp = params_from_jax(tree, tcfg, CPU)
    patches, toks, _ = _inputs(tcfg)
    tc = TM.init_cache(tcfg, 2, MAX_LEN, CPU)
    tl, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc)
    jl, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       JM.init_cache(jcfg, 2, MAX_LEN))
    _close(tl, jl)
    tc = TM.init_cache(tcfg, 2, MAX_LEN, CPU)
    with_p, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                      "patch_embeds":
                                      torch.from_numpy(patches)}, tc)
    assert (with_p - tl).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_converts_the_whisper_tree(dtype):
    """The encoder's stack has encoder_layers as its leading dim; every
    decoder layer carries ``cross`` and ``norm_cross``; every leaf is the
    reference's."""
    _, tcfg, _, tree = _pair("whisper-base", dtype)
    tp = params_from_jax(tree, tcfg, CPU)
    enc = tp["encoder"]
    assert set(enc) == {"pos0", "norm"}
    assert set(enc["pos0"]) == {"norm1", "norm2", "attn", "mlp"}
    assert enc["pos0"]["attn"]["wq"].shape[0] == tcfg.encoder_layers
    dec = tp["layers"]["pos0"]
    assert set(dec["cross"]) == {"wq", "wk", "wv", "wo"}
    assert dec["norm_cross"].shape == (tcfg.n_repeats, tcfg.d_model)
    flat_t = {"/".join(map(str, p)): v for p, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = flat_t["/".join(map(str, p))]
        assert got.dtype == getattr(torch, dtype)
        assert np.array_equal(got.float().numpy(), np.asarray(v, np.float32))


def test_params_from_jax_holds_the_encoder_to_its_layer_count():
    _, tcfg, _, tree = _pair("whisper-base")
    cfg = dataclasses.replace(tcfg, encoder_layers=3)
    with pytest.raises(ValueError, match="encoder.pos0.*config wants 3"):
        params_from_jax(tree, cfg, CPU)
    del tree["layers"]["pos0"]["norm_cross"]
    with pytest.raises(KeyError, match="norm_cross"):
        params_from_jax(tree, tcfg, CPU)


def test_params_from_jax_converts_the_internvl2_tree():
    _, tcfg, _, tree = _pair("internvl2-76b", "bfloat16")
    tp = params_from_jax(tree, tcfg, CPU)
    assert set(tp) == {"embed", "final_norm", "layers"}
    assert "cross" not in tp["layers"]["pos0"]
    for k, v in tree["layers"]["pos0"]["attn"].items():
        assert np.array_equal(tp["layers"]["pos0"]["attn"][k].float().numpy(),
                              np.asarray(v, np.float32)), k


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_init_params_have_the_reference_layout_and_dtypes(arch):
    _, tcfg, _, tree = _pair(arch, "bfloat16")
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    flat_t = {"/".join(map(str, p)): v for p, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    flat_j = {"/".join(map(str, p)): v for p, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert set(flat_t) == set(flat_j)
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        assert str(flat_t[k].dtype).split(".")[-1] == v.dtype.name, k


def test_stacked_init_fills_slice_by_slice():
    """Each repeat slice is its own draw at dense_init's 1/sqrt(fan_in)
    scale, in the target dtype."""
    gen = torch.Generator().manual_seed(0)
    w = stacked_init(gen, (3,), (64, 96), torch.bfloat16)
    assert w.shape == (3, 64, 96) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * 64 ** 0.5 - 1) < 0.1
    assert not torch.equal(w[0], w[1])
    w = stacked_init(gen, (2,), (96, 64), torch.float32, fan_in=8)
    assert abs(float(w.std()) * 8 ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(jregistry.ARCH_NAMES))
def test_param_count_equals_the_reference(arch, smoke):
    got = smoke_config(arch) if smoke else get_config(arch)
    want = (jregistry.smoke_config(arch) if smoke
            else jregistry.get_config(arch))
    assert got.param_count == want.param_count
    assert got.active_param_count == want.active_param_count
    assert got.is_encdec == want.is_encdec


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_param_count_counts_the_init_params(arch):
    """``param_count`` is the number of elements ``init_params`` makes
    (the padded vocabulary's embedding included)."""
    cfg = smoke_config(arch)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in TM.tree_leaves(tp)) == cfg.param_count


def test_every_reference_arch_is_ported():
    assert ARCH_NAMES == jregistry.ARCH_NAMES
    for arch in ARCH_NAMES:
        get_config(arch).check_supported()
        smoke_config(arch).check_supported()
