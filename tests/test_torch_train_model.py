"""The port's training forward against the reference's: ``loss_fn``'s loss,
xent, aux and accuracy and every leaf of its gradient, for each of the ten
SMOKE configs (params through ``params_from_jax``; the MoE configs at a
capacity factor that drops no token, as tests/test_models.py runs them),
fp32 and SmolLM in bf16; ``_chunked_xent`` at a ragged last chunk;
``_block_causal_attention`` and the ``causal_block_skip`` route; remat on
and off; the vision frontend's loss mask and the encoder-decoder's loss.

The reference runs its CPU path, ``jax.value_and_grad`` over ``jnp.dot``
projections: its Pallas GEMM has no gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import loss_fn as jloss_fn
from repro.models import model as JM
from repro_torch.configs import ARCH_NAMES, smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import loss_fn as tloss_fn
from repro_torch.models import model as TM
from repro_torch.models import tree_leaves
from repro_torch.weights import params_from_jax

LOSS_RTOL = 1e-4            # fp32: loss, xent, aux, acc
GRAD_TOL = 1e-3             # fp32: |g - g_ref| / |g_ref| per leaf
BF16_TOL = 3e-2             # bf16: the same measures
MOE = ("arctic-480b", "dbrx-132b", "jamba-v0.1-52b")

_JGRAD = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True),
                 static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    as eight, and leaves the cores to the suite's other workers, whose
    timing tests feel a spinning thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype=None, **over):
    jcfg, tcfg = jregistry.smoke_config(arch), smoke_config(arch)
    if arch in MOE:
        over["capacity_factor"] = 8.0
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.dtype(dtype.__str__()
                                                         .split(".")[-1]))
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(tcfg, **over))


def _batch(cfg, B=2, S=32, seed=0):
    """numpy batch: tokens, and the frontend's patches or the encoder's
    frames where the config has them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["encoder_embeds"] = rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def _jbatch(batch, jcfg):
    return {k: jnp.asarray(v) if k == "tokens" else
            jnp.asarray(v, jcfg.dtype) for k, v in batch.items()}


def _tbatch(batch, tcfg):
    return {k: torch.from_numpy(v).long() if k == "tokens" else
            torch.from_numpy(v).to(tcfg.dtype) for k, v in batch.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _np(t):
    return t.detach().float().numpy()


def _port_value_and_grad(tp, tcfg, batch):
    loss, m = tloss_fn(tp, tcfg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True,
                                materialize_grads=True)
    return m, TM.tree_map(lambda t, it=iter(grads): next(it), tp)


def _run_both(arch, dtype=None, seed=2, **over):
    jcfg, tcfg = _configs(arch, dtype, **over)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    batch = _batch(tcfg)
    (_, jm), jg = _JGRAD(jp, jcfg, _jbatch(batch, jcfg))
    tm, tg = _port_value_and_grad(tp, tcfg, _tbatch(batch, tcfg))
    return jm, jg, tm, tg


def _assert_match(jm, jg, tm, tg, loss_tol, grad_tol):
    for k in ("loss", "xent", "aux", "acc"):
        got, want = float(tm[k].detach()), float(jm[k])
        assert abs(got - want) <= loss_tol * max(abs(want), 1.0), (k, got,
                                                                    want)
    jgp, tgp = _paths(jax.tree_util.tree_map(np.asarray, jg)), _paths(
        TM.tree_map(_np, tg))
    assert set(jgp) == set(tgp)
    worst = {}
    for k, want in jgp.items():
        got = tgp[k]
        assert got.shape == want.shape, k
        assert np.isfinite(got).all(), k
        ref = float(np.linalg.norm(want))
        err = float(np.linalg.norm(got - want))
        worst[k] = err / ref if ref > 1e-12 else err
    bad = {k: e for k, e in worst.items() if e > grad_tol}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_equal_the_reference(arch):
    jm, jg, tm, tg = _run_both(arch)
    _assert_match(jm, jg, tm, tg, LOSS_RTOL, GRAD_TOL)
    if arch in MOE:
        assert float(tm["aux"].detach()) > 0


def test_bf16_loss_and_grads_equal_the_reference():
    jm, jg, tm, tg = _run_both("smollm-135m", dtype=torch.bfloat16)
    _assert_match(jm, jg, tm, tg, BF16_TOL, BF16_TOL)


def test_block_causal_route_equals_the_reference():
    """``causal_block_skip`` with 4 chunks of 8: the loss and grads of the
    block-skipping path, in both packages."""
    jm, jg, tm, tg = _run_both("smollm-135m", causal_block_skip=True,
                               attn_chunk=8)
    _assert_match(jm, jg, tm, tg, LOSS_RTOL, GRAD_TOL)


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24), (48, 16)])
def test_block_causal_attention_equals_the_reference(S, chunk):
    rng = np.random.default_rng(S)
    B, H, G, D = 2, 6, 2, 8
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, G, D)).astype(np.float32)
    v = rng.normal(size=(B, S, G, D)).astype(np.float32)
    want = JL._block_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), chunk=chunk)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = TL._block_causal_attention(tq, tk, tv, chunk=chunk)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # equal to the plain chunked scan, and with the reference's gradient
    plain = TL._chunked_attention(tq, tk, tv, causal=True, q_start=0,
                                  chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=1e-5, atol=1e-5)
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(JL._block_causal_attention(
        *a, chunk=chunk) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tgrads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                 (tq, tk, tv))
    for g, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(g), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)


def test_block_causal_attention_refuses_a_ragged_sequence():
    x = torch.zeros((1, 12, 2, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TL._block_causal_attention(x, x[:, :, :1], x[:, :, :1], chunk=8)


@pytest.mark.parametrize("S,chunk", [(31, 8), (31, 64), (20, 7)])
def test_chunked_xent_at_a_ragged_last_chunk(S, chunk):
    """The port's chunks without the reference's pad give its numbers,
    the loss, the accuracy and both gradients."""
    rng = np.random.default_rng(S + chunk)
    B, D, V = 2, 16, 40
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    emb = (0.3 * rng.normal(size=(V, D))).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jcfg = dataclasses.replace(jregistry.smoke_config("smollm-135m"),
                               logit_chunk=chunk)
    tcfg = dataclasses.replace(smoke_config("smollm-135m"), logit_chunk=chunk)

    def jf(xx, ee):
        return JM._chunked_xent(jcfg, xx, ee, jnp.asarray(tgt),
                                jnp.asarray(mask))
    (jx, jacc), jvjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(emb))
    tx, te = (torch.from_numpy(a).requires_grad_(True) for a in (x, emb))
    xent, acc = TM._chunked_xent(tcfg, tx, te, torch.from_numpy(tgt),
                                 torch.from_numpy(mask))
    assert abs(float(xent) - float(jx)) <= LOSS_RTOL * abs(float(jx))
    assert float(acc) == pytest.approx(float(jacc), abs=1e-7)
    gx, ge = torch.autograd.grad(xent, (tx, te))
    jgx, jge = jvjp((jnp.ones(()), jnp.zeros(())))
    np.testing.assert_allclose(_np(gx), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(_np(ge), np.asarray(jge), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_remat_on_and_off_give_the_same_loss_and_grads(arch):
    _, tcfg = _configs(arch)
    gen = torch.Generator()
    gen.manual_seed(3)
    tp = TM.init_params(tcfg, gen)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    batch = _tbatch(_batch(tcfg, seed=4), tcfg)
    out = {}
    for remat in (True, False):
        out[remat] = _port_value_and_grad(
            tp, dataclasses.replace(tcfg, remat=remat), batch)
    (m1, g1), (m0, g0) = out[True], out[False]
    assert float(m1["loss"]) == float(m0["loss"])
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_vision_frontend_masks_the_patch_positions():
    """The patch positions carry target 0 and mask 0; a batch's own
    ``loss_mask`` and ``targets`` follow them; and the loss does not move
    when a patch's would-be target changes."""
    cfg = smoke_config("internvl2-76b")
    batch = _tbatch(_batch(cfg), cfg)
    np_ = cfg.n_frontend_tokens
    targets, mask = TM._frontend_concat_shapes(cfg, batch, torch.device("cpu"))
    assert targets.shape == mask.shape == (2, np_ + 32)
    assert not targets[:, :np_].any() and not mask[:, :np_].any()
    assert torch.equal(targets[:, np_:], batch["tokens"])
    assert bool((mask[:, np_:] == 1).all())
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = TM.init_params(cfg, gen)
    with torch.no_grad():
        base = float(tloss_fn(tp, cfg, batch)[0])
        half = dict(batch, loss_mask=torch.cat(
            [torch.ones(2, 16), torch.zeros(2, 16)], dim=1))
        masked = float(tloss_fn(tp, cfg, half)[0])
    assert base != masked and np.isfinite(masked)


def test_encoder_decoder_loss_reads_the_memory():
    """whisper's loss runs the encoder: other frames, another loss."""
    cfg = smoke_config("whisper-base")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = TM.init_params(cfg, gen)
    batch = _tbatch(_batch(cfg), cfg)
    with torch.no_grad():
        a = float(tloss_fn(tp, cfg, batch)[0])
        b = float(tloss_fn(tp, cfg, dict(
            batch, encoder_embeds=batch["encoder_embeds"] * 2))[0])
    assert np.isfinite(a) and np.isfinite(b) and a != b


def test_serving_calls_make_no_autograd_node():
    """Without autograd (no parameter requires grad) a prefill adds no
    checkpoint and no GEMM Function: its logits have no grad_fn."""
    cfg = smoke_config("smollm-135m")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = TM.init_params(cfg, gen)
    cache = TM.init_cache(cfg, 1, 16, torch.device("cpu"))
    logits, _ = TM.prefill(tp, cfg, {"tokens": torch.zeros((1, 8),
                                                           dtype=torch.long)},
                           cache)
    assert logits.grad_fn is None
