"""The port's MoE layer (``repro_torch.models.moe``) and the MoE family
(arctic-480b, dbrx-132b, the jamba hybrid) against the JAX package on the
CPU, on the same seeded numpy inputs and (converted) parameters.

Routing is compared first: a near-tie between the k-th and the (k+1)-th
router probability may choose another expert when the two packages' fp32
logits differ in the last bit, so the expert ids are asserted equal
wherever that gap exceeds :data:`GAP`, and the test reports any pair
under it before the outputs are compared."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import init_params as jinit_params
from repro.models import moe as JM
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step as tdecode
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit_params
from repro_torch.models import moe as TM
from repro_torch.models import prefill as tprefill
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServeConfig
from repro_torch.weights import params_from_jax

MOE_ARCHS = ("arctic-480b", "dbrx-132b", "jamba-v0.1-52b")
RTOL, ATOL = 1e-4, 1e-5     # the reference's tests/test_moe.py
GAP = 1e-6                  # router probability gap below which ids may flip
LOGIT_TOL = 1e-3            # model logits, fp32, relative to their max


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _layer(rng, d=32, f=64, E=4, B=2, S=16):
    """A reference layer's parameters and an input, from ``rng``."""
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    jp = JM.init_moe(key, d, f, E, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return jp, tp, x


def _assert_routes_equal(tp, x, E, k) -> None:
    """The port's top-k ids are the reference's wherever the gap between
    the k-th and (k+1)-th probability exceeds GAP (ids as sets: the order
    inside the top k does not change the output)."""
    xt = _t(x).reshape(-1, x.shape[-1])
    tl = xt @ tp["router"]
    jl = jnp.asarray(x).reshape(-1, x.shape[-1]) @ jnp.asarray(
        tp["router"].numpy())
    _, ti = TM._route(tl, k)
    _, ji = JM._route(jl, k)
    probs = torch.softmax(tl, -1).sort(-1, descending=True).values
    gap = (probs[:, k - 1] - probs[:, k]) if k < E else torch.ones(len(tl))
    clear = (gap > GAP).numpy()
    same = (np.sort(ti.numpy(), -1) == np.sort(np.asarray(ji), -1)).all(-1)
    assert same[clear].all(), "expert ids differ on a clear route"
    assert same.all(), (f"expert ids flipped at {int((~same).sum())} "
                        f"near-tied routes, gaps "
                        f"{gap[torch.from_numpy(~same)].tolist()}")


# ---------------------------------------------------------------------------
# routing, capacity, aux loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_matches_the_reference(k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((40, 8)).astype(np.float32) * 3
    tw, ti = TM._route(_t(logits), k)
    jw, ji = JM._route(jnp.asarray(logits), k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    assert torch.allclose(tw.sum(-1), torch.ones(40))


def test_route_renormalizes():
    """The reference's tests/test_moe.py case: the two largest of four."""
    logits = [[0.0, 10.0, 0.0, 5.0]]
    tw, ti = TM._route(torch.tensor(logits), 2)
    jw, ji = JM._route(jnp.asarray(logits), 2)
    assert set(ti[0].tolist()) == {1, 3} == set(np.asarray(ji)[0].tolist())
    assert np.allclose(tw.sum(-1).numpy(), 1.0)
    _close(tw, jw)


@pytest.mark.parametrize("args", [(4096, 4, 16, 1.25), (1, 1, 128, 1.0),
                                  (32, 4, 16, 1.25), (16, 2, 4, 0.25),
                                  (7, 2, 8, 1.25), (100, 4, 16, 1.25)])
def test_capacity_matches_the_reference(args):
    assert TM._capacity(*args) == JM._capacity(*args)
    assert TM._capacity(4096, 4, 16, 1.25) == 1280


def test_aux_loss_matches_the_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 16, 8)).astype(np.float32)
    _, ji = JM._route(jnp.asarray(logits).reshape(32, 8), 2)
    idx = np.asarray(ji).reshape(2, 16, 2)
    got = TM._aux_loss(_t(logits), torch.from_numpy(idx.copy()), 8)
    want = JM._aux_loss(jnp.asarray(logits), jnp.asarray(idx), 8)
    assert got.dtype == torch.float32
    _close(got, want)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,B,S", [(4, 2, 2, 16), (8, 2, 1, 23),
                                     (16, 4, 2, 12)])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_matches_the_reference(cf, E, k, B, S):
    """The capacity path at factors that keep every pair (8.0), drop some
    (1.25 at random routing) and drop many (0.25)."""
    rng = np.random.default_rng(E * 100 + S)
    jp, tp, x = _layer(rng, E=E, B=B, S=S)
    _assert_routes_equal(tp, x, E, k)
    tout, taux = TM.moe(tp, _t(x), n_experts=E, top_k=k, capacity_factor=cf)
    jout, jaux = JM.moe(jp, jnp.asarray(x), n_experts=E, top_k=k,
                        capacity_factor=cf)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    _close(tout, jout)
    _close(taux, jaux)


def test_capacity_drops_change_the_output():
    """At factor 0.25 tokens are dropped (the output parts from the dense
    path); at 8.0 none are (the two paths agree), as the reference's
    tests/test_moe.py holds."""
    rng = np.random.default_rng(0)
    _, tp, x = _layer(rng)
    dense = TM.moe_decode(tp, _t(x), n_experts=4, top_k=2)
    full, aux = TM.moe(tp, _t(x), n_experts=4, top_k=2, capacity_factor=8.0)
    small, _ = TM.moe(tp, _t(x), n_experts=4, top_k=2, capacity_factor=0.25)
    _close(full, dense.numpy())
    assert (small - dense).abs().max() > 1e-3
    assert 0.5 < float(aux) < 4.0
    # a dropped pair contributes nothing: every token past each expert's
    # C kept pairs loses that expert's share
    _, idx = TM._route(_t(x).reshape(-1, 32) @ tp["router"], 2)
    C = TM._capacity(16, 2, 4, 0.25)
    _, pair_slot = TM._dispatch(_t(x), idx.reshape(2, 16, 2), n_experts=4,
                                C=C)
    assert int((pair_slot < 4 * C).sum()) == 2 * 4 * C < 2 * 16 * 2


@pytest.mark.parametrize("B,S", [(4, 1), (1, 1), (2, 5)])
def test_moe_decode_matches_the_reference(B, S):
    rng = np.random.default_rng(B * 10 + S)
    jp, tp, x = _layer(rng, E=8, B=B, S=S)
    _assert_routes_equal(tp, x, 8, 2)
    got = TM.moe_decode(tp, _t(x), n_experts=8, top_k=2)
    want = JM.moe_decode(jp, jnp.asarray(x), n_experts=8, top_k=2)
    _close(got, want)


def test_init_moe_layout_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = TM.init_moe(gen, 32, 48, 4, torch.bfloat16, stack=(3,))
    assert p["router"].shape == (3, 32, 4)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (3, 4, 32, 48)
    assert p["w_down"].shape == (3, 4, 48, 32)
    for k in ("w_gate", "w_up", "w_down"):
        assert p[k].dtype == torch.bfloat16
    # dense_init's 1/sqrt(fan_in) scale, slice by slice
    assert abs(float(p["w_gate"].float().std()) * 32 ** 0.5 - 1) < 0.1
    assert abs(float(p["w_down"].float().std()) * 48 ** 0.5 - 1) < 0.1
    # every slice its own draw
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][0, 1])
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][1, 0])


# ---------------------------------------------------------------------------
# configs, parameters, the model and the engine
# ---------------------------------------------------------------------------

def _pair(arch: str, dtype: str = "float32", seed: int = 2):
    jcfg = dataclasses.replace(jregistry.smoke_config(arch),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(smoke_config(arch),
                               dtype=getattr(torch, dtype))
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_converts_arctic_exactly(dtype):
    _, tcfg, _, tree = _pair("arctic-480b", dtype)
    tp = params_from_jax(tree, tcfg, "cpu")
    moe = tp["layers"]["pos0"]["moe"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down"}
    assert set(tp["layers"]["pos0"]["mlp"]) == {"w_gate", "w_up", "w_down"}
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == getattr(torch, dtype)
    for k, v in tree["layers"]["pos0"]["moe"].items():
        assert np.array_equal(moe[k].float().numpy(),
                              np.asarray(v, np.float32)), k


def test_params_from_jax_refuses_a_router_not_in_fp32():
    _, tcfg, _, tree = _pair("arctic-480b", "bfloat16")
    moe = tree["layers"]["pos0"]["moe"]
    moe["router"] = moe["w_gate"][..., 0, :8].copy()       # bf16, same shape
    with pytest.raises(TypeError, match="router"):
        params_from_jax(tree, tcfg, "cpu")


@pytest.mark.parametrize("top_k", [0, 5])
def test_a_moe_config_wants_top_k_within_its_experts(top_k):
    cfg = dataclasses.replace(smoke_config("dbrx-132b"), top_k=top_k)
    with pytest.raises(ValueError, match="top_k"):
        cfg.check_supported()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_have_the_reference_layout_and_dtypes(arch):
    jcfg, tcfg, _, tree = _pair(arch, "bfloat16")
    tp = tinit_params(tcfg, torch.Generator().manual_seed(0))
    flat_t = {"/".join(map(str, p)): v for p, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    flat_j = {"/".join(map(str, p)): v for p, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert set(flat_t) == set(flat_j)
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        assert str(flat_t[k].dtype).split(".")[-1] == v.dtype.name, k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_logits_match_the_reference(arch):
    """Prefill of 11 tokens into one slot, a 1-token prompt into another
    (the decode path inside prefill), then two decode steps of both."""
    from repro.models import decode_step as jdecode
    from repro.models import init_cache as jinit_cache
    from repro.models import prefill as jprefill
    jcfg, tcfg, jp, tree = _pair(arch)
    tp = params_from_jax(tree, tcfg, "cpu")
    rng = np.random.default_rng(7)
    for n in (11, 1):
        toks = rng.integers(0, tcfg.vocab, (1, n))
        steps = rng.integers(0, tcfg.vocab, (1, 2))
        jc = jinit_cache(jcfg, 1, 32)
        jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
        tc = tinit_cache(tcfg, 1, 32, torch.device("cpu"))
        tl, _ = tprefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc)
        got, want = [tl], [np.asarray(jl)]
        for j in range(2):
            jl, jc = jdecode(jp, jcfg, jnp.asarray(steps[:, j:j + 1]), jc,
                             n + j)
            tl, _ = tdecode(tp, tcfg, torch.from_numpy(steps[:, j:j + 1]),
                            tc, n + j)
            got.append(tl)
            want.append(np.asarray(jl))
        for g, w in zip(got, want):
            w = w[:, : tcfg.vocab]
            g = g[:, : tcfg.vocab].numpy()
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err < LOGIT_TOL, (arch, n, err)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_smoke_serves_the_jax_engine_tokens(arch):
    """Greedy tokens of the JAX engine, prompts of 6, 11, 3, 9 and 1
    tokens (the last takes the decode path in its prefill)."""
    jcfg, tcfg, jp, tree = _pair(arch)
    tp = params_from_jax(tree, tcfg, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in (6, 11, 3, 9, 1)]
    jout = JEngine(jcfg, jp, JServeConfig(max_len=48, slots=3)).generate(
        prompts, max_new=6)
    eng = TEngine(tcfg, tp, TServeConfig(max_len=48, slots=3), device="cpu")
    tout = eng.generate(prompts, max_new=6)
    assert tout == [[int(t) for t in o] for o in jout]
    assert all(len(o) == 6 for o in tout)
