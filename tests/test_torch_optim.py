"""The port's AdamW and int8 gradient compression against the reference's:
``adamw_update`` over several steps on the same params and grads (fp32 and
bf16 states, clipping active, the schedule at warmup, middle and end),
``compress_grads`` / ``decompress_grads`` bit for bit, and the reference's
property tests ported (the quadratic minimises, stochastic rounding is
unbiased and changes only the dropped bits, error feedback keeps
quantised + error equal to the input, int8 SGD converges).  Stochastic
rounding cannot match JAX's PRNG bit for bit: it is held to its
properties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import compress_grads as jcompress
from repro.optim import decompress_grads as jdecompress
from repro.optim import init_error_feedback as jinit_ef
from repro.optim.adamw import _schedule as jschedule
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, decompress_grads, global_norm,
                               init_error_feedback)
from repro_torch.optim.adamw import _schedule, _stochastic_round

SHAPES = {"w": (8, 12), "b": (12,), "stack": {"x": (2, 4, 6)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    as eight, and leaves the cores to the suite's other workers, whose
    timing tests feel a spinning thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _map(fn, t):
    return {k: _map(fn, v) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)


def _zip(t, u):
    if isinstance(t, dict):
        out = []
        for k in t:
            out += _zip(t[k], u[k])
        return out
    return [(t, u)]


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


@pytest.mark.parametrize("state", ["fp32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_steps_equal_the_reference(state, clip):
    jdt, tdt = ((jnp.float32, torch.float32) if state == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=clip,
              weight_decay=0.1)
    jcfg, tcfg = JAdamWConfig(state_dtype=jdt, **kw), AdamWConfig(
        state_dtype=tdt, **kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, tp = _map(jnp.asarray, p0), _map(torch.from_numpy, p0)
    jopt, topt = jadamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step in range(6):
        g = _tree(rng, scale=3.0)
        jp, jopt, jm = jadamw_update(jp, _map(jnp.asarray, g), jopt, jcfg)
        tp, topt, tm = adamw_update(tp, _map(torch.from_numpy, g), topt,
                                    tcfg)
        assert topt.step == int(jopt.step) == step + 1
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        tol = 1e-5 if state == "fp32" else 1e-2
        for got, want in _zip(tp, jp):
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                       atol=tol)
        for tree_t, tree_j in ((topt.m, jopt.m), (topt.v, jopt.v)):
            for got, want in _zip(tree_t, tree_j):
                assert got.dtype == tdt
                np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                           atol=1e-6)
    if clip == 1.0:
        assert float(tm["grad_norm"]) > clip      # clipping was active


@pytest.mark.parametrize("step", [0, 1, 3, 50, 99, 100, 1000])
def test_schedule_equals_the_reference(step):
    kw = dict(lr=3e-4, warmup_steps=4, total_steps=100, min_lr_frac=0.1)
    assert _schedule(AdamWConfig(**kw), step) == pytest.approx(
        float(jschedule(JAdamWConfig(**kw), jnp.asarray(step))), rel=1e-6)


def test_global_norm():
    rng = np.random.default_rng(1)
    t = _tree(rng)
    want = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                       for x, _ in _zip(t, t)))
    assert float(global_norm(_map(torch.from_numpy, t))) == pytest.approx(
        want, rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_equals_the_reference_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    g = _tree(rng, scale=10.0 ** (seed - 1))
    e = _tree(rng, scale=1e-3)
    jq, js, je = jcompress(_map(jnp.asarray, g), _map(jnp.asarray, e))
    tq, ts, te = compress_grads(_map(torch.from_numpy, g),
                                _map(torch.from_numpy, e))
    for got, want in _zip(tq, jq):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in _zip(ts, js) + _zip(te, je):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in _zip(decompress_grads(tq, ts), jdecompress(jq, js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in _zip(init_error_feedback(_map(torch.from_numpy, g)),
                          jinit_ef(_map(jnp.asarray, g))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compression_rounds_half_to_even():
    """x / scale landing on .5 rounds to the even integer, as jnp.round."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5])
    q, s = compress_grads({"x": x}, {"x": torch.zeros(5)})[:2]
    assert q["x"].tolist()[1:] == [0, 2, 2, -2]


def test_compression_edits_nothing_in_place():
    rng = np.random.default_rng(3)
    g = _map(torch.from_numpy, _tree(rng))
    e = _map(torch.from_numpy, _tree(rng, scale=1e-2))
    before = [(a.clone(), b.clone()) for a, b in _zip(g, e)]
    compress_grads(g, e)
    for (a, b), (a0, b0) in zip(_zip(g, e), before):
        assert torch.equal(a, a0) and torch.equal(b, b0)


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, grad_clip=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params, cfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_reports_the_raw_norm():
    cfg = AdamWConfig(grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params, cfg)
    _, _, m = adamw_update(params, {"w": torch.full((4,), 100.0)}, opt, cfg)
    assert float(m["grad_norm"]) > 100


def test_bf16_states_roundtrip():
    cfg = AdamWConfig(state_dtype=torch.bfloat16)
    params = {"w": torch.ones((8, 8))}
    opt = adamw_init(params, cfg)
    assert opt.m["w"].dtype == torch.bfloat16
    params, opt, _ = adamw_update(params, {"w": torch.ones((8, 8))}, opt, cfg)
    assert opt.v["w"].dtype == torch.bfloat16


@given(st.floats(-100, 100).filter(lambda x: abs(x) > 1e-3))
@settings(max_examples=20, deadline=None)
def test_stochastic_rounding_unbiased(val):
    gen = torch.Generator()
    gen.manual_seed(42)
    x = torch.full((2048,), val, dtype=torch.float32)
    r = _stochastic_round(gen, x, torch.bfloat16).float()
    assert abs(float(r.mean()) - val) < abs(val) * 4e-3 + 1e-6


def test_stochastic_rounding_changes_only_the_dropped_bits():
    """Each result is one of the two bf16 neighbours of its input (the
    truncation or the next one up in magnitude), never farther."""
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.randn(4096, generator=gen) * 10
    r = _stochastic_round(gen, x, torch.bfloat16)
    bits = x.view(torch.int32)
    lo = (bits & -65536).view(torch.float32)
    hi = ((bits & -65536) + 65536).view(torch.float32)
    rf = r.float()
    assert bool(((rf == lo) | (rf == hi)).all())
    assert bool((rf == lo).any()) and bool((rf == hi).any())
    # fp32 targets and bf16 inputs are cast, not rounded stochastically
    assert torch.equal(_stochastic_round(gen, x, torch.float32), x)


def test_adamw_with_stochastic_rounding_moves_bf16_params():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    params = {"w": torch.ones((16, 16), dtype=torch.bfloat16)}
    opt = adamw_init(params, cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params, opt, _ = adamw_update(params, {"w": torch.ones((16, 16))}, opt,
                                  cfg, sr_gen=gen)
    assert params["w"].dtype == torch.bfloat16
    assert bool((params["w"] < 1).any())


def test_compression_error_feedback_property(rng):
    g = {"a": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
    ef = init_error_feedback(g)
    q, s, ef2 = compress_grads(g, ef)
    assert q["a"].dtype == torch.int8
    recon = decompress_grads(q, s)
    np.testing.assert_allclose((recon["a"] + ef2["a"]).numpy(),
                               g["a"].numpy(), rtol=1e-5, atol=1e-6)


def test_compression_converges_sgd(rng):
    w = torch.from_numpy((rng.normal(size=(16,)) * 5).astype(np.float32))
    ef = init_error_feedback({"w": w})
    for _ in range(300):
        q, s, ef = compress_grads({"w": 2 * w}, ef)
        w = w - 0.05 * decompress_grads(q, s)["w"]
    assert float(w.abs().max()) < 0.05

