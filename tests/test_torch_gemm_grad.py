"""The GEMM's gradient through the tuned dispatch (``kernels/dispatch.py``
``_TunedGemm``): dA and dB through ``dispatch.matmul`` against
``jax.grad`` of ``jnp.dot`` (the reference trains through ``jnp.dot``: its
Pallas GEMM has no gradient) at several (M, N, K), ragged ones and split-K
configs among them; the gradient runs through the port's Function and
nowhere else; the backward's two shapes land in the telemetry; without
autograd no node is made."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.space import gemm_input
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops
from repro_torch.tunedb.telemetry import clear_telemetry, get_telemetry

SHAPES = [(16, 24, 40), (5, 100, 300), (130, 33, 70), (64, 576, 192)]
SPLITK = {"bm": 32, "bn": 32, "bk": 32, "k_unroll": 1, "k_split": 4,
          "order": 0, "acc32": 1, "prefetch": 2}
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    as eight, and leaves the cores to the suite's other workers, whose
    timing tests feel a spinning thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(M, N, K, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    w = rng.normal(size=(M, N)).astype(np.float32)
    return a, b, w


def _ref_grads(a, b, w):
    return jax.grad(lambda x, y: jnp.sum(jnp.dot(x, y) * w),
                    argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))


def _port_grads(a, b, w):
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    out = tdispatch.matmul(ta, tb)
    da, db = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (ta, tb))
    return out, da, db


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=RTOL * float(
                                   np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_grads_equal_jax_grad_of_dot(M, N, K, split, monkeypatch):
    if split:
        monkeypatch.setattr(tdispatch, "_tuned_cfg", lambda s, x: SPLITK)
    a, b, w = _operands(M, N, K)
    out, da, db = _port_grads(a, b, w)
    ja, jb = _ref_grads(a, b, w)
    _close(out, np.asarray(a) @ np.asarray(b))
    _close(da, ja)
    _close(db, jb)


def test_the_output_comes_from_the_function():
    a, b, _ = _operands(8, 8, 8)
    out = tdispatch.matmul(torch.from_numpy(a).requires_grad_(True),
                           torch.from_numpy(b))
    assert isinstance(out.grad_fn, tdispatch._TunedGemm._backward_cls)
    y = tdispatch.matmul2(torch.from_numpy(a)[None].requires_grad_(True),
                          torch.from_numpy(b))
    assert y.shape == (1, 8, 8) and y.grad_fn is not None


def test_the_gradient_is_the_functions_not_autograds_own(monkeypatch):
    """Replace the Function's backward with a marker: the gradients are the
    marker, so autograd does not differentiate ``matmul_plain``'s ops on
    its own (on the card those ops do not run)."""
    def marked(ctx, dc):
        a, b = ctx.saved_tensors
        return torch.full_like(a, 7.0), torch.full_like(b, -3.0)
    monkeypatch.setattr(tdispatch._TunedGemm, "backward", staticmethod(marked))
    a, b, w = _operands(6, 10, 12)
    _, da, db = _port_grads(a, b, w)
    assert bool((da == 7.0).all()) and bool((db == -3.0).all())


def test_the_backward_shapes_land_in_the_telemetry():
    M, N, K = 48, 20, 36
    clear_telemetry()
    tel = get_telemetry()
    a, b, w = _operands(M, N, K)
    _port_grads(a, b, w)
    bits = 32
    assert tel.count("gemm", gemm_input(M, N, K, bits)) == 1     # C = A B
    assert tel.count("gemm", gemm_input(M, K, N, bits)) == 1     # dA = dC Bt
    assert tel.count("gemm", gemm_input(K, N, M, bits)) == 1     # dB = At dC
    assert tel.total("gemm") == 3
    # only B requires grad (a weight under an activation that does not):
    # one backward product
    clear_telemetry()
    out = tdispatch.matmul(torch.from_numpy(a),
                           torch.from_numpy(b).requires_grad_(True))
    out.sum().backward()
    assert tel.total("gemm") == 2
    assert tel.count("gemm", gemm_input(M, K, N, bits)) == 0
    clear_telemetry()


def test_without_autograd_no_node_is_made():
    a, b, _ = _operands(8, 16, 24)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert tdispatch.matmul(ta, tb).grad_fn is None
    with torch.no_grad():
        out = tdispatch.matmul(ta.requires_grad_(True), tb)
    assert out.grad_fn is None and not out.requires_grad


def test_views_of_a_stacked_leaf_accumulate_its_grad():
    """Weights reach the GEMM as views of a leaf stacked over repeats: the
    Function returns grads of the view's shape, and the leaf's ``.grad``
    holds every repeat's."""
    R, M, N, K = 3, 10, 12, 14
    rng = np.random.default_rng(1)
    stack = rng.normal(size=(R, K, N)).astype(np.float32)
    xs = rng.normal(size=(R, M, K)).astype(np.float32)
    tstack = torch.from_numpy(stack).requires_grad_(True)
    views = torch.unbind(tstack)
    y = sum((tdispatch.matmul(torch.from_numpy(xs[r]), views[r]) ** 2).sum()
            for r in range(R))
    y.backward()
    want = jax.grad(lambda s: sum(jnp.sum(jnp.dot(xs[r], s[r]) ** 2)
                                  for r in range(R)))(jnp.asarray(stack))
    _close(tstack.grad, want)


def test_split_k_backward_reduces_its_partials(monkeypatch):
    """Under a split-K config each backward product sums its partials with
    the reduction pass (its plain version here)."""
    monkeypatch.setattr(tdispatch, "_tuned_cfg", lambda s, x: SPLITK)
    calls = []
    real = kmatmul.splitk_reduce_plain
    monkeypatch.setattr(kmatmul, "splitk_reduce_plain",
                        lambda p: calls.append(p.shape) or real(p))
    M, N, K = 72, 40, 160
    a, b, w = _operands(M, N, K)
    _port_grads(a, b, w)
    want = [(ops.shrink_gemm_cfg(SPLITK, m, n, k, 32)["k_split"], m, n)
            for m, n, k in ((M, N, K), (M, K, N), (K, N, M))]
    assert calls == [w for w in want if w[0] > 1] and len(calls) >= 2
