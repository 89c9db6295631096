"""The port's GEMM (plain path on the CPU) against the JAX package's
``ops.matmul`` in Pallas interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.space import (GEMM_SPACE, SMEM_DEFAULT, SMEM_PER_BLOCK,
                                    gemm_fits, gemm_input, gemm_is_legal,
                                    gemm_smem_bytes)
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# shapes of tests/test_kernels.py
GEMM_SHAPES = [(96, 200, 512), (256, 256, 256), (17, 130, 1000),
               (512, 16, 384)]

# legal in the reference's TPU space and in the port's Hopper space
BOTH_LEGAL = [
    {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
     "order": 0, "acc32": 1, "prefetch": 2},
    {"bm": 128, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 2,
     "order": 1, "acc32": 1, "prefetch": 1},
    {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 4,
     "order": 0, "acc32": 1, "prefetch": 2},
    {"bm": 128, "bn": 128, "bk": 256, "k_unroll": 2, "k_split": 1,
     "order": 0, "acc32": 0, "prefetch": 1},
    {"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 2,
     "order": 1, "acc32": 0, "prefetch": 3},
]

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


# fp32 IO needs acc32=1 in both spaces
CASES = [(shape, cfg, dtype) for shape in GEMM_SHAPES for cfg in BOTH_LEGAL
         for dtype in ("float32", "bfloat16")
         if dtype == "bfloat16" or cfg["acc32"]]


@pytest.mark.parametrize("shape,cfg,dtype", CASES)
def test_gemm_matches_jax_interpret(shape, cfg, dtype):
    M, N, K = shape
    rng = np.random.default_rng(M * 7 + N)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) / K ** 0.5).astype(np.float32)
    want = np.asarray(jops.matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                                  cfg, interpret=True), np.float32)
    td = getattr(torch, dtype)
    ta, tb = torch.from_numpy(a).to(td), torch.from_numpy(b).to(td)
    got = tops.matmul(ta, tb, cfg)
    assert got.dtype == td and got.shape == (M, N)
    got = got.float().numpy()
    assert _rel(got, want) < TOL[dtype], (shape, cfg, dtype)
    oracle = tref.matmul_ref(ta, tb).float().numpy()
    assert _rel(got, oracle) < TOL[dtype]


def test_acc32_0_rounds_like_the_tpu_kernel():
    """bf16 running sum rounded per sub-dot: bit-identical to the reference
    kernel's interpret mode when both block K identically."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 512)).astype(np.float32)
    b = (rng.normal(size=(512, 130)) / 512 ** 0.5).astype(np.float32)
    cfg = {"bm": 64, "bn": 128, "bk": 256, "k_unroll": 2, "k_split": 2,
           "order": 0, "acc32": 0, "prefetch": 2}
    want = np.asarray(jops.matmul(jnp.asarray(a, jnp.bfloat16),
                                  jnp.asarray(b, jnp.bfloat16), cfg,
                                  interpret=True), np.float32)
    got = tops.matmul(torch.from_numpy(a).bfloat16(),
                      torch.from_numpy(b).bfloat16(), cfg).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_partials_follow_the_split_k_boundaries():
    """Split s sums K-range [s*kps*bk, (s+1)*kps*bk) of the padded K."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(5, 300)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32))
    cfg = {**tops.DEFAULT_GEMM, "bk": 32, "k_split": 4}
    parts = kmatmul.gemm(a, b, cfg)              # CPU: the plain version
    assert parts.shape == (4, 5, 7)
    kps = -(-300 // (32 * 4))
    for s in range(4):
        lo, hi = s * kps * 32, min((s + 1) * kps * 32, 300)
        torch.testing.assert_close(parts[s], a[:, lo:hi] @ b[lo:hi],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg,bits,why", [
    ({"bm": 128, "bn": 1024, "bk": 128, "k_unroll": 1, "k_split": 1,
      "order": 0, "acc32": 1, "prefetch": 2}, 16, "TPU-only bn"),
    ({"bm": 512, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
      "order": 0, "acc32": 1, "prefetch": 2}, 16, "TPU-only bm"),
    ({"bm": 128, "bn": 128, "bk": 2048, "k_unroll": 1, "k_split": 1,
      "order": 0, "acc32": 1, "prefetch": 2}, 16, "TPU-only bk"),
    ({"bm": 128, "bn": 128, "bk": 256, "k_unroll": 1, "k_split": 1,
      "order": 0, "acc32": 1, "prefetch": 3}, 32, "shared memory"),
    ({"bm": 64, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
      "order": 0, "acc32": 0, "prefetch": 2}, 32, "fp32 needs acc32"),
    ({"bm": 64, "bn": 128, "bk": 32, "k_unroll": 4, "k_split": 1,
      "order": 0, "acc32": 1, "prefetch": 2}, 16, "sub-dot < 16"),
])
def test_hopper_illegal_configs_are_rejected(cfg, bits, why):
    inputs = gemm_input(256, 256, 1024, bits)
    assert not gemm_is_legal(cfg, inputs), why
    a = torch.zeros((8, 64), dtype=torch.float32 if bits == 32
                    else torch.bfloat16)
    with pytest.raises(ValueError):
        kmatmul.gemm(a, a.t().contiguous(), cfg)


def test_default_and_smem_limit_are_legal():
    assert gemm_is_legal(tops.DEFAULT_GEMM, gemm_input(256, 576, 576, 16))
    # a tile larger than the problem is outside X (ops.matmul shrinks it)
    assert not gemm_is_legal(tops.DEFAULT_GEMM, gemm_input(32, 576, 576, 16))
    # above the 48 KB default: legal through the launcher's opt-in
    big = {"bm": 128, "bn": 128, "bk": 256, "k_unroll": 1, "k_split": 1,
           "order": 0, "acc32": 1, "prefetch": 1}
    assert SMEM_DEFAULT < gemm_smem_bytes(big, 16) <= SMEM_PER_BLOCK
    assert gemm_fits(big, 16)
    assert not gemm_fits({**big, "prefetch": 2}, 16)
    assert len(GEMM_SPACE.enumerate_legal(gemm_input(4, 576, 1536, 16))) > 0


def test_shrink_keeps_every_config_launchable():
    rng = np.random.default_rng(0)
    cfgs = list(GEMM_SPACE.enumerate())
    picks = rng.choice(len(cfgs), size=200, replace=False)
    for i in picks:
        cfg = cfgs[i]
        if not gemm_fits(cfg, 16):
            continue
        for M, N, K in [(1, 8, 16), (4, 192, 576), (33, 70, 100)]:
            small = tops.shrink_gemm_cfg(cfg, M, N, K)
            assert gemm_fits(small, 16), (cfg, small)
            assert small["bk"] * small["k_split"] <= max(K, small["bk"])


def test_a_k_cut_to_512_hides_the_drift_of_the_full_reduction():
    """Why the gate keeps K whole on the card: with acc32=0 in bf16 the
    down projection's K=1536 misses the fp32 oracle's 2e-2 (max-abs over
    the oracle's max) where the reference gate's K cap of 512 passes.  The
    plain version rounds where the kernel does."""
    cfg = {"bm": 32, "bn": 64, "bk": 64, "k_unroll": 4, "k_split": 1,
           "order": 0, "acc32": 0, "prefetch": 2}
    errs = []
    for K in (512, 1536):
        rng = np.random.default_rng(0)
        a = torch.as_tensor(rng.normal(size=(32, K)), dtype=torch.float32)
        b = torch.as_tensor(rng.normal(size=(K, 576)) / K ** 0.5,
                            dtype=torch.float32)
        a, b = a.bfloat16(), b.bfloat16()
        got = tops.matmul(a, b, cfg).float()
        want = tref.matmul_ref(a.float(), b.float())
        errs.append(float((got - want).abs().max() / want.abs().max()))
    assert errs[0] <= 2e-2 < errs[1], errs
