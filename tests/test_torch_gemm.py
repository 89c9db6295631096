"""The port's GEMM (plain path on the CPU) against the JAX package's
``ops.matmul`` in Pallas interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.space import (GEMM_MMA_REG_OVERHEAD, GEMM_SPACE,
                                    MAX_REGS_PER_THREAD, SMEM_DEFAULT,
                                    SMEM_PER_BLOCK, gemm_fits, gemm_input,
                                    gemm_is_legal, gemm_regs_per_thread,
                                    gemm_smem_bytes, mma_pitch,
                                    mma_warp_tile)
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
    for bits in (16, 32):
        for cfg in GEMM_SPACE.enumerate():
            if not gemm_fits(cfg, bits):
                continue
            for M, N, K in [(1, 8, 16), (4, 192, 576), (5, 100, 300),
                            (33, 70, 100)]:
                small = tops.shrink_gemm_cfg(cfg, M, N, K, bits)
                assert gemm_fits(small, bits), (cfg, small)
                assert small["bk"] * small["k_split"] <= max(K, small["bk"])
        # the default's two stages of 128 x 128 x 128 tiles exceed a CTA's
        # shared memory in fp32; at a shape that keeps the tiles, one stage
        # fits
        big = tops.shrink_gemm_cfg({}, 512, 512, 512, bits)
        assert gemm_fits(big, bits)
        assert big["prefetch"] == (2 if bits == 16 else 1)


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


# -- transposed operands: what the trans_a / trans_b labels time ---------------

@pytest.mark.parametrize("trans_a,trans_b", [(0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_takes_transposed_views(trans_a, trans_b, dtype):
    """``ops.matmul`` on A stored (K, M) or B stored (N, K), passed as
    ``.t()`` views, equals ``matmul_ref`` on the logical operands."""
    M, N, K = 17, 130, 300
    rng = np.random.default_rng(trans_a + 2 * trans_b)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) / K ** 0.5).astype(np.float32)
    td = getattr(torch, dtype)
    ta, tb = torch.from_numpy(a).to(td), torch.from_numpy(b).to(td)
    va = ta.t().contiguous().t() if trans_a else ta
    vb = tb.t().contiguous().t() if trans_b else tb
    assert va.is_contiguous() == (not trans_a)
    assert vb.is_contiguous() == (not trans_b)
    got = tops.matmul(va, vb, {"k_split": 2})
    want = tref.matmul_ref(ta, tb)
    assert got.shape == (M, N)
    assert _rel(got.float().numpy(), want.float().numpy()) <= TOL[dtype]


@pytest.mark.parametrize("trans_a,trans_b", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_backend_operands_have_the_layout_the_flags_say(trans_a, trans_b):
    from repro_torch.core.backend import CudaEventBackend
    be = CudaEventBackend(device="cpu")
    x = gemm_input(24, 40, 56, 16, trans_a, trans_b)
    (a, b), = be._operand_sets("gemm", x)
    assert a.shape == (24, 56) and b.shape == (56, 40)
    # row-major (K, M) storage seen as (M, K): strides (1, M)
    assert a.stride() == ((1, 24) if trans_a else (56, 1))
    assert b.stride() == ((1, 56) if trans_b else (40, 1))


def test_gated_timed_transposed_sample_goes_through_checked_backend():
    """A ``trans_a=1, trans_b=1`` sample is gated (on the logical product)
    and timed on the CPU through ``CheckedBackend``, its operands stored
    transposed."""
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    be = CheckedBackend(CudaEventBackend(device="cpu"))
    x = gemm_input(48, 80, 96, 16, True, True)
    cfg = {"bm": 32, "bn": 32, "bk": 32, "k_unroll": 1, "k_split": 2,
           "order": 0, "acc32": 1, "prefetch": 2}
    assert be.measure("gemm", cfg, x) > 0
    assert be.time_us("gemm", cfg, x) > 0
    (a, b), = be.timer._operand_sets("gemm", x)
    assert not a.is_contiguous() and not b.is_contiguous()


@pytest.mark.parametrize("block_subs", [1, 3])
def test_plain_acc32_0_forms_its_sub_dots_in_blocks(monkeypatch, block_subs):
    """The plain version's rounded sub-dots, formed a bounded block at a
    time, give the very bits they gave all at once."""
    rng = np.random.default_rng(4)
    M, N, K = 24, 40, 448
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    cfg = {**tops.DEFAULT_GEMM, "bk": 64, "k_unroll": 2, "k_split": 2,
           "acc32": 0}
    whole = kmatmul.matmul_plain(a, b, cfg)
    monkeypatch.setattr(kmatmul, "PLAIN_BLOCK_BYTES",
                        block_subs * 4 * cfg["k_split"] * M * N)
    assert torch.equal(kmatmul.matmul_plain(a, b, cfg), whole)


# -- the mma.sync body's space helpers -----------------------------------------

def test_mma_pitch_pads_to_an_odd_count_of_16_byte_units():
    """A bf16 stage row's pitch: bk in 32..256 and bn in 32..128 are even
    counts of 16-byte units, so each gets 8 elements more."""
    for n, want in ((16, 24), (24, 24), (32, 40), (64, 72), (128, 136),
                    (256, 264)):
        assert mma_pitch(n) == want
        assert (mma_pitch(n) // 8) % 2 == 1


@pytest.mark.parametrize("bm,bn,tile,warps", [
    (16, 32, (16, 32), 1), (16, 64, (16, 32), 2), (16, 128, (16, 64), 2),
    (32, 32, (32, 32), 1), (64, 128, (32, 64), 4), (128, 32, (32, 32), 4),
    (128, 128, (32, 64), 8)])
def test_mma_warp_tile(bm, bn, tile, warps):
    """A warp owns min(bm, 32) x (bn, or bn/2 from 64 up) outputs: 1 warp
    at 16 x 32, 8 at 128 x 128 (``MmaTile`` in ``csrc/mma.cuh``)."""
    assert mma_warp_tile(bm, bn) == tile
    assert bm // tile[0] * (bn // tile[1]) == warps


def test_gemm_smem_counts_the_padded_bf16_pitch():
    cfg = {"bm": 128, "bn": 128, "bk": 64, "k_unroll": 1, "k_split": 1,
           "order": 0, "acc32": 1, "prefetch": 3}
    assert gemm_smem_bytes(cfg, 16) == 3 * (128 * 72 + 64 * 136) * 2
    assert gemm_smem_bytes(cfg, 32) == 3 * (128 * 64 + 64 * 128) * 4


def test_gemm_register_estimate_counts_the_warp_fragments():
    """bf16: the warp block's fp32 fragments (doubled, plus 4 rounding
    temporaries, with acc32=0), the A fragments of one k-step and a B pair,
    plus the fitted overhead; at 128 x 128 the count the ptxas -v report
    gives for sm_90a (bf16 156, 224 with acc32=0; fp32 128)."""
    big = {"bm": 128, "bn": 128, "bk": 64, "k_unroll": 1, "k_split": 1,
           "order": 0, "acc32": 1, "prefetch": 2}
    assert gemm_regs_per_thread(big, 16) == 32 * 64 // 32 + 8 + 4 \
        + GEMM_MMA_REG_OVERHEAD == 156
    assert gemm_regs_per_thread({**big, "acc32": 0}, 16) == 224
    assert gemm_regs_per_thread(big, 32) == 128
    small = {**big, "bm": 16, "bn": 32}
    assert gemm_regs_per_thread(small, 16) == 16 + 4 + 4 \
        + GEMM_MMA_REG_OVERHEAD


def _refusals(cfg, bits):
    """Why the kernel cannot launch ``cfg`` at IO width ``bits``."""
    why = []
    if gemm_smem_bytes(cfg, bits) > SMEM_PER_BLOCK:
        why.append("shared memory")
    if gemm_regs_per_thread(cfg, bits) > MAX_REGS_PER_THREAD:
        why.append("registers")
    if cfg["bk"] % (cfg["k_unroll"] * 16):
        why.append("sub-dot not whole k16 steps")
    if bits == 32 and not cfg["acc32"]:
        why.append("fp32 needs acc32")
    return why


@pytest.mark.parametrize("bits", [16, 32])
def test_every_config_fits_or_is_refused_for_a_stated_reason(bits):
    counts = {}
    for cfg in GEMM_SPACE.enumerate():
        why = _refusals(cfg, bits)
        assert gemm_fits(cfg, bits) == (not why), (cfg, why)
        for w in why or ["fits"]:
            counts[w] = counts.get(w, 0) + 1
    # the padded bf16 rows refuse a few more configs than unpadded ones
    # would; no config is refused for registers
    assert counts["fits"] > 0 and "registers" not in counts, counts


# -- the split-K reduction -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_split", [2, 8])
def test_split_k_reduction_matches_jax(k_split, dtype):
    """``ops.matmul`` with its plain split-K reduction (the CPU's path)
    against the JAX ``ops.matmul`` in interpret mode, both splitting K=2048
    at the same boundaries (bk=128), on the same numpy inputs."""
    M, N, K = 24, 128, 2048
    rng = np.random.default_rng(k_split)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) / K ** 0.5).astype(np.float32)
    cfg = {"bm": 32, "bn": 128, "bk": 128, "k_unroll": 1,
           "k_split": k_split, "order": 0, "acc32": 1, "prefetch": 2}
    assert tops.shrink_gemm_cfg(cfg, M, N, K)["k_split"] == k_split
    want = np.asarray(jops.matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                                  cfg, interpret=True), np.float32)
    td = getattr(torch, dtype)
    got = tops.matmul(torch.from_numpy(a).to(td), torch.from_numpy(b).to(td),
                      cfg)
    assert got.dtype == td
    assert _rel(got.float().numpy(), want) < TOL[dtype]


def test_splitk_reduce_on_the_cpu_is_its_plain_version():
    rng = np.random.default_rng(5)
    parts = torch.from_numpy(rng.normal(size=(8, 5, 7)).astype(np.float32))
    before = kmatmul.reduce_launches
    for dtype in (torch.float32, torch.bfloat16):
        p = parts.to(dtype)
        got = kmatmul.splitk_reduce(p)
        assert got.dtype == dtype and got.shape == (5, 7)
        assert torch.equal(got, kmatmul.splitk_reduce_plain(p))
        # the fp32 sum in split order, rounded once
        want = p[0].float()
        for s in range(1, 8):
            want = want + p[s].float()
        torch.testing.assert_close(got.float(), want.to(dtype).float(),
                                   rtol=1e-6 if dtype == torch.float32
                                   else 2 ** -8, atol=0)
    assert kmatmul.reduce_launches == before    # no kernel on the CPU
    with pytest.raises(ValueError):
        kmatmul.splitk_reduce(parts[0])
    with pytest.raises(ValueError):
        kmatmul.splitk_reduce(parts.to(torch.float16))
