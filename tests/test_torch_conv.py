"""The port's convolution (plain path on the CPU) against the JAX package's
``ops.conv2d`` in Pallas interpret mode and ``ref.conv2d_ref``, on the same
numpy inputs; the Hopper conv space, the shrink rules, the correctness
gate, and ``dispatch.conv2d``'s tiers.

Tolerances: max-abs error over the oracle's max, 2e-3 in fp32 (as
tests/test_kernels.py) and 2e-2 in bf16.  With ``acc32=0`` in bf16 the
running sum is rounded after every (r, s) window's sub-dot, which is what
the config asks for; over 50 windows that drifts from the fp32 oracle by
more than a bf16 tolerance (2.1e-2 at 5x10 here), so the parity cases hold
them to the JAX kernel, which rounds at the same places.  The correctness
gate holds every config to the oracle, as the reference's gate does, and
rejects such a config where it drifts (same verdicts as the reference's).
"""

import contextlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.heuristics import VENDOR_CONV_MENU, VendorHeuristicLibrary
from repro_torch.core.space import (CONV_SPACE, SMEM_PER_BLOCK,
                                    ConfigRejected, conv_fits, conv_input, conv_is_legal,
                                    conv_regs_per_thread, conv_smem_bytes)
from repro_torch.kernels import conv as kconv
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.tunedb import store as tstore

TOL = {"float32": 2e-3, "bfloat16": 2e-2}

# (N, H, W, C, K, R, S): odd and even filters, C=1, C not a multiple of
# b_c, K=87 (Speaker ID's ragged output channels)
SHAPES = {
    "3x3": (2, 8, 8, 16, 32, 3, 3),
    "5x5,C=12": (1, 6, 9, 12, 20, 5, 5),
    "5x10": (1, 5, 24, 8, 16, 5, 10),
    "5x20": (1, 4, 40, 4, 8, 5, 20),
    "C=1": (2, 6, 7, 1, 16, 3, 3),
    "K=87": (1, 5, 6, 12, 87, 3, 3),
}

CFG_PLAIN = {"b_npq": 32, "b_k": 32, "b_c": 8, "rs_unroll": 1, "c_split": 1,
             "order": 0, "acc32": 1, "prefetch": 2}
CFG_SPLIT = {"b_npq": 64, "b_k": 16, "b_c": 8, "rs_unroll": 2, "c_split": 2,
             "order": 1, "acc32": 1, "prefetch": 3}
CFG_ROUND = {"b_npq": 16, "b_k": 32, "b_c": 8, "rs_unroll": 4, "c_split": 1,
             "order": 0, "acc32": 0, "prefetch": 2}
CFG_ROUND_SPLIT = {"b_npq": 32, "b_k": 64, "b_c": 8, "rs_unroll": 1,
                   "c_split": 2, "order": 0, "acc32": 0, "prefetch": 1}

CASES = [("3x3", CFG_PLAIN, "float32"), ("3x3", CFG_SPLIT, "bfloat16"),
         ("3x3", CFG_ROUND_SPLIT, "bfloat16"),
         ("5x5,C=12", CFG_SPLIT, "float32"), ("5x5,C=12", CFG_ROUND, "bfloat16"),
         ("5x10", CFG_PLAIN, "bfloat16"), ("5x10", CFG_ROUND, "bfloat16"),
         ("5x20", CFG_SPLIT, "float32"), ("5x20", CFG_ROUND, "bfloat16"),
         ("C=1", CFG_PLAIN, "float32"), ("C=1", CFG_ROUND, "bfloat16"),
         ("K=87", CFG_SPLIT, "bfloat16"), ("K=87", CFG_PLAIN, "float32")]


def _inputs(shape, seed=0):
    N, H, W, C, K, R, S = shape
    rng = np.random.default_rng(seed + N * H * W + C * K + R * S)
    i = rng.normal(size=(N, H, W, C)).astype(np.float32)
    f = (rng.normal(size=(R, S, C, K)) / (R * S * C) ** 0.5).astype(np.float32)
    return i, f


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("name,cfg,dtype", CASES)
def test_conv_matches_jax_interpret_and_oracle(name, cfg, dtype):
    shape = SHAPES[name]
    i, f = _inputs(shape)
    want = np.asarray(jops.conv2d(jnp.asarray(i, dtype), jnp.asarray(f, dtype),
                                  cfg, interpret=True), np.float32)
    oracle = np.asarray(jref.conv2d_ref(jnp.asarray(i, dtype),
                                        jnp.asarray(f, dtype)), np.float32)
    td = getattr(torch, dtype)
    got = tops.conv2d(torch.from_numpy(i).to(td), torch.from_numpy(f).to(td),
                      cfg)
    assert got.dtype == td and tuple(got.shape) == shape[:3] + (shape[4],)
    got = got.float().numpy()
    assert _rel(got, want) <= TOL[dtype]
    if cfg["acc32"]:
        assert _rel(got, oracle) <= TOL[dtype]


@pytest.mark.parametrize("name", ["3x3", "5x10", "C=1"])
def test_conv2d_ref_matches_jax_same_padding(name):
    """The port's oracle pads like XLA's SAME, even filters included."""
    i, f = _inputs(SHAPES[name], seed=1)
    want = np.asarray(jref.conv2d_ref(jnp.asarray(i), jnp.asarray(f)))
    got = tref.conv2d_ref(torch.from_numpy(i), torch.from_numpy(f)).numpy()
    assert _rel(got, want) <= 1e-5


def test_acc32_0_rounds_like_the_tpu_kernel():
    """bf16 with acc32=0: the running sum rounds after every (r, s)
    window's sub-dot over a b_c slab, as ``acc + jnp.dot(..., bf16)`` does
    in the Pallas kernel, so the plain version is bit-identical to it when
    both walk the same slabs (b_c >= 32, C a multiple of b_c)."""
    cfg = {"b_npq": 32, "b_k": 32, "b_c": 32, "rs_unroll": 1, "c_split": 1,
           "order": 0, "acc32": 0, "prefetch": 2}
    shape = (1, 6, 6, 64, 16, 3, 3)
    i, f = _inputs(shape, seed=2)
    want = np.asarray(jops.conv2d(jnp.asarray(i, jnp.bfloat16),
                                  jnp.asarray(f, jnp.bfloat16), cfg,
                                  interpret=True), np.float32)
    got = tops.conv2d(torch.from_numpy(i).bfloat16(),
                      torch.from_numpy(f).bfloat16(), cfg).float().numpy()
    np.testing.assert_array_equal(got, want)
    # and the fp32 running sum differs: the rounding is real
    acc32 = tops.conv2d(torch.from_numpy(i).bfloat16(),
                        torch.from_numpy(f).bfloat16(),
                        {**cfg, "acc32": 1}).float().numpy()
    assert not np.array_equal(acc32, got)


def test_split_partials_follow_the_reference_channel_boundaries():
    """Split s reduces channels [s*cps*b_c, (s+1)*cps*b_c) of C padded to
    b_c*c_split, and each partial is rounded to the IO dtype."""
    N, H, W, C, K, R, S = 1, 4, 5, 20, 8, 3, 3
    i, f = _inputs((N, H, W, C, K, R, S), seed=3)
    ti, tf = torch.from_numpy(i).bfloat16(), torch.from_numpy(f).bfloat16()
    cfg = tops.shrink_conv_cfg(CFG_SPLIT, N, H, W, C, K, R, S)
    assert (cfg["b_c"], cfg["c_split"]) == (8, 2)
    parts = kconv.conv(ti, tf, cfg)
    assert parts.shape == (2, N, H, W, K) and parts.dtype == torch.bfloat16
    # C=20 pads to 32: split 0 sums channels 0-15, split 1 channels 16-19
    for s, (c0, c1) in enumerate(((0, 16), (16, 20))):
        want = tref.conv2d_ref(ti[..., c0:c1].float(), tf[:, :, c0:c1].float())
        assert _rel(parts[s].float().numpy(), want.numpy()) <= 1e-2


# -- the Hopper conv space ----------------------------------------------------

def test_conv_space_legality_follows_smem_and_registers():
    big = {"b_npq": 128, "b_k": 128, "b_c": 64, "rs_unroll": 4, "c_split": 1,
           "order": 0, "acc32": 1, "prefetch": 3}
    assert conv_smem_bytes(big, 16) == 3 * 4 * (128 * 64 + 64 * 128) * 2 \
        + 12 * 128
    assert conv_smem_bytes(big, 16) > SMEM_PER_BLOCK
    assert not conv_fits(big, 16)
    fits = {**big, "rs_unroll": 1, "prefetch": 2}
    assert conv_smem_bytes(fits, 32) <= SMEM_PER_BLOCK and conv_fits(fits, 32)
    assert conv_regs_per_thread({**fits, "acc32": 0}) == 128 + 16 + 48
    # fp32 IO needs the fp32 accumulator
    assert not conv_fits({**fits, "acc32": 0}, 32)
    # every config the space calls launchable obeys both limits
    for cfg in CONV_SPACE.enumerate():
        for bits in (16, 32):
            if conv_fits(cfg, bits):
                assert conv_smem_bytes(cfg, bits) <= SMEM_PER_BLOCK
                assert conv_regs_per_thread(cfg) <= 255


def test_conv_space_rejects_tiles_larger_than_the_problem():
    inputs = conv_input(1, 4, 4, 8, 16, 3, 3)          # npq = 16
    ok = {"b_npq": 16, "b_k": 16, "b_c": 8, "rs_unroll": 1, "c_split": 1,
          "order": 0, "acc32": 1, "prefetch": 2}
    assert conv_is_legal(ok, inputs)
    assert not conv_is_legal({**ok, "b_npq": 32}, inputs)
    assert not conv_is_legal({**ok, "b_k": 32}, inputs)
    assert not conv_is_legal({**ok, "b_c": 16}, inputs)
    assert not conv_is_legal({**ok, "c_split": 2}, inputs)
    assert not conv_is_legal({**ok, "rs_unroll": 4},
                             conv_input(1, 4, 4, 8, 16, 1, 3))
    # a TPU-tuned record: no CTA of this kernel holds b_k=512
    tpu = {"b_npq": 512, "b_k": 512, "b_c": 128, "rs_unroll": 1,
           "c_split": 1, "order": 0, "acc32": 1, "prefetch": 2}
    assert not conv_fits(tpu, 16)


@pytest.mark.parametrize("shape", list(SHAPES.values())
                         + [(16, 79, 341, 1, 32, 5, 20),
                            (16, 7, 7, 1024, 2048, 1, 1)])
def test_shrink_keeps_every_config_launchable(shape):
    N, H, W, C, K, R, S = shape
    rng = np.random.default_rng(C + K)
    cfgs = list(CONV_SPACE.enumerate())
    for j in rng.choice(len(cfgs), 200, replace=False):
        cfg = dict(cfgs[j])
        if not conv_fits(cfg, 16):
            continue
        small = tops.shrink_conv_cfg(cfg, N, H, W, C, K, R, S)
        assert conv_fits(small, 16)
        assert small["b_npq"] <= max(N * H * W, 16)
        assert small["b_k"] <= max(K, 16)
        assert small["b_c"] * small["c_split"] <= max(C, small["b_c"])
        assert small["rs_unroll"] <= max(R * S, 1)


def test_vendor_conv_menu_is_launchable():
    assert all(conv_fits(c, 16) and conv_fits(c, 32) for c in VENDOR_CONV_MENU)
    lib = VendorHeuristicLibrary.conv(CONV_SPACE)
    big = lib.select(conv_input(8, 112, 112, 64, 128, 3, 3))
    small = lib.select(conv_input(16, 7, 7, 832, 128, 5, 5))
    assert big["b_npq"] > small["b_npq"] and big in VENDOR_CONV_MENU


# -- the correctness gate -------------------------------------------------------

def test_check_config_passes_and_catches_a_wrong_kernel(monkeypatch):
    inputs = conv_input(2, 8, 8, 16, 32, 5, 10)
    tdispatch.check_config("conv", CFG_SPLIT, inputs, device="cpu")
    # acc32=0 over the 18 windows of a 3x3 filter stays within the oracle's
    # tolerance (over 5x10's 100 windows it does not: the next test)
    tdispatch.check_config("conv", CFG_ROUND, {**inputs, "R": 3, "S": 3},
                           device="cpu")
    plain = kconv.conv2d_plain

    def five_percent_high(i, f, cfg):
        return plain(i, f, cfg) * 1.05
    monkeypatch.setattr(kconv, "conv", five_percent_high)
    with pytest.raises(AssertionError, match="rel err"):
        tdispatch.check_config("conv", CFG_SPLIT, inputs, device="cpu")


@pytest.mark.parametrize("shape,rejected", [
    ((2, 8, 8, 16, 32, 3, 3), False),
    ((2, 8, 8, 16, 32, 5, 10), True),       # 100 roundings: 2.2e-2 > 2e-2
    ((1, 7, 7, 512, 16, 3, 3), True),       # 576 roundings
])
def test_check_config_holds_acc32_0_to_the_oracle_as_the_reference_does(
        shape, rejected):
    """Tolerance 2e-2 (bf16) against the fp32 oracle for every config: the
    port's gate gives the reference's verdict (Pallas interpret mode) on
    the same seeded operands."""
    inputs = conv_input(*shape)
    with pytest.raises(AssertionError, match="rel err") if rejected else \
            contextlib.nullcontext():
        jdispatch.check_config("conv", CFG_ROUND, inputs)
    with pytest.raises(ConfigRejected, match="fp32 oracle") if rejected else \
            contextlib.nullcontext():
        tdispatch.check_config("conv", CFG_ROUND, inputs, device="cpu")


def test_gate_runs_the_whole_shape_on_the_card_and_a_shrunken_one_here():
    """On the card the gate keeps every dim, the reduction's included (a
    K or C cut to the reference's 512 hides the full reduction's rounding
    drift); on the CPU it runs the reference's instance."""
    x = conv_input(16, 7, 7, 2048, 1024, 1, 1)
    assert tdispatch.gate_instance("conv", x, "cuda") == x
    assert tdispatch.gate_instance("conv", x, "cpu") == conv_input(
        2, 7, 7, 512, 512, 1, 1)
    g = {"M": 32, "N": 576, "K": 1536, "dtype_bits": 16, "trans_a": 0,
         "trans_b": 0}
    assert tdispatch.gate_instance("gemm", g, torch.device("cuda", 0)) == g
    assert tdispatch.gate_instance("gemm", g, "cpu")["K"] == 512
    with pytest.raises(ValueError, match="no ported kernel"):
        tdispatch.gate_instance("fft", g, "cuda")


def test_conv_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(kconv, "conv2d_plain", boom)
    i = torch.empty((1, 4, 4, 8), dtype=torch.bfloat16, device="meta")
    f = torch.empty((3, 3, 8, 16), dtype=torch.bfloat16, device="meta")
    before = kconv.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.conv2d(i, f)
    assert kconv.launches == before


def test_conv_wrapper_rejects_what_the_kernel_does_not_take():
    i = torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16)
    f = torch.zeros((3, 3, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        kconv.conv(i, f.float(), CFG_PLAIN)
    with pytest.raises(ValueError, match="not launchable"):
        kconv.conv(i, f, {**CFG_PLAIN, "b_k": 512})
    with pytest.raises(ValueError, match="wants"):
        kconv.conv(i, f[:, :, :4], CFG_PLAIN)


# -- dispatch.conv2d through the tiers ------------------------------------------

FP = "repro_torch.CudaEventBackend/device=test"
TUNED = (2, 8, 8, 16, 32, 3, 3)
CFG_TPU = {"b_npq": 512, "b_k": 512, "b_c": 128, "rs_unroll": 1, "c_split": 1,
           "order": 0, "acc32": 1, "prefetch": 2}


@pytest.fixture
def conv_store():
    store = tstore.RecordStore()
    store.add(tstore.TuneRecord(space="conv", inputs=conv_input(*TUNED),
                                config=CFG_SPLIT, tflops=1.0, backend=FP))
    tstore.install_store(store, fingerprint=FP)
    tdispatch.reset_counts()
    yield store
    tstore.clear_store()


def _dispatch(shape):
    i, f = _inputs(shape, seed=4)
    ti, tf = torch.from_numpy(i).bfloat16(), torch.from_numpy(f).bfloat16()
    return ti, tf, tdispatch.conv2d(ti, tf)


def test_dispatch_conv_exact_and_nearest(conv_store):
    ti, tf, out = _dispatch(TUNED)
    assert torch.equal(out, tops.conv2d(ti, tf, CFG_SPLIT))
    assert tdispatch.tier_counts[("conv", "exact")] == 1
    near = (2, 8, 12, 16, 32, 3, 3)              # W 8 -> 12: log2 distance < 2
    cfg, tier = tdispatch._resolve_cfg("conv", conv_input(*near))
    assert (cfg, tier) == (CFG_SPLIT, "nearest")
    _, _, out = _dispatch(near)
    assert tuple(out.shape) == (2, 8, 12, 32)


def test_dispatch_conv_degrades_to_the_conv_menu(conv_store):
    """Repair: a conv shape with no record is served from the conv menu,
    never from the GEMM one."""
    far = (16, 38, 166, 32, 32, 5, 10)
    inputs = conv_input(*far)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cfg, tier = tdispatch._resolve_cfg("conv", inputs)
    assert tier == "degraded"
    assert set(cfg) == set(CONV_SPACE.param_names)
    assert cfg == VendorHeuristicLibrary.conv(CONV_SPACE).select(inputs)
    assert cfg in VENDOR_CONV_MENU


def test_dispatch_conv_passes_over_an_unlaunchable_record(conv_store):
    """Repair: a conv record the kernel cannot launch (tuned for the TPU's
    VMEM) never reaches it; the nearest launchable record serves."""
    shape = (2, 8, 10, 16, 32, 3, 3)
    conv_store.add(tstore.TuneRecord(space="conv", inputs=conv_input(*shape),
                                     config=CFG_TPU, tflops=9.0, backend=FP))
    with pytest.warns(RuntimeWarning, match="cannot launch"):
        cfg, tier = tdispatch._resolve_cfg("conv", conv_input(*shape))
    assert (cfg, tier) == (CFG_SPLIT, "nearest")
    ti, tf, out = _dispatch(shape)
    oracle = tref.conv2d_ref(ti, tf)
    assert _rel(out.float().numpy(), oracle.float().numpy()) <= TOL["bfloat16"]
