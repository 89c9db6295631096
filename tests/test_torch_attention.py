"""The port's flash attention (plain path on the CPU) against the JAX
package's ``ops.flash_attention`` in Pallas interpret mode and
``ref.attention_ref``, on the same numpy inputs; the Hopper attention space,
the shrink rules, the correctness gate, ``dispatch.flash_attention``'s
tiers and the decode split count read from the attention space.

Tolerances: max-abs error over the oracle's max, 2e-3 in fp32 (as
tests/test_kernels.py) and 2e-2 in bf16.  The JAX ``ops.flash_attention``
hides a ragged KV length behind a causal offset, which is exact only for
Lq == 1 (ROADMAP C1), so the port is held to it where it is right (causal,
unpadded KV, or one query row) and to the oracle everywhere.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.space import (ATTENTION_SPACE, FITS, SMEM_PER_BLOCK,
                                    ConfigRejected, attention_fits,
                                    attention_head_tile, attention_input,
                                    attention_is_legal,
                                    attention_regs_per_thread,
                                    attention_smem_bytes, attention_warps)
from repro_torch.kernels import _build as kbuild
from repro_torch.kernels import attention as kattention
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serve.flash_decode import resolve_decode_splits
from repro_torch.tunedb import store as tstore

TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _inputs(B, Hq, Hkv, Lq, Lkv, D, seed=0):
    rng = np.random.default_rng(seed + 7 * Lq + Lkv + D)
    q = rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32)
    return q, k, v


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _port(q, k, v, cfg, dtype, **kw):
    td = getattr(torch, dtype)
    out = tops.flash_attention(torch.from_numpy(q).to(td),
                               torch.from_numpy(k).to(td),
                               torch.from_numpy(v).to(td), cfg, **kw)
    assert out.dtype == td and tuple(out.shape) == q.shape
    return out.float().numpy()


def _jax(fn, q, k, v, dtype, *args, **kw):
    return np.asarray(fn(*(jnp.asarray(t, dtype) for t in (q, k, v)), *args,
                         **kw), np.float32)


# (name, (B, Hq, Hkv, Lq, Lkv, D), cfg, causal, q_offset, dtype) where the
# reference's ops.flash_attention is right: causal, unpadded KV, or Lq == 1
JAX_CASES = [
    ("causal", (2, 4, 2, 48, 48, 32), {"b_q": 16, "b_kv": 16}, True, 0,
     "float32"),
    ("causal,ragged", (1, 4, 2, 40, 40, 32), {"b_q": 32, "b_kv": 32}, True, 0,
     "bfloat16"),
    ("unpadded", (1, 2, 1, 24, 64, 16), {"b_q": 16, "b_kv": 32}, False, 0,
     "float32"),
    ("decode", (2, 6, 2, 1, 70, 32), {"b_q": 16, "b_kv": 32}, True, 69,
     "bfloat16"),
    ("decode,non-causal", (1, 4, 1, 1, 70, 16), {"b_q": 16, "b_kv": 64},
     False, 0, "float32"),
    ("gqa3", (1, 6, 2, 24, 24, 16), {"b_q": 16, "b_kv": 16}, True, 0,
     "float32"),
    ("gqa5", (1, 5, 1, 32, 32, 16), {"b_q": 32, "b_kv": 16}, True, 0,
     "bfloat16"),
    # packed rows: 5*20 = 100 rows of a KV head in CTAs of 32 straddle heads
    ("packed,straddle", (1, 10, 2, 20, 20, 16), {"b_q": 32, "b_kv": 16}, True,
     0, "float32"),
    ("decode,gqa5,ragged", (2, 10, 2, 1, 100, 32), {"b_q": 16, "b_kv": 32},
     True, 99, "bfloat16"),
    ("decode,gqa8", (1, 8, 1, 1, 64, 16), {"b_q": 16, "b_kv": 16}, True, 63,
     "bfloat16"),
]


@pytest.mark.parametrize("name,shape,cfg,causal,off,dtype", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_flash_attention_matches_jax_kernel_where_it_is_right(
        name, shape, cfg, causal, off, dtype):
    q, k, v = _inputs(*shape)
    full = {"acc32": 1, "prefetch": 2, **cfg}
    got = _port(q, k, v, full, dtype, causal=causal, q_offset=off)
    want = _jax(jops.flash_attention, q, k, v, dtype, full, causal=causal,
                q_offset=off, interpret=True)
    oracle = _jax(jref.attention_ref, q, k, v, dtype, causal=causal,
                  q_offset=off)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(got, oracle) <= TOL[dtype]


# the three shapes ROADMAP C1 measured the reference's offset trick at
C1_SHAPES = [(4, 100, 64), (8, 200, 128), (130, 100, 64)]


@pytest.mark.parametrize("Lq,Lkv,b_kv", C1_SHAPES)
def test_c1_padded_kv_is_masked_by_length(Lq, Lkv, b_kv):
    """Non-causal with a KV length that is not a multiple of ``b_kv``: the
    port matches the oracle at 2e-3 in fp32; the reference's offset trick
    (causal with offset Lkv - Lq) misses it at these shapes."""
    q, k, v = _inputs(1, 4, 2, Lq, Lkv, 32, seed=1)
    cfg = {"b_q": 128, "b_kv": b_kv, "acc32": 1, "prefetch": 2}
    got = _port(q, k, v, cfg, "float32", causal=False)
    oracle = _jax(jref.attention_ref, q, k, v, jnp.float32, causal=False)
    assert _rel(got, oracle) <= TOL["float32"]
    jax_ops = _jax(jops.flash_attention, q, k, v, jnp.float32, cfg,
                   causal=False, interpret=True)
    assert _rel(jax_ops, oracle) > 10 * TOL["float32"]


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 5), (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax(causal, off, dtype):
    q, k, v = _inputs(2, 6, 3, 20, 25, 16, seed=2)
    td = getattr(torch, dtype)
    got = tref.attention_ref(*(torch.from_numpy(t).to(td) for t in (q, k, v)),
                             causal=causal, q_offset=off).float().numpy()
    want = _jax(jref.attention_ref, q, k, v, dtype, causal=causal,
                q_offset=off)
    assert _rel(got, want) <= (1e-5 if dtype == "float32" else 1e-2)


def test_p_is_rounded_to_the_io_dtype_before_p_v():
    """bf16: p is cast before the P.V product, as the TPU kernel casts it,
    so the plain version differs from a walk that keeps p in fp32."""
    q, k, v = _inputs(1, 2, 1, 16, 64, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    cfg = {"b_q": 16, "b_kv": 16, "acc32": 1, "prefetch": 2}
    got = kattention.attention_plain(tq, tk, tv, cfg, causal=False)
    # the same walk, p in fp32
    s = torch.einsum("bhqd,bhkd->bhqk", tq.float(), tk.float()) / 4.0
    exact = (torch.softmax(s, -1) @ tv.float()).bfloat16()
    assert not torch.equal(got, exact)
    assert _rel(got.float().numpy(), exact.float().numpy()) <= TOL["bfloat16"]


def test_acc32_does_not_change_the_arithmetic():
    """The TPU kernel keeps m, l and acc in fp32 whatever acc32 says; so
    does the port (it must not round on acc32=0)."""
    q, k, v = _inputs(1, 2, 2, 20, 40, 16, seed=4)
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    base = {"b_q": 16, "b_kv": 16, "prefetch": 2}
    assert torch.equal(tops.flash_attention(*t, {**base, "acc32": 0}),
                       tops.flash_attention(*t, {**base, "acc32": 1}))


# -- the Hopper attention space -------------------------------------------------

def test_attention_space_legality_follows_smem_and_registers():
    cfg = {"b_q": 64, "b_kv": 64, "acc32": 1, "prefetch": 2}
    # bf16: the Q tile and the K/V ring, rows of the head tile plus 16 bytes;
    # P and the accumulator live in registers
    row = (128 + 8) * 2
    assert attention_smem_bytes(cfg, 16, 128) == 64 * row + 2 * 2 * 64 * row
    assert attention_smem_bytes(cfg, 16, 96) == attention_smem_bytes(cfg, 16,
                                                                      128)
    # fp32: the CUDA-core body's P tile and shared accumulator as well
    row32 = 128 * 4 + 16
    assert attention_smem_bytes(cfg, 32, 128) == (64 + 2 * 2 * 64) * row32 \
        + 64 * 68 * 4 + 64 * (128 + 16) * 4
    big = {"b_q": 128, "b_kv": 128, "acc32": 1, "prefetch": 3}
    assert attention_smem_bytes(big, 16, 256) > SMEM_PER_BLOCK
    assert not attention_fits(big, 16, 256) and attention_fits(big, 16, 32)
    # the kernel reads rows in 16-byte pieces: D a multiple of 8
    assert attention_fits(cfg, 16, 64) and not attention_fits(cfg, 16, 60)
    assert not attention_fits({**cfg, "acc32": 0}, 32, 64)
    for c in ATTENTION_SPACE.enumerate():
        for bits, D in ((16, 64), (16, 128), (32, 128), (16, 256)):
            if attention_fits(c, bits, D):
                assert attention_smem_bytes(c, bits, D) <= SMEM_PER_BLOCK
                assert attention_regs_per_thread(c, bits, D) <= 255
    assert FITS["attention"](cfg, attention_input(1, 4, 4, 8, 8, 128))
    assert not FITS["attention"](big, attention_input(1, 4, 4, 8, 8, 256))


def test_bf16_head_dims_pad_to_a_tile_of_at_most_256():
    assert [attention_head_tile(D) for D in (8, 24, 64, 72, 128, 136, 256)] \
        == [64, 64, 64, 128, 128, 256, 256]
    cfg = {"b_q": 16, "b_kv": 16, "acc32": 1, "prefetch": 1}
    assert attention_fits(cfg, 16, 256) and not attention_fits(cfg, 16, 264)
    assert attention_fits(cfg, 32, 264)      # the fp32 body takes any D
    with pytest.raises(ValueError, match="D <= 256"):
        attention_head_tile(264)


@pytest.mark.parametrize("b_q,b_kv,tiles,split", [
    (16, 16, 1, 1), (16, 32, 1, 2), (16, 64, 1, 4), (16, 128, 1, 4),
    (32, 16, 2, 1), (32, 32, 2, 2), (32, 128, 2, 2), (64, 64, 4, 1),
    (128, 16, 8, 1)])
def test_bf16_warps_split_kv_columns_only_where_rows_are_few(b_q, b_kv, tiles,
                                                             split):
    """One warp per 16 packed rows; a CTA of fewer than 4 row tiles gives
    each up to 4 / tiles warps, each on a slice of >= 16 KV columns."""
    cfg = {"b_q": b_q, "b_kv": b_kv, "acc32": 1, "prefetch": 2}
    assert attention_warps(cfg) == (tiles, split)
    assert b_kv // split >= 16 and tiles * split <= max(4, tiles)


def test_bf16_merge_of_split_warps_fits_the_ring_or_the_smem_grows():
    """A split CTA merges through the freed K/V ring; where one stage of
    narrow blocks is smaller than the merge, the smem grows to hold it."""
    split = {"b_q": 32, "b_kv": 32, "acc32": 1, "prefetch": 1}
    row = (128 + 8) * 2
    merge = 2 * 2 * 16 * (128 + 4 + 2) * 4
    assert merge > 2 * 32 * row
    assert attention_smem_bytes(split, 16, 128) == 32 * row + merge
    decode = {"b_q": 16, "b_kv": 128, "acc32": 1, "prefetch": 2}
    assert attention_smem_bytes(decode, 16, 128) == 16 * row + 2 * 2 * 128 * row


def test_bf16_configs_that_spill_are_not_launchable():
    """The ptxas -v report of attention.cu: at head tile 256 a single warp
    on 128 columns spills (255 registers); the register estimate keeps
    exactly those out of the space."""
    for b_q in (64, 128):
        cfg = {"b_q": b_q, "b_kv": 128, "acc32": 1, "prefetch": 1}
        assert attention_regs_per_thread(cfg, 16, 256) > 255
        assert not attention_fits(cfg, 16, 256) and attention_fits(cfg, 16, 128)
    assert attention_fits({"b_q": 128, "b_kv": 64, "acc32": 1, "prefetch": 1},
                          16, 256)
    assert attention_fits({"b_q": 32, "b_kv": 128, "acc32": 1, "prefetch": 1},
                          16, 256)


def test_head_dims_not_a_multiple_of_8_are_rejected():
    """The kernel reads q, k and v rows in 16-byte pieces: no config fits
    such a D, and the wrapper raises on any device."""
    assert not any(attention_fits(c, 16, 60)
                   for c in ATTENTION_SPACE.enumerate())
    q = torch.zeros((1, 2, 3, 60))
    kv = torch.zeros((1, 1, 5, 60))
    with pytest.raises(ValueError, match="multiple of 8"):
        tops.flash_attention(q, kv, kv, causal=False)


def test_tpu_sized_attention_configs_fail_fits():
    """A record tuned for the TPU's VMEM never reaches the kernel."""
    for tpu in ({"b_q": 128, "b_kv": 2048, "acc32": 1, "prefetch": 2},
                {"b_q": 512, "b_kv": 128, "acc32": 1, "prefetch": 2},
                {"b_q": 1024, "b_kv": 1024, "acc32": 0, "prefetch": 3}):
        assert not attention_fits(tpu, 16, 64)
        assert not FITS["attention"](tpu, attention_input(4, 9, 3, 1, 256, 64))


def test_attention_space_sizes_tiles_to_the_problem():
    decode = attention_input(4, 9, 3, 1, 256, 64)
    ok = {"b_q": 16, "b_kv": 64, "acc32": 1, "prefetch": 2}
    assert attention_is_legal(ok, decode)
    assert not attention_is_legal({**ok, "b_q": 32}, decode)
    assert not attention_is_legal({**ok, "b_kv": 128},
                                  attention_input(1, 4, 4, 1, 40, 64))
    assert attention_is_legal({**ok, "b_kv": 128},
                              attention_input(1, 4, 4, 1, 113, 64))


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115attn_mma_kernelILi64ELi128ELi256EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiifiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115attn_mma_kernelILi64ELi128ELi256EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiifiii
    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116attn_simt_kernelILi16ELi16EEEvPKfS2_S2_Pfiiiiifiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116attn_simt_kernelILi16ELi16EEEvPKfS2_S2_Pfiiiiifiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, 412 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_and_spills(tmp_path, monkeypatch):
    """The build keeps ptxas -v's report beside each library; the card
    run reads every attention kernel's registers and spills from it."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    kbuild.library_path("attention").with_suffix(".log").write_text(PTXAS_LOG)
    usage = kbuild.ptxas_usage("attention")
    assert sorted(usage.values()) == [(60, 0), (255, 24)]
    mma = next(k for k in usage if "attn_mma_kernelILi64ELi128ELi256E" in k)
    assert usage[mma] == (255, 24)


@pytest.mark.parametrize("Hq,Hkv,Lq,max_bq", [
    (40, 8, 1, 16),         # qwen3-14b decode: 5 packed rows take b_q=16
    (32, 4, 1, 16),         # group 8
    (64, 2, 1, 32),         # group 32: two row tiles of one decode step
    (10, 2, 100, 128),      # 500 packed rows straddle heads every 100
    (9, 3, 2048, 128),
])
def test_b_q_is_bounded_by_the_packed_rows(Hq, Hkv, Lq, max_bq):
    """b_q counts packed rows, group*Lq of them per (b, KV head): the bound
    is round16(group*Lq), not round16(Lq)."""
    x = attention_input(2, Hq, Hkv, Lq, 1000, 128)
    legal = [b for b in (16, 32, 64, 128) if attention_is_legal(
        {"b_q": b, "b_kv": 64, "acc32": 1, "prefetch": 2}, x)]
    assert legal[-1] == max_bq and legal == [16, 32, 64, 128][:len(legal)]


@pytest.mark.parametrize("Lq,Lkv,D,bits", [(1, 256, 64, 16), (4096, 4096, 128, 16),
                                           (7, 20, 256, 32), (130, 100, 24, 32)])
def test_shrink_keeps_every_config_launchable(Lq, Lkv, D, bits):
    for cfg in ATTENTION_SPACE.enumerate():
        if bits == 32 and not cfg["acc32"]:
            continue
        small = tops.shrink_attention_cfg(cfg, Lq, Lkv, D, bits, group=1)
        assert attention_fits(small, bits, D), (cfg, small)
        r16 = lambda n: -(-n // 16) * 16
        assert small["b_q"] <= r16(Lq) and small["b_kv"] <= r16(Lkv)
        if attention_is_legal(cfg, attention_input(1, 1, 1, Lq, Lkv, D, bits)):
            assert small == cfg             # a legal config runs as it is


# (B, Hq, Hkv, Lq, Lkv, D, causal): the four tune targets, the card checks'
# shapes (smoke and tests/test_torch_cuda.py) and the packed ones
SHRINK_SHAPES = [
    (4, 9, 3, 1, 256, 64, 1), (1, 9, 3, 2048, 2048, 64, 1),
    (1, 40, 8, 4096, 4096, 128, 1), (8, 40, 8, 1, 32768, 128, 1),
    (1, 40, 8, 1024, 1024, 128, 1), (1, 4, 2, 4, 100, 64, 0),
    (1, 4, 2, 8, 200, 64, 0), (1, 4, 2, 130, 100, 64, 0),
    (1, 6, 2, 300, 300, 64, 1), (2, 10, 2, 40, 77, 128, 0),
    (1, 4, 4, 4, 100, 64, 0), (2, 3, 1, 33, 50, 24, 1),
    (1, 10, 2, 100, 100, 64, 1), (2, 40, 8, 1, 1000, 128, 1),
    (1, 32, 4, 1, 4096, 128, 1),
]


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("shape", SHRINK_SHAPES,
                         ids=["x".join(map(str, s[:6])) for s in SHRINK_SHAPES])
def test_shrink_gives_a_legal_config_at_every_target_and_check(shape, bits):
    B, Hq, Hkv, Lq, Lkv, D, causal = shape
    x = attention_input(B, Hq, Hkv, Lq, Lkv, D, bits, causal)
    for cfg in ATTENTION_SPACE.enumerate():
        if bits == 32 and not cfg["acc32"]:
            continue
        small = tops.shrink_attention_cfg(cfg, Lq, Lkv, D, bits,
                                          group=Hq // Hkv)
        assert attention_is_legal(small, x), (cfg, small)
        if attention_is_legal(cfg, x):
            assert small == cfg


# -- the correctness gate -------------------------------------------------------

CFG = {"b_q": 16, "b_kv": 32, "acc32": 1, "prefetch": 2}


@pytest.mark.parametrize("shape,causal", [
    ((2, 4, 2, 1, 96, 32), 1),              # decode: causal, Lq < Lkv
    ((1, 4, 4, 48, 48, 32), 1),             # causal prefill
    ((2, 8, 2, 32, 64, 16), 0),             # unpadded, non-causal
])
def test_gate_gives_the_reference_verdict(shape, causal):
    inputs = attention_input(*shape, dtype_bits=16, causal=causal)
    jdispatch.check_config("attention", CFG, inputs)     # passes
    tdispatch.check_config("attention", CFG, inputs, device="cpu")


def test_gate_passes_the_shapes_the_reference_offset_trick_fails():
    """The reference's gate rejects a correct config at a C1 shape (its
    ops layer computes the wrong thing there); the port's gate accepts it,
    and still catches a kernel 5% off."""
    inputs = attention_input(1, 4, 2, 130, 100, 32, dtype_bits=32, causal=0)
    cfg = {"b_q": 128, "b_kv": 64, "acc32": 1, "prefetch": 2}
    with pytest.raises(AssertionError, match="rel err"):
        jdispatch.check_config("attention", cfg, inputs)
    tdispatch.check_config("attention", cfg, inputs, device="cpu")


def test_gate_catches_a_wrong_kernel(monkeypatch):
    inputs = attention_input(1, 4, 2, 40, 40, 32)
    plain = kattention.attention_plain
    monkeypatch.setattr(kattention, "attention",
                        lambda *a, **k: plain(*a, **k) * 1.05)
    with pytest.raises(ConfigRejected, match="rel err"):
        tdispatch.check_config("attention", CFG, inputs, device="cpu")


def test_gate_instance_is_the_reference_shrunken_one():
    x = attention_input(8, 40, 8, 4096, 4096, 128)
    assert tdispatch.gate_instance("attention", x, "cuda") == x
    small = tdispatch.gate_instance("attention", x, "cpu")
    assert small == attention_input(2, 4, 4, 512, 512, 128)
    assert tdispatch.check_instance(
        "attention", attention_input(4, 9, 3, 1, 256, 64))["Hkv"] == 2
    assert tdispatch.gate_causal(attention_input(1, 2, 2, 1, 9, 8)) is False
    assert tdispatch.gate_causal(attention_input(1, 2, 2, 9, 9, 8))


def test_gate_oracle_in_blocks_equals_attention_ref(monkeypatch):
    """The gate's oracle walks KV heads and row blocks to bound memory; it
    gives attention_ref's numbers (here with blocks of a few rows)."""
    q, k, v = (torch.from_numpy(t) for t in _inputs(2, 6, 2, 37, 37, 16))
    monkeypatch.setattr(tdispatch, "ORACLE_SCORE_BYTES", 4 * 2 * 3 * 37 * 5)
    got = tdispatch._attention_oracle(q, k, v, True)
    assert torch.allclose(got, tref.attention_ref(q, k, v, causal=True),
                          atol=1e-6)


# -- dispatch.flash_attention through the tiers ---------------------------------

FP = "repro_torch.CudaEventBackend/device=test"
DECODE = attention_input(4, 9, 3, 1, 256, 64)
CFG_DECODE = {"b_q": 16, "b_kv": 64, "acc32": 1, "prefetch": 3}
CFG_TPU = {"b_q": 128, "b_kv": 2048, "acc32": 1, "prefetch": 2}


@pytest.fixture
def attn_store():
    store = tstore.RecordStore()
    store.add(tstore.TuneRecord(space="attention", inputs=DECODE,
                                config=CFG_DECODE, tflops=1.0, backend=FP))
    tstore.install_serving(store=store, fingerprint=FP,
                           build_plan=False)
    tdispatch.reset_counts()
    yield store
    tstore.clear_store()


def test_dispatch_flash_attention_exact_and_nearest(attn_store):
    q, k, v = (torch.from_numpy(t).bfloat16()
               for t in _inputs(4, 9, 3, 1, 256, 64))
    out = tdispatch.flash_attention(q, k, v, causal=True, q_offset=255)
    assert torch.equal(out, tops.flash_attention(q, k, v, CFG_DECODE,
                                                 q_offset=255))
    assert tdispatch.tier_counts[("attention", "exact")] == 1
    cfg, tier = tdispatch._resolve_cfg("attention", {**DECODE, "Lkv": 320})
    assert (cfg, tier) == (CFG_DECODE, "nearest")


def test_dispatch_attention_degrades_to_the_ops_defaults(attn_store):
    """Repair: attention has no vendor menu; an untuned shape resolves to
    no config (the ops defaults), as the reference's does, never raises."""
    far = attention_input(1, 40, 8, 4096, 4096, 128)
    with pytest.warns(RuntimeWarning, match="no launchable record"):
        cfg, tier = tdispatch._resolve_cfg("attention", far)
    assert (cfg, tier) == (None, "degraded")
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 4, 2, 20, 20, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = tdispatch.flash_attention(q, k, v)
    assert torch.equal(out, tops.flash_attention(q, k, v, None))


def test_dispatch_attention_passes_over_an_unlaunchable_record(attn_store):
    shape = {**DECODE, "Lkv": 288}
    attn_store.add(tstore.TuneRecord(space="attention", inputs=shape,
                                     config=CFG_TPU, tflops=9.0, backend=FP))
    with pytest.warns(RuntimeWarning, match="cannot launch"):
        cfg, tier = tdispatch._resolve_cfg("attention", shape)
    assert (cfg, tier) == (CFG_DECODE, "nearest")


def test_decode_splits_resolve_exact_from_a_tuned_record(attn_store):
    n = resolve_decode_splits(B=4, Hq=9, Hkv=3, Lkv=256, D=64, dtype_bits=16,
                              default=16)
    assert n == 256 // CFG_DECODE["b_kv"]
    assert tdispatch.tier_counts[("attention", "exact")] == 1


def test_untuned_decode_tick_resolves_the_default_splits(attn_store):
    """Repair: a decode tick at a shape the store does not cover falls to
    the degraded tier, which returns no config for attention, and the
    caller's default split count is used: nothing raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        n = resolve_decode_splits(B=8, Hq=40, Hkv=8, Lkv=32768, D=128,
                                  dtype_bits=16, default=16)
    assert n == 16
    assert tdispatch.tier_counts[("attention", "degraded")] == 1
    tstore.clear_store()
    assert resolve_decode_splits(B=4, Hq=9, Hkv=3, Lkv=256, D=64,
                                 dtype_bits=16, default=16) == 16


def test_decode_splits_pass_over_an_unlaunchable_record():
    store = tstore.RecordStore()
    store.add(tstore.TuneRecord(space="attention", inputs=DECODE,
                                config=CFG_TPU, tflops=2.0, backend=FP))
    tstore.install_store(store, fingerprint=FP)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            n = resolve_decode_splits(B=4, Hq=9, Hkv=3, Lkv=256, D=64,
                                      dtype_bits=16, default=16)
        assert n == 16              # b_kv=2048 never turns into a split
    finally:
        tstore.clear_store()
