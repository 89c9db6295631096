"""The port's Mamba-2 SSD chunk scan (plain path on the CPU) against the JAX
package's ``ops.ssd_scan`` in Pallas interpret mode and ``ref.ssd_ref``, on
the same numpy inputs; the port's ``ssd_ref`` against the reference's; the
Hopper SSD space, the shrink rules, the correctness gate and
``dispatch.ssd_scan``'s tiers.

Tolerances: max-abs error over the oracle's max, 1e-3 in fp32 (as
tests/test_kernels.py) and 2e-2 in bf16.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.backend import CheckedBackend, CudaEventBackend
from repro_torch.core.space import (FITS, SMEM_PER_BLOCK, SSD_SPACE,
                                    ConfigRejected, gemm_input, ssd_fits,
                                    ssd_input, ssd_is_legal, ssd_smem_bytes)
from repro_torch.core.tuner import InputAwareTuner
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as kssd
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb.session import TuningSession

TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _inputs(B, L, H, P, S, seed=0, a_range=(0.5, 2.0), dt_range=(0.01, 0.2)):
    rng = np.random.default_rng(seed + L + 3 * H + P + S)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = rng.uniform(*dt_range, size=(B, L, H)).astype(np.float32)
    a = -rng.uniform(*a_range, size=(H,)).astype(np.float32)
    bm = rng.normal(size=(B, L, S)).astype(np.float32)
    cm = rng.normal(size=(B, L, S)).astype(np.float32)
    return x, dt, a, bm, cm


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _torch(arrs, dtype):
    td = getattr(torch, dtype)
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in arrs)
    return x.to(td), dt.to(td), a, bm.to(td), cm.to(td)


def _jax_args(arrs, dtype):
    x, dt, a, bm, cm = arrs
    return (jnp.asarray(x, dtype), jnp.asarray(dt, dtype), jnp.asarray(a),
            jnp.asarray(bm, dtype), jnp.asarray(cm, dtype))


# (name, (B, L, H, P, S), cfg, dtype): ragged L in several, head blocks
CASES = [
    ("aligned", (2, 64, 4, 16, 32), {"chunk": 32, "b_heads": 1}, "float32"),
    ("ragged", (1, 100, 4, 16, 32), {"chunk": 32, "b_heads": 2}, "float32"),
    ("ragged,bf16", (2, 75, 2, 32, 16), {"chunk": 16, "b_heads": 2},
     "bfloat16"),
    ("one chunk", (1, 40, 4, 8, 16), {"chunk": 64, "b_heads": 4}, "float32"),
    ("bf16", (1, 96, 4, 16, 32), {"chunk": 64, "b_heads": 1}, "bfloat16"),
]


@pytest.mark.parametrize("name,shape,cfg,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_ssd_scan_matches_jax_kernel_and_oracle(name, shape, cfg, dtype):
    arrs = _inputs(*shape)
    full = {"acc32": 1, "prefetch": 2, **cfg}
    got = tops.ssd_scan(*_torch(arrs, dtype), full)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape[:4]
    got = got.float().numpy()
    want = np.asarray(jops.ssd_scan(*_jax_args(arrs, dtype), full,
                                    interpret=True), np.float32)
    oracle = np.asarray(jref.ssd_ref(*_jax_args(arrs, dtype)), np.float32)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(got, oracle) <= TOL[dtype]


@pytest.mark.parametrize("L", [1, 37, 130])
def test_ragged_l_equals_the_unpadded_result(L):
    """A ragged last chunk is masked by length: the first L steps of a
    longer sequence give the same y as the sequence cut to L."""
    arrs = _inputs(1, 160, 2, 8, 16, seed=5)
    cfg = {"chunk": 64, "b_heads": 1, "acc32": 1, "prefetch": 2}
    long = tops.ssd_scan(*_torch(arrs, "float32"), cfg)
    cut = tops.ssd_scan(*_torch([t[:, :L] if t.ndim > 1 else t
                                 for t in arrs], "float32"), cfg)
    assert torch.allclose(cut, long[:, :L], atol=1e-5, rtol=1e-5)
    oracle = tref.ssd_ref(*_torch([t[:, :L] if t.ndim > 1 else t
                                   for t in arrs], "float32"))
    assert _rel(cut.numpy(), oracle.numpy()) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_matches_jax(dtype):
    arrs = _inputs(2, 50, 3, 8, 12, seed=2)
    got = tref.ssd_ref(*_torch(arrs, dtype)).float().numpy()
    want = np.asarray(jref.ssd_ref(*_jax_args(arrs, dtype)), np.float32)
    assert _rel(got, want) <= (1e-5 if dtype == "float32" else 1e-2)


def test_exponent_is_masked_before_the_exp():
    """With steep decays exp(cum_i - cum_j) for j > i overflows fp32 (here
    to +inf, times a zero-masked score: NaN); the plain version forms the
    exponent only where j <= i and stays finite and right."""
    arrs = _inputs(1, 64, 2, 8, 8, seed=3, a_range=(40.0, 60.0),
                   dt_range=(0.5, 1.0))
    cfg = {"chunk": 64, "b_heads": 1, "acc32": 1, "prefetch": 2}
    x, dt, a, bm, cm = _torch(arrs, "float32")
    cum = torch.cumsum(dt * a, dim=1)
    assert float((cum[:, 0] - cum[:, -1]).max()) > 1000   # exp overflows
    got = tops.ssd_scan(x, dt, a, bm, cm, cfg)
    assert bool(torch.isfinite(got).all())
    assert _rel(got.numpy(), tref.ssd_ref(x, dt, a, bm, cm).numpy()) \
        <= TOL["float32"]


def test_acc32_and_b_heads_do_not_change_the_arithmetic():
    arrs = _torch(_inputs(1, 48, 4, 8, 16, seed=4), "bfloat16")
    base = {"chunk": 16, "prefetch": 2}
    ref0 = tops.ssd_scan(*arrs, {**base, "b_heads": 1, "acc32": 1})
    for bh, acc in ((1, 0), (2, 1), (4, 0)):
        assert torch.equal(tops.ssd_scan(*arrs, {**base, "b_heads": bh,
                                                 "acc32": acc}), ref0)


# -- the Hopper SSD space -------------------------------------------------------

def test_ssd_space_legality_follows_shared_memory():
    cfg = {"chunk": 128, "b_heads": 1, "acc32": 1, "prefetch": 2}
    stage = 128 * 64 * 2 + 128 * 2 + 2 * 128 * (128 * 2 + 16)
    assert ssd_smem_bytes(cfg, 16, 64, 128) == 2 * stage + 64 * 128 * 4 \
        + 16 * 132 * 4 + 2 * 128 * 4
    assert ssd_fits(cfg, 16, 64, 128)
    # chunk 256 holds only at one stage and one head at mamba2's P, S
    big = {"chunk": 256, "b_heads": 1, "acc32": 1, "prefetch": 1}
    assert ssd_fits(big, 16, 64, 128)
    assert not ssd_fits({**big, "prefetch": 2}, 16, 64, 128)
    assert not ssd_fits({**big, "b_heads": 2}, 16, 64, 128)
    assert not ssd_fits(big, 32, 64, 128)
    assert not ssd_fits({**cfg, "acc32": 0}, 32, 32, 32)
    for c in SSD_SPACE.enumerate():
        for bits, P, S in ((16, 64, 128), (32, 64, 128), (16, 128, 256)):
            if ssd_fits(c, bits, P, S):
                assert ssd_smem_bytes(c, bits, P, S) <= SMEM_PER_BLOCK
    assert FITS["ssd"](cfg, ssd_input(1, 2048, 64, 64, 128))


@pytest.mark.parametrize("P,S", [(20, 32), (16, 36)])
def test_dims_not_a_multiple_of_8_are_rejected(P, S):
    """The kernel reads x, B and C rows in 16-byte pieces: no config fits
    such a P or S, and the wrapper raises on any device."""
    assert not any(ssd_fits(c, 16, P, S) for c in SSD_SPACE.enumerate())
    x = torch.zeros((1, 16, 2, P))
    dt = torch.zeros((1, 16, 2))
    bc = torch.zeros((1, 16, S))
    with pytest.raises(ValueError, match="multiples of 8"):
        tops.ssd_scan(x, dt, -torch.ones(2), bc, bc)


def test_tpu_sized_ssd_configs_fail_fits():
    for tpu in ({"chunk": 512, "b_heads": 1, "acc32": 1, "prefetch": 2},
                {"chunk": 256, "b_heads": 8, "acc32": 1, "prefetch": 2}):
        assert not ssd_fits(tpu, 16, 64, 128)
        assert not FITS["ssd"](tpu, ssd_input(1, 2048, 64, 64, 128))


def test_ssd_space_sizes_chunks_and_head_blocks_to_the_problem():
    x = ssd_input(1, 40, 6, 16, 32)
    ok = {"chunk": 32, "b_heads": 2, "acc32": 1, "prefetch": 2}
    assert ssd_is_legal(ok, x)
    assert not ssd_is_legal({**ok, "chunk": 64}, x)
    assert not ssd_is_legal({**ok, "b_heads": 4}, x)          # 4 does not | 6


@pytest.mark.parametrize("L,H,P,S,bits", [(2048, 64, 64, 128, 16),
                                          (4096, 128, 64, 128, 16),
                                          (20, 6, 24, 40, 32),
                                          (300, 16, 128, 256, 16)])
def test_shrink_keeps_every_config_launchable(L, H, P, S, bits):
    for cfg in SSD_SPACE.enumerate():
        if bits == 32 and not cfg["acc32"]:
            continue
        small = tops.shrink_ssd_cfg(cfg, L, H, P, S, bits)
        assert ssd_fits(small, bits, P, S), (cfg, small)
        assert H % small["b_heads"] == 0
        assert small["chunk"] <= max(-(-L // 16) * 16, 16)
        if ssd_is_legal(cfg, ssd_input(1, L, H, P, S, bits)):
            assert small == cfg


# -- the correctness gate -------------------------------------------------------

CFG = {"chunk": 32, "b_heads": 2, "acc32": 1, "prefetch": 2}


@pytest.mark.parametrize("shape,bits", [((1, 96, 4, 16, 32), 16),
                                        ((2, 80, 8, 32, 16), 32)])
def test_gate_gives_the_reference_verdict(shape, bits):
    inputs = ssd_input(*shape, dtype_bits=bits)
    jdispatch.check_config("ssd", CFG, inputs)            # passes
    tdispatch.check_config("ssd", CFG, inputs, device="cpu")


def test_gate_catches_a_wrong_kernel(monkeypatch):
    inputs = ssd_input(1, 64, 4, 16, 32)
    plain = kssd.ssd_plain
    monkeypatch.setattr(kssd, "ssd", lambda *a, **k: plain(*a, **k) * 1.05)
    with pytest.raises(ConfigRejected, match="rel err"):
        tdispatch.check_config("ssd", CFG, inputs, device="cpu")


def test_gate_instance_and_oracle_cache(monkeypatch):
    """The reference's caps on the CPU, the whole shape on the card; the
    oracle of a gate instance is computed once for every config checked
    there (a Python loop over L at full size)."""
    x = ssd_input(1, 4096, 128, 64, 128)
    assert tdispatch.gate_instance("ssd", x, "cuda") == x
    assert tdispatch.gate_instance("ssd", x, "cpu") == ssd_input(
        1, 512, 4, 64, 64)
    calls = []
    real = tref.ssd_ref

    def counting(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(tdispatch.ref, "ssd_ref", counting)
    cases = tdispatch.GateCases()
    inputs = ssd_input(1, 40, 4, 8, 16)
    for chunk in (16, 32, 64):
        tdispatch.check_config("ssd", {**CFG, "chunk": chunk}, inputs,
                               device="cpu", cases=cases)
    assert len(calls) == 1 and len(cases) == 1


def test_gate_keeps_no_oracle_past_its_owner(monkeypatch):
    """Without a cache the gate draws its case anew and keeps nothing; a
    CheckedBackend keeps its attention/SSD cases (never GEMM or conv
    ones) until the tuning session that used it ends."""
    calls = []
    real = tref.ssd_ref

    def counting(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(tdispatch.ref, "ssd_ref", counting)
    inputs = ssd_input(1, 40, 4, 8, 16)
    for chunk in (16, 32):
        tdispatch.check_config("ssd", {**CFG, "chunk": chunk}, inputs,
                               device="cpu")
    assert len(calls) == 2
    backend = CheckedBackend(CudaEventBackend(device="cpu"))
    backend.check("ssd", CFG, inputs)
    backend.check("gemm", dict(tops.DEFAULT_GEMM), gemm_input(8, 16, 32))
    assert len(backend._cases) == 1
    tuner = InputAwareTuner.train(SSD_SPACE, backend=backend, n_samples=4,
                                  epochs=1, hidden=(8,), seed=0)
    assert len(backend._cases) >= 1
    report = TuningSession(tuner, tstore.RecordStore(), workers=1).run(
        [inputs])
    assert report.tuned == 1 and len(backend._cases) == 0


# -- dispatch.ssd_scan through the tiers ----------------------------------------

FP = "repro_torch.CudaEventBackend/device=test"
TUNED = ssd_input(1, 64, 4, 16, 32)
CFG_TUNED = {"chunk": 16, "b_heads": 4, "acc32": 1, "prefetch": 3}


@pytest.fixture
def ssd_store():
    store = tstore.RecordStore()
    store.add(tstore.TuneRecord(space="ssd", inputs=TUNED, config=CFG_TUNED,
                                tflops=1.0, backend=FP))
    tstore.install_store(store, fingerprint=FP)
    tdispatch.reset_counts()
    yield store
    tstore.clear_store()


def test_dispatch_ssd_scan_exact_nearest_and_degraded(ssd_store):
    arrs = _torch(_inputs(1, 64, 4, 16, 32, seed=6), "bfloat16")
    out = tdispatch.ssd_scan(*arrs)
    assert torch.equal(out, tops.ssd_scan(*arrs, CFG_TUNED))
    assert tdispatch.tier_counts[("ssd", "exact")] == 1
    cfg, tier = tdispatch._resolve_cfg("ssd", {**TUNED, "L": 96})
    assert (cfg, tier) == (CFG_TUNED, "nearest")
    with pytest.warns(RuntimeWarning, match="no launchable record"):
        cfg, tier = tdispatch._resolve_cfg("ssd", ssd_input(1, 4096, 128, 64,
                                                            128))
    assert (cfg, tier) == (None, "degraded")


def test_dispatch_ssd_passes_over_an_unlaunchable_record(ssd_store):
    shape = {**TUNED, "L": 80}
    ssd_store.add(tstore.TuneRecord(
        space="ssd", inputs=shape, tflops=9.0, backend=FP,
        config={"chunk": 512, "b_heads": 1, "acc32": 1, "prefetch": 2}))
    with pytest.warns(RuntimeWarning, match="cannot launch"):
        cfg, tier = tdispatch._resolve_cfg("ssd", shape)
    assert (cfg, tier) == (CFG_TUNED, "nearest")
    arrs = _torch(_inputs(1, 80, 4, 16, 32, seed=7), "bfloat16")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = tdispatch.ssd_scan(*arrs)
    assert _rel(out.float().numpy(), tref.ssd_ref(*arrs).float().numpy()) \
        <= TOL["bfloat16"]
