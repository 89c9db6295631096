"""The port's CUDA kernels on the card: kernel vs plain version (and the
fp32 oracle) at the serving path's, the conv tuning path's and the
attention and SSD tuning paths' shapes, and the timing backend.
Skips without a GPU; on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core.backend import CheckedBackend, CudaEventBackend
from repro_torch.core.space import (attention_input, conv_input, gemm_input,
                                    ssd_input)
from repro_torch.kernels import attention as kattention
from repro_torch.kernels import conv as kconv
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as kssd

pytestmark = pytest.mark.cuda

SHAPES = [(M, N, K) for M in (4, 32)
          for (N, K) in ((576, 576), (192, 576), (1536, 576), (576, 1536))]
CONFIGS = [
    dict(tops.DEFAULT_GEMM),
    {"bm": 32, "bn": 64, "bk": 64, "k_unroll": 2, "k_split": 4,
     "order": 1, "acc32": 0, "prefetch": 3},
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the GEMM kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gemm_kernel_matches_plain(cuda, shape, cfg):
    M, N, K = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(M + N + K)
    a = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    b = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5).bfloat16()
    small = tops.shrink_gemm_cfg(cfg, M, N, K)
    before = kmatmul.launches
    got = kmatmul.gemm(a, b, small)
    want = kmatmul.matmul_plain(a, b, small)
    torch.cuda.synchronize()
    assert kmatmul.launches == before + 1
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= 2e-2


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(kmatmul, "matmul_plain", boom)
    a = torch.ones((4, 576), device=cuda, dtype=torch.bfloat16)
    b = torch.ones((576, 192), device=cuda, dtype=torch.bfloat16)
    out = tops.matmul(a, b, {"k_split": 2})
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 576.0))


# (N, H, W, C, K, R, S): Table 5's C=1 / 5x20, K=174, and a ragged one
CONV_SHAPES = [(16, 79, 341, 1, 32, 5, 20), (16, 128, 39, 64, 174, 5, 5),
               (3, 5, 7, 20, 24, 4, 2)]
CONV_CONFIGS = [
    dict(tops.DEFAULT_CONV),
    {"b_npq": 128, "b_k": 32, "b_c": 8, "rs_unroll": 4, "c_split": 2,
     "order": 1, "acc32": 0, "prefetch": 3},
]


@pytest.mark.parametrize("cfg", CONV_CONFIGS)
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_matches_plain(cuda, shape, cfg):
    N, H, W, C, K, R, S = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(C + K)
    i = torch.randn((N, H, W, C), generator=gen, device=cuda).bfloat16()
    f = (torch.randn((R, S, C, K), generator=gen, device=cuda)
         / (R * S * C) ** 0.5).bfloat16()
    small = tops.shrink_conv_cfg(cfg, N, H, W, C, K, R, S)
    before = kconv.launches
    got = kconv.conv(i, f, small)
    want = kconv.conv2d_plain(i, f, small)
    torch.cuda.synchronize()
    assert kconv.launches == before + 1
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= 2e-2


def test_backend_times_the_kernels_behind_the_gate(cuda):
    backend = CheckedBackend(CudaEventBackend(device=cuda))
    g0, c0 = kmatmul.launches, kconv.launches
    assert backend.measure("gemm", dict(tops.DEFAULT_GEMM),
                           gemm_input(32, 576, 576)) > 0
    assert backend.measure("conv", dict(tops.DEFAULT_CONV),
                           conv_input(8, 27, 27, 128, 128, 3, 3)) > 0
    assert kmatmul.launches > g0 and kconv.launches > c0
    assert "device=" + torch.cuda.get_device_name(cuda) in backend.fingerprint


def _rel(got, want):
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / max(float(w.abs().max()), 1e-6))


# (B, Hq, Hkv, Lq, Lkv, D, causal, q_offset): SmolLM-135M decode over a
# 256-entry cache, a causal prefill, GQA groups 3 and 5, the three ragged
# non-causal shapes the reference's offset trick gets wrong, a narrow head
# dim (D=24)
ATTN_SHAPES = [(4, 9, 3, 1, 256, 64, True, 255), (1, 6, 2, 300, 300, 64, True, 0),
               (2, 10, 2, 40, 77, 128, False, 0), (1, 4, 4, 4, 100, 64, False, 0),
               (1, 4, 2, 8, 200, 64, False, 0), (1, 4, 2, 130, 100, 64, False, 0),
               (2, 3, 1, 33, 50, 24, True, 17)]
ATTN_CONFIGS = [
    dict(tops.DEFAULT_ATTN),
    {"b_q": 16, "b_kv": 128, "acc32": 1, "prefetch": 3},
    {"b_q": 128, "b_kv": 16, "acc32": 0, "prefetch": 1},
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cfg", ATTN_CONFIGS)
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_kernel_matches_plain_and_oracle(cuda, shape, cfg, dtype):
    B, Hq, Hkv, Lq, Lkv, D, causal, off = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(Lq + Lkv + D)
    q = torch.randn((B, Hq, Lq, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Hkv, Lkv, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Hkv, Lkv, D), generator=gen, device=cuda).to(dtype)
    if dtype == torch.float32:          # fp32 IO needs acc32=1
        cfg = {**cfg, "acc32": 1}
    small = tops.shrink_attention_cfg(cfg, Lq, Lkv, D,
                                      torch.finfo(dtype).bits)
    before = kattention.launches
    got = kattention.attention(q, k, v, small, causal=causal, q_offset=off)
    want = kattention.attention_plain(q, k, v, small, causal=causal,
                                      q_offset=off)
    torch.cuda.synchronize()
    assert kattention.launches == before + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel(got, want) <= tol
    oracle = tref.attention_ref(q, k, v, causal=causal, q_offset=off)
    assert _rel(got, oracle) <= (2e-2 if dtype == torch.bfloat16 else 2e-3)


# (B, L, H, P, S): a mamba2-1.3b-wide layer over a ragged L, a narrow one
# (P=24, S=40), a short sequence
SSD_SHAPES = [(1, 300, 8, 64, 128), (2, 97, 4, 24, 40), (2, 40, 8, 32, 64)]
SSD_CONFIGS = [
    dict(tops.DEFAULT_SSD),
    {"chunk": 16, "b_heads": 4, "acc32": 1, "prefetch": 3},
    {"chunk": 256, "b_heads": 1, "acc32": 0, "prefetch": 1},
    {"chunk": 32, "b_heads": 2, "acc32": 1, "prefetch": 2},
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cfg", SSD_CONFIGS)
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain_and_oracle(cuda, shape, cfg, dtype):
    B, L, H, P, S = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(L + P + S)
    x = torch.randn((B, L, H, P), generator=gen, device=cuda).to(dtype)
    dt = (0.01 + 0.09 * torch.rand((B, L, H), generator=gen, device=cuda)
          ).to(dtype)
    a = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=cuda))
    bm = torch.randn((B, L, S), generator=gen, device=cuda).to(dtype)
    cm = torch.randn((B, L, S), generator=gen, device=cuda).to(dtype)
    bits = torch.finfo(dtype).bits
    if bits == 32:                      # fp32 IO needs acc32=1
        cfg = {**cfg, "acc32": 1}
    small = tops.shrink_ssd_cfg(cfg, L, H, P, S, bits)
    before = kssd.launches
    got = kssd.ssd(x, dt, a, bm, cm, small)
    want = kssd.ssd_plain(x, dt, a, bm, cm, small)
    torch.cuda.synchronize()
    assert kssd.launches == before + 1
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel(got, want) <= tol
    oracle = tref.ssd_ref(x, dt, a, bm, cm)
    assert _rel(got, oracle) <= (2e-2 if dtype == torch.bfloat16 else 1e-3)


def test_attention_and_ssd_never_take_the_plain_version_on_cuda(
        cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version or SDPA called for a CUDA tensor")
    monkeypatch.setattr(kattention, "attention_plain", boom)
    monkeypatch.setattr(kssd, "ssd_plain", boom)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        boom)
    q = torch.ones((1, 2, 3, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.ones((1, 1, 5, 64), device=cuda, dtype=torch.bfloat16)
    out = tops.flash_attention(q, kv, kv, causal=False)
    x = torch.zeros((1, 20, 2, 8), device=cuda, dtype=torch.bfloat16)
    dt = torch.zeros((1, 20, 2), device=cuda, dtype=torch.bfloat16)
    bc = torch.zeros((1, 20, 8), device=cuda, dtype=torch.bfloat16)
    y = tops.ssd_scan(x, dt, -torch.ones(2, device=cuda), bc, bc)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones_like(out))
    assert torch.equal(y, torch.zeros_like(y))


def test_backend_times_attention_and_ssd_behind_the_gate(cuda):
    backend = CheckedBackend(CudaEventBackend(device=cuda))
    a0, s0 = kattention.launches, kssd.launches
    assert backend.measure("attention", dict(tops.DEFAULT_ATTN),
                           attention_input(4, 9, 3, 1, 256, 64)) > 0
    assert backend.measure("attention", dict(tops.DEFAULT_ATTN),
                           attention_input(1, 9, 3, 512, 512, 64)) > 0
    assert backend.measure("ssd", dict(tops.DEFAULT_SSD),
                           ssd_input(1, 512, 16, 64, 128)) > 0
    assert kattention.launches > a0 and kssd.launches > s0
