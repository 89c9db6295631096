"""The port's CUDA kernels on the card: kernel vs plain version at the
serving path's and the conv tuning path's shapes, and the timing backend.
Skips without a GPU; on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core.backend import CheckedBackend, CudaEventBackend
from repro_torch.core.space import conv_input, gemm_input
from repro_torch.kernels import conv as kconv
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops as tops

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
