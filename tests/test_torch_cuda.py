"""The port's CUDA kernels on the card: kernel vs plain version at the
serving path's shapes.  Skips without a GPU; on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

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
