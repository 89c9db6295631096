"""The port's CUDA kernels on the card: kernel vs plain version (and the
fp32 oracle) at the serving path's, the conv tuning path's and the
attention and SSD tuning paths' shapes, the GEMM's split-K reduction pass,
and the timing backend.
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


# every bf16 warp layout of the mma.sync body (1 warp at 16 x 32 to 8 at
# 128 x 128), bm and bn not shrunk to the problem: the kernel masks rows
# and columns past M and N itself
MMA_LAYOUTS = [(bm, bn) for bm in (16, 32, 64, 128) for bn in (32, 64, 128)]
MMA_SHAPES = SHAPES + [(5, 100, 300)]     # ragged, unaligned: element loads


@pytest.mark.parametrize("k_unroll", [1, 2, 4])
@pytest.mark.parametrize("acc32", [0, 1])
@pytest.mark.parametrize("layout", MMA_LAYOUTS)
def test_gemm_mma_layout_matches_plain(cuda, layout, acc32, k_unroll):
    """The bf16 body under one warp layout, acc32 and k_unroll (sub-dots
    of 64 / k_unroll elements) against the plain version at 2e-2, at the 8
    serving shapes and a ragged unaligned one."""
    bm, bn = layout
    i = MMA_LAYOUTS.index(layout)
    cfg = {"bm": bm, "bn": bn, "bk": 64, "k_unroll": k_unroll,
           "k_split": 2, "order": i % 2, "acc32": acc32,
           "prefetch": 1 + i % 3}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(bm + bn + acc32 + k_unroll)
    for M, N, K in MMA_SHAPES:
        a = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
        b = (torch.randn((K, N), generator=gen, device=cuda)
             / K ** 0.5).bfloat16()
        got = kmatmul.gemm(a, b, cfg)
        want = kmatmul.matmul_plain(a, b, cfg)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (2, M, N)
        assert _rel(got, want) <= 2e-2, (M, N, K)


def _ulp_distance(got, want):
    """Largest distance in ulps between two bf16 tensors (bit patterns
    mapped to integers in value order; +0 and -0 both 0)."""
    b = torch.stack([got, want]).contiguous().view(torch.int16).long()
    b = torch.where(b >= 0, b, -(1 << 15) - b)
    return int((b[0] - b[1]).abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 4, 576), (8, 32, 1536), (8, 4, 192),
                                   (4, 5, 99), (3, 130, 1001)])
def test_splitk_reduce_matches_plain(cuda, shape, dtype):
    """The reduction pass against its plain version: bf16 within one ulp
    (both sum in fp32 and round once, in orders that may differ); fp32
    within 1e-6 of the largest sum.  Odd lengths take the element path."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape))
    parts = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    got = kmatmul.splitk_reduce(parts)
    want = kmatmul.splitk_reduce_plain(parts)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == shape[1:]
    if dtype == torch.bfloat16:
        assert _ulp_distance(got, want) <= 1
    else:
        assert _rel(got, want) <= 1e-6


def test_split_call_launches_one_kernel_and_one_reduction(cuda):
    a = torch.randn((4, 576), device=cuda).bfloat16()
    b = torch.randn((576, 192), device=cuda).bfloat16()
    for ks, reductions in ((1, 0), (2, 1), (8, 1)):
        g0, r0 = kmatmul.launches, kmatmul.reduce_launches
        tops.matmul(a, b, {"bm": 16, "bn": 64, "bk": 64, "k_split": ks})
        torch.cuda.synchronize()
        assert (kmatmul.launches - g0, kmatmul.reduce_launches - r0) == (
            1, reductions), ks


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(kmatmul, "matmul_plain", boom)
    monkeypatch.setattr(kmatmul, "splitk_reduce_plain", boom)
    a = torch.ones((4, 576), device=cuda, dtype=torch.bfloat16)
    b = torch.ones((576, 192), device=cuda, dtype=torch.bfloat16)
    out = tops.matmul(a, b, {"k_split": 2})
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 576.0))


# (N, H, W, C, K, R, S): Table 5's C=1 / 5x20, K=174 and K=87 (element
# loads of the filter rows, odd output rows), and a ragged one
CONV_SHAPES = [(16, 79, 341, 1, 32, 5, 20), (16, 128, 39, 64, 174, 5, 5),
               (16, 256, 19, 128, 87, 5, 5), (3, 5, 7, 20, 24, 4, 2)]
# the bf16 body's cases: b_c=8 (one m16n8k8 step a window), acc32=0, the
# smallest (16 x 16, one warp) and the largest (128 x 128, 8 warps) tiles
CONV_CONFIGS = [
    dict(tops.DEFAULT_CONV),
    {"b_npq": 128, "b_k": 32, "b_c": 8, "rs_unroll": 4, "c_split": 2,
     "order": 1, "acc32": 0, "prefetch": 3},
    {"b_npq": 16, "b_k": 16, "b_c": 16, "rs_unroll": 2, "c_split": 1,
     "order": 0, "acc32": 0, "prefetch": 2},
    {"b_npq": 128, "b_k": 128, "b_c": 64, "rs_unroll": 1, "c_split": 1,
     "order": 1, "acc32": 1, "prefetch": 2},
    {"b_npq": 128, "b_k": 128, "b_c": 8, "rs_unroll": 2, "c_split": 1,
     "order": 0, "acc32": 0, "prefetch": 3},
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
# dim (D=24); packed rows that straddle two heads (500 rows of a KV head
# in tiles of 16 to 128), decode at group 5 over a cache that is not a
# multiple of b_kv, decode at group 8
ATTN_SHAPES = [(4, 9, 3, 1, 256, 64, True, 255), (1, 6, 2, 300, 300, 64, True, 0),
               (2, 10, 2, 40, 77, 128, False, 0), (1, 4, 4, 4, 100, 64, False, 0),
               (1, 4, 2, 8, 200, 64, False, 0), (1, 4, 2, 130, 100, 64, False, 0),
               (2, 3, 1, 33, 50, 24, True, 17), (1, 10, 2, 100, 100, 64, True, 0),
               (2, 40, 8, 1, 1000, 128, True, 999), (1, 32, 4, 1, 4096, 128, True, 4095)]
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
                                      torch.finfo(dtype).bits,
                                      group=Hq // Hkv)
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


def test_graph_decode_tokens_equal_the_eager_tick(cuda):
    """The engine serves decode ticks from one captured CUDA graph (and
    each prompt length's prefill from its own); the same requests through
    its eager prefill and tick give the same greedy tokens."""
    import numpy as np

    from repro_torch.configs import smollm_135m
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb.store import clear_store

    clear_store()
    cfg = smollm_135m.SMOKE
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3, 12, 7)]
    eng = Engine(cfg, params, ServeConfig(max_len=64, slots=3), device=cuda)
    graph = eng.generate(prompts, max_new=8)
    assert eng.captures == 1 and eng.replays == eng.ticks > 0
    again = eng.generate(prompts, max_new=8)          # no re-capture
    assert eng.captures == 1 and again == graph
    assert eng.prefill_captures == 5 and eng.prefill_replays == 10
    eager = Engine(cfg, params, ServeConfig(max_len=64, slots=3),
                   device=cuda)
    eager.prefill, eager.decode = eager.prefill_eager, eager.decode_eager
    assert eager.generate(prompts, max_new=8) == graph
    assert eager.captures == eager.prefill_captures == 0


def test_graph_prefill_equals_the_eager_prefill(cuda):
    """A prefill replayed from its length's graph gives the eager
    prefill's logits, bitwise, and the same slot cache rows, the rows past
    the prompt zero (lengths in falling order: a longer replay leaves the
    static cache and the slot dirty for the next); a new serving
    generation drops every prefill graph."""
    import numpy as np

    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb.store import clear_store, serving_state

    clear_store()
    cfg, params = _smoke_engine_params(cuda)
    eng = Engine(cfg, params, ServeConfig(max_len=64, slots=2), device=cuda)
    kv = eng.cache["pos0"]["attn"]
    rng = np.random.default_rng(3)
    for n in (40, 17, 9, 1):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, n)[None],
                                 device=cuda)
        graph = eng.prefill_graph(1, tokens).clone()
        rows = [kv[k][:, 1].clone() for k in ("k", "v")]
        eager = eng.prefill_eager(1, tokens)
        assert torch.equal(graph, eager), n
        for k, got in zip(("k", "v"), rows):
            assert torch.equal(got, kv[k][:, 1]), (n, k)
            assert not got[:, n:].any() and got[:, :n].any()
    assert sorted(eng.prefill_graphs) == [1, 9, 17, 40]
    assert eng.prefill_captures == 4 and eng.prefill_graph_bytes() > 0
    gen = serving_state().generation
    clear_store()                                    # a new generation
    assert serving_state().generation == gen + 1
    eng.prefill_graph(0, tokens)
    assert sorted(eng.prefill_graphs) == [1] and eng.prefill_captures == 5


def _mamba_engine(cuda, **kw):
    from repro_torch.configs import mamba2_1p3b
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    cfg = mamba2_1p3b.SMOKE
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    return Engine(cfg, params, ServeConfig(max_len=64, slots=2, **kw),
                  device=cuda)


def test_mamba_graph_tokens_equal_the_eager_engine(cuda):
    """mamba2-1.3b SMOKE served from the engine's CUDA graphs gives the
    eager prefill and tick's greedy tokens: slots reused, prompts longer
    than ssd_chunk (32), a 1-token prompt (the decode branch); a graph
    prefill leaves the slot's conv and SSM state equal to the single-slot
    cache's and to the eager prefill's, its logits bitwise the eager's."""
    import numpy as np

    from repro_torch.tunedb.store import clear_store

    clear_store()
    eng = _mamba_engine(cuda)
    cfg = eng.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 33, 1, 45, 9)]
    graph = eng.generate(prompts, max_new=6)
    assert eng.captures == 1 and eng.replays == eng.ticks > 0
    assert eng.prefill_captures == 5
    eager = _mamba_engine(cuda)
    eager.prefill, eager.decode = eager.prefill_eager, eager.decode_eager
    assert eager.generate(prompts, max_new=6) == graph
    state = eng.cache["pos0"]["mamba"]
    single = eng._single["pos0"]["mamba"]
    for n in (45, 9, 1):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, n)[None],
                                 device=cuda)
        logits = eng.prefill_graph(1, tokens).clone()
        got = {k: v[:, 1].clone() for k, v in state.items()}
        for k in ("conv", "ssm"):
            assert torch.equal(got[k], single[k][:, 0]), (n, k)
        assert torch.equal(logits, eng.prefill_eager(1, tokens)), n
        for k in ("conv", "ssm"):
            assert torch.equal(got[k], state[k][:, 1]), (n, k)


def test_capture_warm_up_leaves_the_recurrent_state(cuda):
    """A tick's capture runs it once eagerly first; the conv and SSM state
    are restored after that warm-up, so the first replay advances them
    once: state and logits bitwise those of one eager tick from the same
    state.  The same holds for a capture mid-serve, at a new generation."""
    import numpy as np

    from repro_torch.tunedb.store import clear_store

    clear_store()
    eng = _mamba_engine(cuda)
    rng = np.random.default_rng(4)
    for slot, n in enumerate((7, 40)):
        tokens = torch.as_tensor(rng.integers(0, eng.cfg.vocab, n)[None],
                                 device=cuda)
        eng.prefill_eager(slot, tokens)
    leaves = [t for v in eng.cache.values() for t in v["mamba"].values()]
    last = torch.tensor([[3], [11]], device=cuda)
    idx = torch.tensor([7, 40], device=cuda)
    for capture in range(2):
        before = [t.clone() for t in leaves]
        logits = eng.decode_graph(last, idx).clone()
        assert eng.captures == capture + 1
        after = [t.clone() for t in leaves]
        for t, b in zip(leaves, before):
            t.copy_(b)
        want = eng.decode_eager(last, idx)
        assert torch.equal(logits, want)
        for got, t, b in zip(after, leaves, before):
            assert torch.equal(got, t) and not torch.equal(got, b)
        clear_store()                   # a new generation: captured again


@pytest.mark.parametrize("name", ["gemm", "conv", "attention", "ssd"])
def test_largest_accepted_draws_peak_inside_their_footprint(cuda, name):
    """The card's draw budget counts enough memory: the two draws of the
    tuning CLI's pool (seed 0, 512 draws, the card's ``fits``) with the
    largest ``footprint_bytes``, labelled through the gate and the timer
    under their legal config with the most split partials, peak below
    it."""
    import gc

    import numpy as np

    from repro_torch.core.backend import footprint_bytes
    from repro_torch.core.dataset import workload_pool
    from repro_torch.core.space import SPACES, ConfigRejected

    space = SPACES[name]
    fits = CudaEventBackend(device=cuda).fits
    pool = workload_pool(space, 512, np.random.default_rng(0), fits)
    for x in sorted(pool, key=lambda x: footprint_bytes(name, x))[-2:]:
        cfg = max(space.enumerate_legal(x),
                  key=lambda c: c.get("k_split", c.get("c_split", 1)))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        backend = CheckedBackend(CudaEventBackend(device=cuda))
        try:
            backend.measure(name, cfg, x)
        except ConfigRejected:
            pass                    # the gate ran: its peak still counts
        peak = torch.cuda.max_memory_allocated() - base
        del backend
        assert peak <= footprint_bytes(name, x), (x, cfg, peak)


@pytest.fixture(scope="module")
def card_models():
    """A GEMM regressor trained on the card: records at the 8 serving
    shapes, 6 gated samples labelled at each (``collect_samples``), a
    small MLP (``train_models``)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: samples are labelled on the card")
    from repro_torch.tunedb.model import collect_samples, train_models
    from repro_torch.tunedb.store import RecordStore, TuneRecord
    backend = CheckedBackend(CudaEventBackend(device=torch.device("cuda")))
    store = RecordStore()
    for M, N, K in SHAPES:
        x = gemm_input(M, N, K, 16)
        cfg = tops.shrink_gemm_cfg(tops.DEFAULT_GEMM, M, N, K)
        store.add(TuneRecord(space="gemm", inputs=x, config=cfg,
                             tflops=backend.measure("gemm", cfg, x),
                             backend=backend.fingerprint))
    before = kmatmul.launches
    n = collect_samples(store, backend, per_shape=6, space="gemm")
    launched = kmatmul.launches - before
    models = train_models(store, space="gemm", hidden=(16, 16), epochs=5,
                          min_samples=8)
    return {"backend": backend, "store": store, "models": models, "n": n,
            "launched": launched}


def test_collect_samples_and_train_on_the_card(card_models):
    samples = [r for r in card_models["store"].training_records()
               if r.source == "sample"]
    fp = card_models["backend"].fingerprint
    assert 40 <= card_models["n"] == len(samples) <= 6 * len(SHAPES)
    assert card_models["launched"] > 0
    assert all(r.backend == fp and r.tflops > 0 for r in samples)
    assert list(card_models["models"].models) == [("gemm", fp)]
    assert card_models["models"].resolve_model("gemm", fp).meta[
        "n_samples"] == len(samples) + len(SHAPES)


@pytest.mark.parametrize("nk", [(576, 576), (192, 576), (1536, 576),
                                (576, 1536)])
@pytest.mark.parametrize("M", [8, 48])
def test_model_tier_picks_pass_the_gate(card_models, M, nk):
    """Each pick the model tier serves for a SmolLM-135M projection at a
    batch nobody tuned passes the correctness gate at its whole shape."""
    from repro_torch.kernels import dispatch
    from repro_torch.tunedb.store import RecordStore, install_serving
    x = gemm_input(M, nk[0], nk[1], 16)
    install_serving(store=RecordStore(), models=card_models["models"],
                    fingerprint=card_models["backend"].fingerprint,
                    build_plan=False)
    try:
        cfg, tier = dispatch._resolve_cfg("gemm", x)
    finally:
        install_serving(store=None, models=None, fingerprint=None)
    assert tier == "model"
    dispatch.check_config("gemm", cfg, x, device="cuda")


def test_a_measuring_resolution_under_capture_raises(card_models):
    """A model set with a measurer never measures while the current stream
    captures a CUDA graph: the resolution raises, and the same shape
    resolves (measuring) once the capture is over."""
    from repro_torch.tunedb.model import ModelSet
    measured = []
    models = ModelSet(measurer=lambda *a: measured.append(a) or 1.0,
                      remeasure_top_k=3)
    models.models.update(card_models["models"].models)
    fp = card_models["backend"].fingerprint
    x = gemm_input(17, 576, 576, 16)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream()):
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="captured"):
                models.predict("gemm", x, backend=fp)
        finally:
            graph.capture_end()
    assert not measured
    assert models.predict("gemm", x, backend=fp) is not None
    assert len(measured) == 3


def test_a_queued_resolution_under_capture_pushes(card_models):
    """With a measure queue attached the model set never measures: a
    resolution under capture serves the argmax and pushes the top-k, and
    the serving measurer itself refuses to time a config while a stream
    captures."""
    from repro_torch.tunedb.measure import MeasureQueue, ServingMeasurer
    from repro_torch.tunedb.model import ModelSet
    measurer = ServingMeasurer(device="cuda")
    models = ModelSet(measurer=measurer, remeasure_top_k=3)
    models.measure_queue = MeasureQueue()
    models.models.update(card_models["models"].models)
    fp = card_models["backend"].fingerprint
    x = gemm_input(17, 576, 576, 16)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream()):
        graph.capture_begin()
        try:
            got = models.predict("gemm", x, backend=fp)
            with pytest.raises(RuntimeError, match="captured"):
                measurer("gemm", got[0], x)
        finally:
            graph.capture_end()
    assert len(models.measure_queue) == 1
    assert measurer.counts["wallclock"] == 0
    assert models.measure_queue.process(measurer, models=models) == 1
    assert measurer.counts["wallclock"] == 3


def _smoke_engine_params(cuda, splits=4):
    import dataclasses

    from repro_torch.configs import smollm_135m
    from repro_torch.models import init_params
    cfg = dataclasses.replace(smollm_135m.SMOKE, decode_kv_splits=splits)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen)


def test_graph_and_eager_ticks_count_the_same_telemetry(cuda):
    """Neither a capture pass nor its warm-up counts: a graph run counts
    each shape once per tick replay and per prefill replay, exactly as the
    eager prefills and ticks count it on the same requests."""
    import numpy as np

    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb.store import clear_store
    from repro_torch.tunedb.telemetry import clear_telemetry, get_telemetry

    clear_store()
    cfg, params = _smoke_engine_params(cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3, 12, 7)]
    tel = get_telemetry()
    views = []
    for eager in (False, True):
        eng = Engine(cfg, params, ServeConfig(max_len=64, slots=3),
                     device=cuda)
        if eager:
            eng.prefill, eng.decode = eng.prefill_eager, eng.decode_eager
        clear_telemetry()
        eng.generate(prompts, max_new=6)
        per_fwd = 7 * cfg.n_layers
        assert tel.total("gemm") == per_fwd * (eng.prefills + eng.ticks)
        assert tel.total("attention") == cfg.n_layers * eng.ticks
        assert eng.captures == (0 if eager else 1)
        assert eng.prefill_replays == (0 if eager else eng.prefills)
        views.append({s: tel.hot_shapes(s, 100) for s in tel.spaces()})
    assert views[0] == views[1]
    clear_telemetry()


def test_plan_only_engine_serves_the_store_tokens(cuda, tmp_path):
    """An artifact of the store-served engine's plan serves the same greedy
    tokens with no store installed, every GEMM on the plan tier."""
    import numpy as np

    from repro_torch.core.search import enumerate_legal
    from repro_torch.core.space import GEMM_SPACE, gemm_fits
    from repro_torch.kernels import dispatch
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb import plans
    from repro_torch.tunedb import store as tstore
    from repro_torch.tunedb.telemetry import clear_telemetry

    cfg, params = _smoke_engine_params(cuda, splits=1)
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    db = tmp_path / "db.jsonl"
    store = tstore.RecordStore(db)
    rng = np.random.default_rng(2)
    lens = (6, 11)
    for M in lens + (2,):
        for N, K in ((q, cfg.d_model), (kv, cfg.d_model),
                     (cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.d_ff)):
            x = gemm_input(M, N, K, 32)
            legal = [c for c in enumerate_legal(GEMM_SPACE, x)
                     if gemm_fits(c, 32)]
            store.add(tstore.TuneRecord(
                space="gemm", inputs=x,
                config=legal[int(rng.integers(len(legal)))], tflops=1.0,
                backend="card-test"))
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    clear_telemetry()

    def serve(**kw):
        eng = Engine(cfg, params, ServeConfig(
            max_len=32, slots=2, tunedb_models="",
            tunedb_backend="card-test", **kw), device=cuda)
        dispatch.reset_counts()
        out = eng.generate(prompts, max_new=5)
        assert {t for (sp, t) in dispatch.tier_counts
                if sp == "gemm"} == {"plan"}
        return eng, out

    try:
        eng, stored = serve(tunedb=str(db))
        dest = plans.export_plan(tstore.serving_state().plan,
                                 plans.default_plan_dir(db),
                                 store=eng.tunedb_store)
        _, planned = serve(plan_dir=str(dest))
        assert tstore.serving_state().store is None
        assert tstore.serving_state().plan.source == "loaded"
        assert planned == stored
    finally:
        tstore.install_serving(store=None, models=None, fingerprint=None)


MOE_ARCHS = ("arctic-480b", "dbrx-132b", "jamba-v0.1-52b")


def _moe_engine(cuda, arch, dtype=torch.float32, **kw):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    return Engine(cfg, params, ServeConfig(max_len=64, slots=3, **kw),
                  device=cuda)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_graph_tokens_equal_the_eager_engine(cuda, arch):
    """Each MoE SMOKE config in fp32, served from the engine's CUDA graphs
    (the capacity path in every prefill of more than one token, the decode
    path in a tick and in the 1-token prompt's prefill), gives the eager
    prefill and tick's greedy tokens."""
    import numpy as np

    from repro_torch.tunedb.store import clear_store

    clear_store()
    rng = np.random.default_rng(5)
    eng = _moe_engine(cuda, arch)
    prompts = [rng.integers(0, eng.cfg.vocab, n) for n in (6, 40, 1, 11, 9)]
    graph = eng.generate(prompts, max_new=6)
    assert eng.captures == 1 and eng.replays == eng.ticks > 0
    assert eng.prefill_captures == 5
    eager = _moe_engine(cuda, arch)
    eager.prefill, eager.decode = eager.prefill_eager, eager.decode_eager
    assert eager.generate(prompts, max_new=6) == graph
    assert all(len(o) == 6 for o in graph)


def test_moe_prefill_and_tick_capture(cuda):
    """Capturing the capacity path (a 23-token prefill), the decode path
    in a prefill (1 token) and a tick raises no capture error (no host
    sync: no bincount, one_hot, tensor-valued repeat_interleave or mask
    indexing), and each replay gives its eager run's logits bitwise."""
    import numpy as np

    from repro_torch.tunedb.store import clear_store

    clear_store()
    eng = _moe_engine(cuda, "dbrx-132b")
    rng = np.random.default_rng(6)
    for slot, n in enumerate((23, 1)):
        tokens = torch.as_tensor(rng.integers(0, eng.cfg.vocab, n)[None],
                                 device=cuda)
        graph = eng.prefill_graph(slot, tokens).clone()
        assert torch.equal(graph, eng.prefill_eager(slot, tokens)), n
    assert eng.prefill_captures == 2
    last = torch.tensor([[3], [11], [0]], device=cuda)
    idx = torch.tensor([23, 1, 0], device=cuda)
    logits = eng.decode_graph(last, idx).clone()
    assert eng.captures == 1
    assert torch.equal(logits, eng.decode_eager(last, idx))
    assert torch.isfinite(logits).all()


def test_moe_combine_is_deterministic_in_bf16(cuda):
    """Two eager bf16 prefills of the same prompt give bitwise-equal
    logits (the combine adds a token's k outputs in a fixed order, with
    no atomics), and so do two calls of the capacity path itself."""
    import numpy as np

    from repro_torch.models import moe as TM
    from repro_torch.tunedb.store import clear_store

    clear_store()
    eng = _moe_engine(cuda, "dbrx-132b", dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, eng.cfg.vocab, 48)[None],
                             device=cuda)
    first = eng.prefill_eager(0, tokens).clone()
    assert torch.equal(first, eng.prefill_eager(0, tokens))
    p = {k: v[0] for k, v in eng.params["layers"]["pos0"]["moe"].items()}
    x = torch.randn((2, 64, eng.cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    kw = dict(n_experts=eng.cfg.n_experts, top_k=eng.cfg.top_k)
    a, _ = TM.moe(p, x, **kw)
    b, _ = TM.moe(p, x, **kw)
    assert torch.equal(a, b) and a.dtype == torch.bfloat16


def test_capture_runs_with_the_collector_off(cuda, monkeypatch):
    """The garbage collector is off while a graph is captured (and back on
    after): a dead engine's graphs, freed by a collection mid-capture,
    invalidated a MoE prefill's capture on the card (ROADMAP C10)."""
    import gc

    import numpy as np

    from repro_torch.serve import engine as tengine
    from repro_torch.tunedb.store import clear_store

    clear_store()
    seen = []
    real = tengine.prefill

    def prefill(*args, **kw):
        seen.append(gc.isenabled())
        return real(*args, **kw)

    monkeypatch.setattr(tengine, "prefill", prefill)
    eng = _moe_engine(cuda, "dbrx-132b")
    tokens = torch.as_tensor(
        np.random.default_rng(8).integers(0, eng.cfg.vocab, 12)[None],
        device=cuda)
    eng.prefill_graph(0, tokens)
    assert seen == [True, False] and gc.isenabled()


def _smoke_on(arch, device):
    """An fp32 SMOKE config's parameters, drawn on the CPU from seed 0 and
    copied to ``device``: the card and the CPU run the same numbers."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params, tree_map
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, tree_map(lambda t: t.to(device), params)


def _near(got, want, tol=1e-4):
    """fp32 on the card (the GEMM kernel, another summation order) against
    the CPU's plain versions, relative to the largest |value|."""
    got, want = got.float().cpu(), want.float()
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-6)
    assert err <= tol and torch.isfinite(got).all(), err


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_encdec_and_frontend_on_the_card_match_the_cpu(cuda, arch):
    """whisper-base and internvl2-76b SMOKE in fp32: ``encode``, the
    enc-dec prefill (``encoder_embeds``) or the frontend prefill
    (``patch_embeds``), then 4 decode ticks, on the card as on the CPU."""
    from repro_torch.models import decode_step, encode, init_cache, prefill
    from repro_torch.tunedb.store import clear_store

    clear_store()
    gen = torch.Generator().manual_seed(1)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        cfg, params = _smoke_on(arch, dev)
        n = cfg.encoder_len or cfg.n_frontend_tokens
        embeds = torch.randn((2, n, cfg.d_model), generator=gen.manual_seed(1))
        tokens = torch.randint(0, cfg.vocab, (2, 6),
                               generator=gen.manual_seed(2))
        steps = torch.randint(0, cfg.vocab, (2, 4),
                              generator=gen.manual_seed(3))
        key = "encoder_embeds" if cfg.is_encdec else "patch_embeds"
        cache = init_cache(cfg, 2, 32, dev)
        out = []
        memory = None
        if cfg.is_encdec:
            memory = encode(cfg, params, embeds.to(dev))
            out.append(memory)
        logits, _ = prefill(params, cfg, {"tokens": tokens.to(dev),
                                          key: embeds.to(dev)}, cache)
        out.append(logits)
        pos = 6 + (0 if cfg.is_encdec else cfg.n_frontend_tokens)
        for j in range(4):
            logits, _ = decode_step(params, cfg, steps[:, j:j + 1].to(dev),
                                    cache, pos + j, memory=memory)
            out.append(logits)
        runs[dev.type] = out
    for got, want in zip(runs["cuda"], runs["cpu"]):
        _near(got, want)


def test_whisper_tick_replays_bitwise_from_a_graph(cuda):
    """whisper-base SMOKE's ``decode_step(memory=)`` captured in a CUDA
    graph: its replay gives the eager tick's logits bitwise (the tick has
    no recurrent state; its K/V write is the same at each replay)."""
    import gc

    from repro_torch.models import decode_step, encode, init_cache, prefill
    from repro_torch.tunedb.store import clear_store

    clear_store()
    cfg, params = _smoke_on("whisper-base", cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    frames = torch.randn((3, cfg.encoder_len, cfg.d_model), device=cuda,
                         generator=gen)
    tokens = torch.randint(0, cfg.vocab, (3, 5), device=cuda, generator=gen)
    cache = init_cache(cfg, 3, 32, cuda)
    prefill(params, cfg, {"tokens": tokens, "encoder_embeds": frames}, cache)
    memory = encode(cfg, params, frames)
    last = torch.randint(0, cfg.vocab, (3, 1), device=cuda, generator=gen)
    idx = torch.tensor([5, 5, 5], device=cuda)
    tick = lambda: decode_step(params, cfg, last, cache, idx,
                               memory=memory)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tick()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            static = tick()
    finally:
        gc.enable()
    graph.replay()
    eager = tick()
    torch.cuda.synchronize()
    assert torch.equal(static, eager) and torch.isfinite(eager).all()
    last.fill_(7)
    graph.replay()
    assert torch.equal(static, tick())


@pytest.fixture(scope="module")
def card_tuners():
    """Tiny tuners labelled on the card (64 gated samples a space)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the tuners label on the card")
    from repro_torch.core.space import SPACES
    from repro_torch.core.tuner import InputAwareTuner
    backend = CheckedBackend(CudaEventBackend(device="cuda"))
    return {name: InputAwareTuner.train(SPACES[name], n_samples=64,
                                        hidden=(16, 16), epochs=4,
                                        backend=backend, seed=0)
            for name in ("gemm", "attention")}


def _retune_engine(cuda, card_tuners, **kw):
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb import store as tstore
    from repro_torch.tunedb.telemetry import clear_telemetry

    clear_telemetry()
    tstore.install_serving(store=None, models=None, fingerprint=None)
    cfg, params = _smoke_engine_params(cuda)
    return Engine(cfg, params, ServeConfig(
        max_len=64, slots=3, retune=True, retune_interval=8,
        retune_min_calls=8, retune_top_k=4, **kw), device=cuda,
        retune_tuners=card_tuners)


def test_smoke_engine_retunes_mid_generate_on_the_card(cuda, card_tuners):
    """The SMOKE engine tunes its own untuned shapes on the card mid-
    generate; the tick graph captured under the new generation resolves
    every shape with a record on that record's config."""
    import numpy as np

    from repro_torch.kernels import dispatch as tdispatch
    from repro_torch.tunedb.store import serving_state, shape_key

    eng = _retune_engine(cuda, card_tuners)
    gen0 = serving_state().generation
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, eng.cfg.vocab, n) for n in (5, 9, 3, 12, 7)]
    outs = eng.generate(prompts, max_new=24)
    assert all(len(o) == 24 for o in outs)
    assert eng.controller.retunes >= 1
    assert serving_state().generation > gen0
    store = eng.tunedb_store
    fp = CudaEventBackend(device=cuda).fingerprint
    assert store.records() and all(r.source == "retune" and r.backend == fp
                                   for r in store.records())
    last = torch.zeros((3, 1), dtype=torch.long, device=cuda)
    idx = torch.full((3,), 20, dtype=torch.long, device=cuda)
    eng.decode(last, idx)            # captured under the live generation
    assert eng._graph_gen == serving_state().generation
    plan = serving_state().plan
    tuned = [(sp, x) for sp, x in eng._decode_shapes
             if store.contains(sp, x, backend=fp)]
    assert tuned
    for sp, x in tuned:
        rec = store.get(sp, x, backend=fp)
        assert plan.lookup(sp, shape_key(x)) == (rec.config, "exact")
        assert tdispatch._resolve_cfg(sp, x) == (rec.config, "plan")


def test_async_epoch_overlaps_a_prefill_capture(cuda, card_tuners):
    """A prefill of a new length captured while a background epoch times
    its candidates on the card: both hold DEVICE_LOCK, so the capture is
    never invalidated; the report surfaces on a later poll and every
    request is served whole.  Meanwhile this thread synchronises its
    stream only: the epoch's timer captures graphs on its own thread, and
    a device-wide synchronise is refused during any capture."""
    import numpy as np

    eng = _retune_engine(cuda, card_tuners, retune_async=True)
    ctl = eng.controller
    stream = torch.cuda.current_stream(cuda)
    try:
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, eng.cfg.vocab, n)
                   for n in (5, 9, 3, 12, 7)]
        outs = eng.generate(prompts, max_new=16)
        assert all(len(o) == 16 for o in outs)
        overlapped = False
        for n in (20, 24, 28, 32, 36, 40):
            if not ctl.async_active():
                ctl.wait_async()
                novel = torch.as_tensor(
                    rng.integers(0, eng.cfg.vocab, n + 2)[None], device=cuda)
                for _ in range(4):
                    eng.prefill(0, novel)
                while not ctl.async_active():
                    if ctl.maybe_retune(tick=eng.ticks) is None \
                            and not ctl.async_active():
                        pytest.fail("novel prefill traffic triggered no "
                                    "epoch")
            before, caps = ctl.async_active(), eng.prefill_captures
            eng.prefill(0, torch.as_tensor(
                rng.integers(0, eng.cfg.vocab, n)[None], device=cuda))
            stream.synchronize()
            assert eng.prefill_captures == caps + 1
            if before and ctl.async_active():
                overlapped = True
                break
        assert overlapped
        ctl._async.join(300)
        assert not ctl.async_active()
        report = ctl.maybe_retune(tick=eng.ticks)
        assert report is not None and report.mode == "async" and report.tuned
    finally:
        ctl.wait_async(300)          # no epoch outlives the test


def test_a_flip_during_capture_captures_again(cuda, monkeypatch):
    """A generation that moves between a capture's generation read and the
    replay leaves the graph marked with the old one: the next tick and
    the next prefill of that length capture again."""
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb import store as tstore

    tstore.install_serving(store=None, models=None, fingerprint=None)
    cfg, params = _smoke_engine_params(cuda)
    eng = Engine(cfg, params, ServeConfig(max_len=64, slots=3), device=cuda)
    real = eng._captured

    def flip_while_capturing(*a, **kw):
        got = real(*a, **kw)
        tstore.install_serving(store=tstore.RecordStore())
        return got

    eng._captured = flip_while_capturing
    last = torch.zeros((3, 1), dtype=torch.long, device=cuda)
    idx = torch.full((3,), 5, dtype=torch.long, device=cuda)
    tokens = torch.arange(7, device=cuda)[None]
    eng.decode(last, idx)
    eng.prefill(0, tokens)
    assert (eng.captures, eng.prefill_captures) == (1, 1)
    eng._captured = real
    eng.decode(last, idx)
    eng.prefill(0, tokens)
    assert (eng.captures, eng.prefill_captures) == (2, 2)
    eng.decode(last, idx)
    eng.prefill(0, tokens)
    assert (eng.captures, eng.prefill_captures) == (2, 2)
    assert eng.replays == 3 and eng.prefill_replays == 3


def test_a_retune_epoch_returns_the_memory_it_took(cuda, card_tuners):
    """An inline retune epoch on the card leaves its timer holding no
    operand sets, and the device memory allocated after it within 8 MiB of
    its level before it (the poll that runs it captures nothing)."""
    import numpy as np

    eng = _retune_engine(cuda, card_tuners)
    timers = {id(t.backend.timer): t.backend.timer
              for t in card_tuners.values()}
    epochs = []
    real_poll = eng.maybe_retune

    def poll():
        before = torch.cuda.memory_allocated(cuda)
        report = real_poll()
        if report is not None:
            epochs.append((report.tuned, before,
                           torch.cuda.memory_allocated(cuda),
                           [t._operands for t in timers.values()],
                           [len(t._times) for t in timers.values()]))
        return report

    eng.maybe_retune = poll
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, eng.cfg.vocab, n) for n in (5, 9, 3, 12, 7)]
    outs = eng.generate(prompts, max_new=24)
    assert all(len(o) == 24 for o in outs)
    assert any(tuned for tuned, *_ in epochs)
    for tuned, before, after, operands, times in epochs:
        assert after - before <= 8 << 20, (tuned, before, after)
        assert all(o == ((), []) for o in operands)
        assert times == [0] * len(timers)


def test_status_scrapes_during_a_prefill_capture(cuda):
    """``/status`` and ``/metrics`` scraped from another thread while the
    engine captures a prefill graph (the global capture mode refuses a
    device synchronise from any thread): every scrape answers 200 and the
    capture succeeds."""
    import json
    import threading
    import urllib.request

    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb import store as tstore
    from repro_torch.tunedb.obs import reset_tracing

    tstore.install_serving(store=None, models=None, fingerprint=None)
    cfg, params = _smoke_engine_params(cuda)
    eng = Engine(cfg, params, ServeConfig(max_len=64, slots=3, status_port=0,
                                          trace_sample=1.0), device=cuda)
    url = eng.status_server.url
    codes = []
    real = eng._captured

    def scrape():
        for route in ("/status", "/metrics", "/trace", "/plan"):
            with urllib.request.urlopen(url + route, timeout=60) as r:
                body = r.read()
                codes.append(r.status)
                if route == "/status":
                    assert json.loads(body)["schema"] == 1

    def scraping(fn, **kw):
        def run():
            th = threading.Thread(target=scrape)
            th.start()              # mid-warm-up and mid-capture
            th.join(120)
            assert not th.is_alive()
            return fn()
        return real(run, **kw)

    eng._captured = scraping
    try:
        tokens = torch.arange(7, device=cuda)[None]
        logits = eng.prefill(0, tokens)
        torch.cuda.current_stream(cuda).synchronize()
        assert eng.prefill_captures == 1
        assert bool(torch.isfinite(logits).all())
        assert codes == [200] * 8           # the warm-up's and the capture's
    finally:
        eng.status_server.stop()
        reset_tracing()


def test_worker_process_tunes_while_an_engine_replays(cuda, card_tuners,
                                                      tmp_path):
    """A ``fleet worker`` process (the GEMM tuner loaded from disk) tunes
    one of the SMOKE engine's decode GEMM shapes on the card while this
    process's engine replays its graphs; the coordinator merges the shard
    as it lands, and the merged record, installed, serves the shape from
    the plan on an entry compiled from it (tier exact)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import numpy as np

    from repro_torch.kernels import dispatch as tdispatch
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb import fleet as tfleet
    from repro_torch.tunedb import store as tstore

    tstore.install_serving(store=None, models=None, fingerprint=None)
    cfg, params = _smoke_engine_params(cuda)
    eng = Engine(cfg, params, ServeConfig(max_len=64, slots=3), device=cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3)]
    eng.generate(prompts, max_new=8)
    x = next(x for sp, x in eng._decode_shapes if sp == "gemm")
    tuners = tmp_path / "tuners"
    card_tuners["gemm"].save(str(tuners))
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=x)])
    coord.fleet.request_drain()
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tunedb", "fleet", "worker",
         "--fleet", str(tmp_path / "fleet"), "--load-tuner", str(tuners)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    replays = eng.replays
    try:
        while proc.poll() is None:       # the engine serves meanwhile
            eng.generate(prompts, max_new=8)
            coord.poll()
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "1 tuned" in out and eng.replays > replays
    coord.poll()
    fp = CudaEventBackend(device=cuda).fingerprint
    rec = store.get("gemm", x, backend=fp)
    assert rec is not None and rec.merged_from and rec.source == "fleet"
    tstore.install_serving(store=store, fingerprint=fp)
    plan = tstore.serving_state().plan
    assert plan.lookup("gemm", tstore.shape_key(x)) == (rec.config, "exact")
    assert tdispatch._resolve_cfg("gemm", x) == (rec.config, "plan")
    tstore.install_serving(store=None, models=None, fingerprint=None)


def test_follower_install_during_a_prefill_capture(cuda, tmp_path):
    """A plan follower's install lands (on another thread) while the
    engine captures a prefill graph: the capture succeeds, the graph is
    captured again at its length's next use under the new generation, and
    the greedy tokens equal those of the same engine's run without it (the
    plan covers none of the engine's shapes, so its configs stay)."""
    import threading

    import numpy as np

    from repro_torch.core.space import gemm_input
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb import plans as tplans
    from repro_torch.tunedb import store as tstore

    tstore.install_serving(store=None, models=None, fingerprint=None)
    cfg, params = _smoke_engine_params(cuda)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 5, 3)]
    want = Engine(cfg, params, ServeConfig(max_len=64, slots=3),
                  device=cuda).generate(prompts, max_new=8)
    reg = tplans.PlanRegistry(tmp_path / "reg")
    other = gemm_input(999, 64, 64, 32)
    reg.publish(tstore.DispatchPlan(
        generation=0, fingerprint=None, store_version=-1,
        table={("gemm", tstore.shape_key(other)): (
            {"bm": 64, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 1,
             "order": 0, "acc32": 1, "prefetch": 1}, "exact")}))
    follower = tplans.PlanFollower(reg, name="capture-test")
    eng = Engine(cfg, params, ServeConfig(max_len=64, slots=3), device=cuda)
    real = eng._captured
    landed = []

    def captured(fn, pool=None, keep=()):
        calls = [0]

        def run():
            calls[0] += 1
            if pool is not None and calls[0] == 2 and not landed:
                # inside the capture: the install on another thread
                t = threading.Thread(target=lambda: landed.append(
                    (tstore.serving_state().generation,
                     follower.poll_once())))
                t.start()
                t.join(60)
            return fn()
        return real(run, pool=pool, keep=keep)

    eng._captured = captured
    try:
        got = eng.generate(prompts, max_new=8)
        torch.cuda.current_stream(cuda).synchronize()
    finally:
        follower.stop()
    assert landed and landed[0][1] is not None and follower.installs == 1
    assert tstore.serving_state().plan.source == "loaded"
    assert got == want
    # 5 (the install lands), 9, 5 again (captured anew), 3
    assert eng.prefill_captures == 4
    tstore.install_serving(store=None, models=None, fingerprint=None)


def test_kill_point_after_a_card_search_leaves_the_device_usable(
        cuda, card_tuners, tmp_path):
    """A ``KillPoint`` in a worker thread right after its search on the
    card (``worker.tuned``) ends the thread, not the device: the lease is
    left for expiry, no stream is left capturing, and the next engine's
    captures and replays succeed with the tokens of an engine served
    before the kill."""
    import threading

    import numpy as np

    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tunedb import chaos
    from repro_torch.tunedb import fleet as tfleet
    from repro_torch.tunedb import store as tstore

    tstore.install_serving(store=None, models=None, fingerprint=None)
    cfg, params = _smoke_engine_params(cuda)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3)]
    want = Engine(cfg, params, ServeConfig(max_len=64, slots=3),
                  device=cuda).generate(prompts, max_new=8)
    store = tstore.RecordStore.open(tmp_path / "db.jsonl")
    coord = tfleet.Coordinator(tmp_path / "fleet", store,
                               lease_timeout_s=30.0)
    x = gemm_input(4, 64, 64, 16)
    coord.publish([tfleet.FleetJob(space="gemm", inputs=x)])
    worker = tfleet.Worker(tmp_path / "fleet", worker_id="doomed",
                           tuners={"gemm": card_tuners["gemm"]},
                           heartbeat_s=0.1)
    died = []

    def run():
        try:
            worker.run_one()
        except chaos.KillPoint as e:
            died.append(e.site)

    plan = chaos.FaultPlan(seed=0, rules=[chaos.FaultRule(
        site="worker.tuned", kind="kill", p=1.0, max_count=1)])
    with chaos.armed(plan):
        t = threading.Thread(target=run)
        t.start()
        t.join(300)
    assert not t.is_alive() and died == ["worker.tuned"]
    assert coord.fleet.counts() == {"queue": 0, "leases": 1, "done": 0,
                                    "failed": 0}
    assert not torch.cuda.is_current_stream_capturing()
    torch.cuda.synchronize()
    eng = Engine(cfg, params, ServeConfig(max_len=64, slots=3), device=cuda)
    got = eng.generate(prompts, max_new=8)
    torch.cuda.synchronize()
    assert got == want
    assert eng.captures >= 1 and eng.replays > 0
    tstore.install_serving(store=None, models=None, fingerprint=None)


# (M, N, K) of a SmolLM-135M training step at 8 x 512 tokens: the forward
# projections, dA = dC·Bᵀ and dB = Aᵀ·dC
TRAIN_SHAPES = [(4096, 576, 576), (4096, 192, 576), (4096, 1536, 576),
                (4096, 576, 1536), (4096, 576, 192), (576, 576, 4096),
                (576, 192, 4096), (576, 1536, 4096), (1536, 576, 4096)]
SPLIT_CFG = {"bm": 64, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 4,
             "order": 0, "acc32": 1, "prefetch": 2}


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_tuned_gemm_function_and_grads_match_plain(cuda, shape, split,
                                                   monkeypatch):
    """``dispatch.matmul`` under autograd: its output and both grads (two
    more GEMMs on the kernel) against the plain version on the card, at
    the training step's shapes, under the ops default and a split-K
    config."""
    from repro_torch.kernels import dispatch as tdispatch
    cfg = SPLIT_CFG if split else dict(tops.DEFAULT_GEMM)
    monkeypatch.setattr(tdispatch, "_tuned_cfg", lambda s, x: cfg)
    M, N, K = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(M + 3 * N + 7 * K)
    a = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    b = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5
         ).bfloat16()
    dc = torch.randn((M, N), generator=gen, device=cuda).bfloat16()
    got = []
    for plain in (False, True):
        ta, tb = (t.clone().requires_grad_(True) for t in (a, b))
        l0, r0 = kmatmul.launches, kmatmul.reduce_launches
        if plain:
            monkeypatch.setattr(kmatmul, "gemm", kmatmul.matmul_plain)
            monkeypatch.setattr(kmatmul, "splitk_reduce",
                                kmatmul.splitk_reduce_plain)
        out = tdispatch.matmul(ta, tb)
        da, db = torch.autograd.grad(out, (ta, tb), dc)
        torch.cuda.synchronize()
        if not plain:
            assert isinstance(out.grad_fn,
                              tdispatch._TunedGemm._backward_cls)
            assert kmatmul.launches == l0 + 3
            assert (kmatmul.reduce_launches > r0) == split
        got.append((out.detach(), da, db))
    for k, p in zip(*got):
        err = (k.float() - p.float()).abs().max() / p.float().abs().max()
        assert float(err) <= 2e-2


def test_smoke_train_step_runs_the_kernels(cuda, monkeypatch):
    """One SmolLM SMOKE train step on the card: every GEMM of the forward,
    its recompute and both gradients is a kernel launch, and neither plain
    version is ever called."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import init_train_state

    def boom(*a, **k):
        raise AssertionError("plain GEMM version called on the card")
    monkeypatch.setattr(kmatmul, "matmul_plain", boom)
    monkeypatch.setattr(kmatmul, "splitk_reduce_plain", boom)
    cfg = smoke_config("smollm-135m")
    tr = Trainer(cfg, AdamWConfig(), TrainConfig(steps=1),
                 DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4),
                 device=cuda)
    state = init_train_state(cfg, AdamWConfig(), TrainConfig(), cuda)
    l0 = kmatmul.launches
    state, m = tr.step_fn(state, tr.batch(0))
    torch.cuda.synchronize()
    assert kmatmul.launches - l0 == 4 * 7 * cfg.n_layers
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


def test_trainer_defaults_to_the_card(cuda):
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    cfg = smoke_config("smollm-135m")
    tr = Trainer(cfg, AdamWConfig(), TrainConfig(steps=1),
                 DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    assert tr.device.type == "cuda"
    assert tr.batch(0)["tokens"].device.type == "cuda"
