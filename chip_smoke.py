#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits non-zero:

  1. device     the card's name and ``nvidia-smi`` name / power limit
  2. build      every CUDA kernel (gemm.cu, conv.cu, attention.cu, ssd.cu)
                from ``csrc/``, one nvcc per source, in parallel
  3. gemm       the GEMM kernel against its plain version (and the fp32
                oracle) at the serving path's shapes, several configs
  4. conv       the conv kernel against its plain version (and the fp32
                oracle) at the paper's 14 Table 5 shapes, full size
  5. attention  the attention kernel against its plain version and the fp32
                oracle, bf16 and fp32, several configs: SmolLM-135M and
                qwen3-14b decode steps (causal with q_offset), causal
                prefills with GQA groups 3 and 5, the three ragged
                non-causal shapes the reference's offset trick got wrong
  6. ssd        the SSD kernel against its plain version and the sequential
                fp32 oracle, bf16 and fp32, several configs, a ragged L
  7. tune       the offline loop on the card for all four spaces: fit the
                sampler, label a dataset with CheckedBackend(CudaEventBackend)
                (the gate, then the kernels timed), train the MLP, run a
                TuningSession with top-k re-measurement into a record store
                (GEMM: the 8 SmolLM-135M projection shapes; conv: the 14
                Table 5 shapes; attention: SmolLM-135M decode and prefill,
                qwen3-14b prefill and decode; SSD: a mamba2-1.3b and a
                jamba-v0.1 layer), then serve every tuned shape through
                ``dispatch`` from it; every job must succeed, every call
                resolve exact and agree with the fp32 oracle at full size
  8. times      per shape: the tuned config's kernel time, the heuristic's
                (GEMM, conv) or the ops default's (attention, SSD), the
                plain version, the library call the port never makes
                (``torch.matmul``; ``F.conv2d`` channels-last on cuDNN;
                SDPA) and the bound max(bytes/HBM, FLOPs/peak)
  9. serve      SmolLM-135M at full width (30 layers, bf16, random weights
                from a seed) through ``Engine.generate`` from the tuned store;
                every projection launches the GEMM kernel on the exact tier,
                every decode tick takes its KV split count from the tuned
                attention record (exact tier)
 10. model      prefill + 4 decode steps through the kernel path and again
                through the plain path on the card; logits must agree
 11. profile    a decode tick: eager wall time, host enqueue time, and the
                device time of the same tick replayed from a CUDA graph
 12. kernels    one JSON line summarising every ported kernel

Each path (tune, serve) runs with every launch count set to 0 just before
it and read just after; a kernel of the path that never launched fails.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU (or outside a checkout of the repo) it exits non-zero and
prints no result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backend import (CheckedBackend, CudaEventBackend,  # noqa: E402
                                      problem_flops)
from repro_torch.core.dataset import Dataset  # noqa: E402
from repro_torch.core.features import Featurizer  # noqa: E402
from repro_torch.core.generative import CategoricalSampler  # noqa: E402
from repro_torch.core.heuristics import VendorHeuristicLibrary  # noqa: E402
from repro_torch.core.mlp import MLP  # noqa: E402
from repro_torch.core.space import (ATTENTION_SPACE, CONV_SPACE,  # noqa: E402
                                    GEMM_SPACE, SSD_SPACE, ConfigRejected,
                                    attention_input, conv_input, gemm_input,
                                    ssd_input)
from repro_torch.core.tuner import InputAwareTuner  # noqa: E402
from repro_torch.kernels import _build, dispatch, ops  # noqa: E402
from repro_torch.kernels import attention as kattention  # noqa: E402
from repro_torch.kernels import conv as kconv  # noqa: E402
from repro_torch.kernels import matmul as kmatmul  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.kernels.ref import (attention_ref, conv2d_ref,  # noqa: E402
                                     matmul_ref, ssd_ref)
from repro_torch.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.flash_decode import resolve_decode_splits  # noqa: E402
from repro_torch.tunedb.session import TuningSession  # noqa: E402
from repro_torch.tunedb.store import RecordStore, clear_store, install_store  # noqa: E402

# (N, K) of the serving path's projections and their count per layer:
# q and o (576x576), k and v (576->192), gate and up (576->1536), down
SLICE_NK = {(576, 576): 2, (192, 576): 2, (1536, 576): 2, (576, 1536): 1}
SLICE_M = (4, 32)                  # decode (4 slots) and prefill (32 tokens)
GEMMS_PER_LAYER = sum(SLICE_NK.values())
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LOGIT_TOL = 3e-2

CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_GEMM),
    "k_split=2": {"bm": 32, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 2,
                  "order": 0, "acc32": 1, "prefetch": 3},
    "k_split=4": {"bm": 16, "bn": 64, "bk": 128, "k_unroll": 1, "k_split": 4,
                  "order": 0, "acc32": 1, "prefetch": 2},
    "acc32=0,k_unroll=2": {"bm": 32, "bn": 128, "bk": 128, "k_unroll": 2,
                           "k_split": 1, "order": 0, "acc32": 0,
                           "prefetch": 2},
    "order=1": {"bm": 64, "bn": 32, "bk": 64, "k_unroll": 4, "k_split": 2,
                "order": 1, "acc32": 1, "prefetch": 1},
}

# the paper's Table 5 (DeepBench): (N, P(H), Q(W), K, C, R, S, name)
TABLE5 = [
    (16, 79, 341, 32, 1, 5, 20, "Conv1-DeepSpeech"),
    (16, 38, 166, 32, 32, 5, 10, "Conv2-DeepSpeech"),
    (16, 24, 240, 32, 16, 3, 3, "Conv3-OCR"),
    (16, 12, 120, 64, 32, 3, 3, "Conv4-OCR"),
    (8, 54, 54, 64, 64, 3, 3, "Conv5-Face"),
    (8, 27, 27, 128, 128, 3, 3, "Conv6-Face"),
    (16, 14, 14, 48, 512, 5, 5, "Conv7-Face"),
    (16, 7, 7, 128, 832, 5, 5, "Conv8-Face"),
    (8, 112, 112, 128, 64, 3, 3, "Conv9-Vision"),
    (8, 56, 56, 256, 128, 3, 3, "Conv10-Vision"),
    (16, 128, 39, 174, 64, 5, 5, "Conv11-Speaker"),
    (16, 256, 19, 87, 128, 5, 5, "Conv12-Speaker"),
    (16, 7, 7, 512, 512, 3, 3, "Conv13-ResNET"),
    (16, 7, 7, 2048, 1024, 1, 1, "Conv14-ResNET"),
]
CONV_SHAPES = [conv_input(n, h, w, c, k, r, s) for n, h, w, k, c, r, s, _
               in TABLE5]

CONV_CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_CONV),
    "c_split=2,acc32=0,rs_unroll=4": {
        "b_npq": 128, "b_k": 32, "b_c": 8, "rs_unroll": 4, "c_split": 2,
        "order": 1, "acc32": 0, "prefetch": 3},
    "c_split=4,b_k=128": {
        "b_npq": 16, "b_k": 128, "b_c": 64, "rs_unroll": 2, "c_split": 4,
        "order": 0, "acc32": 1, "prefetch": 1},
    "c_split=8,acc32=0": {
        "b_npq": 32, "b_k": 64, "b_c": 16, "rs_unroll": 1, "c_split": 8,
        "order": 1, "acc32": 0, "prefetch": 2},
}
# fp32 cases: the default config at these Table 5 shapes
CONV_FP32 = ("Conv1-DeepSpeech", "Conv7-Face", "Conv11-Speaker",
             "Conv14-ResNET")

# attention: (name, (B, Hq, Hkv, Lq, Lkv, D), causal, q_offset) checked
# against the plain version and the oracle
ATTN_CHECKS = [
    ("smollm-135m decode", (4, 9, 3, 1, 256, 64), True, 255),
    ("qwen3-14b decode", (8, 40, 8, 1, 32768, 128), True, 32767),
    ("causal prefill, GQA 3", (1, 9, 3, 2048, 2048, 64), True, 0),
    ("causal prefill, GQA 5", (1, 40, 8, 1024, 1024, 128), True, 0),
    ("C1 Lq=4 Lkv=100", (1, 4, 2, 4, 100, 64), False, 0),
    ("C1 Lq=8 Lkv=200", (1, 4, 2, 8, 200, 64), False, 0),
    ("C1 Lq=130 Lkv=100", (1, 4, 2, 130, 100, 64), False, 0),
]
ATTN_CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_ATTN),
    "b_q=16,b_kv=128,prefetch=3": {"b_q": 16, "b_kv": 128, "acc32": 1,
                                   "prefetch": 3},
    "b_q=128,b_kv=16,prefetch=1": {"b_q": 128, "b_kv": 16, "acc32": 1,
                                   "prefetch": 1},
    "b_q=32,b_kv=32,acc32=0": {"b_q": 32, "b_kv": 32, "acc32": 0,
                               "prefetch": 2},
}
# SSD: (name, (B, L, H, P, S))
SSD_CHECKS = [
    ("mamba2-1.3b layer", (1, 2048, 64, 64, 128)),
    ("ragged L=1000", (2, 1000, 8, 64, 128)),
    ("jamba-v0.1 layer, L=1024", (1, 1024, 128, 64, 128)),
]
SSD_CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_SSD),
    "chunk=256,prefetch=1": {"chunk": 256, "b_heads": 1, "acc32": 1,
                             "prefetch": 1},
    "chunk=16,b_heads=4,prefetch=3": {"chunk": 16, "b_heads": 4, "acc32": 1,
                                      "prefetch": 3},
    "chunk=128,b_heads=2,acc32=0": {"chunk": 128, "b_heads": 2, "acc32": 0,
                                    "prefetch": 1},
}
# the fp32 oracle's tolerance in fp32 (tests/test_kernels.py's)
ORACLE_TOL_FP32 = {"attention": 2e-3, "ssd": 1e-3}

# tune targets, bf16; an attention target's q_offset for its dispatch check
ATTN_TARGETS = [
    ("smollm-135m decode", attention_input(4, 9, 3, 1, 256, 64), 255),
    ("smollm-135m prefill 2048", attention_input(1, 9, 3, 2048, 2048, 64), 0),
    ("qwen3-14b prefill 4096", attention_input(1, 40, 8, 4096, 4096, 128), 0),
    ("qwen3-14b decode 32768", attention_input(8, 40, 8, 1, 32768, 128),
     32767),
]
SSD_TARGETS = [
    ("mamba2-1.3b layer", ssd_input(1, 2048, 64, 64, 128)),
    ("jamba-v0.1 mamba layer", ssd_input(1, 4096, 128, 64, 128)),
]

# the tune phase: dataset size per space, regressor, top-k re-measured
TUNE_SAMPLES = {"gemm": 320, "conv": 192, "attention": 96, "ssd": 64}
TUNE_HIDDEN = (64, 128, 64)
TUNE_EPOCHS = 60
TUNE_BATCH = 32
TUNE_TOP_K = 6

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s per IO dtype
H100_SXM = {"hbm": 3.35e12, torch.bfloat16: 989e12, torch.float32: 67e12}

L2_BYTES = 50 * 1024 * 1024


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_peaks(name: str) -> dict:
    """The peaks ``bound_ms`` divides by; only the H100 SXM's are known."""
    if "H100" not in name or not ("HBM3" in name or "SXM" in name):
        raise RuntimeError(f"no peak rates for {name!r}: bound_ms is "
                           "computed for an H100 SXM only")
    return H100_SXM


@contextlib.contextmanager
def plain_kernels():
    """Send ``ops.matmul`` / ``ops.conv2d`` / ``ops.flash_attention`` /
    ``ops.ssd_scan`` through the kernels' plain versions, on the card,
    under the same configs: the reference the kernel paths are held to.
    The port itself has no switch for this; only the checks and timings
    here make it."""
    saved = (kmatmul.gemm, kconv.conv, kattention.attention, kssd.ssd)
    kmatmul.gemm, kconv.conv = kmatmul.matmul_plain, kconv.conv2d_plain
    kattention.attention, kssd.ssd = kattention.attention_plain, kssd.ssd_plain
    try:
        yield
    finally:
        kmatmul.gemm, kconv.conv, kattention.attention, kssd.ssd = saved


def reset_launches() -> None:
    kmatmul.launches = kconv.launches = 0
    kattention.launches = kssd.launches = 0


def read_launches() -> dict:
    return {"gemm": kmatmul.launches, "conv": kconv.launches,
            "attention": kattention.launches, "ssd": kssd.launches}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    g, w = got.float(), want.float()
    abs_err = float((g - w).abs().max())
    return abs_err, abs_err / max(float(w.abs().max()), 1e-6)


def time_ms(fn, n_calls: int, reps: int = 5) -> float:
    """Median device time of one ``fn(i)`` call: ``n_calls`` calls captured
    in a CUDA graph (no host launch cost between them), replayed ``reps``
    times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_calls)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n_calls)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: torch.dtype, peaks: dict
          ) -> dict:
    """The least time the card could take: each input read once and the
    output written once at the HBM rate, or the FLOPs at the dtype's peak,
    whichever is larger."""
    t_bytes = nbytes / peaks["hbm"]
    t_ops = flops / peaks[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "t_bytes": t_bytes, "t_ops": t_ops}


def gemm_bound(M: int, N: int, K: int, dtype: torch.dtype, peaks: dict
               ) -> dict:
    bpe = torch.finfo(dtype).bits // 8
    return bound((M * K + K * N + M * N) * bpe, 2.0 * M * N * K, dtype, peaks)


def conv_bound(x: dict, dtype: torch.dtype, peaks: dict) -> dict:
    """Input, filter and output bytes; 2·N·P·Q·K·C·R·S FLOPs."""
    bpe = torch.finfo(dtype).bits // 8
    npq = x["N"] * x["H"] * x["W"]
    nbytes = (npq * x["C"] + x["R"] * x["S"] * x["C"] * x["K"]
              + npq * x["K"]) * bpe
    return bound(nbytes, 2.0 * npq * x["K"] * x["C"] * x["R"] * x["S"],
                 dtype, peaks)


def attention_bound(x: dict, dtype: torch.dtype, peaks: dict) -> dict:
    """q, k, v read once and the output written once; the FLOPs of the
    tuner's count (4·B·Hq·Lq·Lkv·D, halved for a causal square)."""
    bpe = torch.finfo(dtype).bits // 8
    qo = 2 * x["B"] * x["Hq"] * x["Lq"] * x["D"]
    kv = 2 * x["B"] * x["Hkv"] * x["Lkv"] * x["D"]
    return bound((qo + kv) * bpe, problem_flops("attention", x), dtype, peaks)


def ssd_bound(x: dict, dtype: torch.dtype, peaks: dict) -> dict:
    """x, dt, B, C (and fp32 a) read once, y written once; 4·B·L·H·P·S
    FLOPs, the least any form of the scan does: every step and head adds
    its x·Bᵀ (P·S multiply-adds) into a P x S state and reads y from one
    (C·state, P·S more).  The recurrence does 5·P·S a step and head, the
    chunked form 4·P·S plus its intra-chunk terms.  Not the tuner's
    ``problem_flops``, which counts the chunked form at chunk min(256, L)
    with C·Bᵀ once per head: a yardstick, not the least work."""
    bpe = torch.finfo(dtype).bits // 8
    bl = x["B"] * x["L"]
    nbytes = (2 * bl * x["H"] * x["P"] + bl * x["H"] + 2 * bl * x["S"]) * bpe \
        + 4 * x["H"]
    return bound(nbytes, 4.0 * bl * x["H"] * x["P"] * x["S"], dtype, peaks)


def attention_operands(x: dict, dtype: torch.dtype, gen: torch.Generator,
                       dev: torch.device) -> tuple:
    q = torch.randn((x["B"], x["Hq"], x["Lq"], x["D"]), generator=gen,
                    device=dev).to(dtype)
    kv = [torch.randn((x["B"], x["Hkv"], x["Lkv"], x["D"]), generator=gen,
                      device=dev).to(dtype) for _ in range(2)]
    return (q, *kv)


def ssd_operands(x: dict, dtype: torch.dtype, gen: torch.Generator,
                 dev: torch.device) -> tuple:
    """x, dt in [0.01, 0.1), a in (-2, -0.5] (fp32), B, C."""
    B, L, H, P, S = (x[k] for k in ("B", "L", "H", "P", "S"))
    xs = torch.randn((B, L, H, P), generator=gen, device=dev).to(dtype)
    dt = (0.01 + 0.09 * torch.rand((B, L, H), generator=gen, device=dev)
          ).to(dtype)
    a = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
    bm, cm = (torch.randn((B, L, S), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    return xs, dt, a, bm, cm


def conv_dims(x: dict) -> tuple:
    return tuple(x[k] for k in ("N", "H", "W", "C", "K", "R", "S"))


def conv_operands(x: dict, dtype: torch.dtype, gen: torch.Generator,
                  dev: torch.device) -> tuple:
    N, H, W, C, K, R, S = conv_dims(x)
    i = torch.randn((N, H, W, C), generator=gen, device=dev).to(dtype)
    f = (torch.randn((R, S, C, K), generator=gen, device=dev)
         / (R * S * C) ** 0.5).to(dtype)
    return i, f


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("device", f"{name}; count {torch.cuda.device_count()}")
    print(smi, flush=True)
    return name, smi


KERNELS = ("gemm", "conv", "attention", "ssd")


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    phase("build", f"nvcc sm_90a, {' + '.join(k + '.cu' for k in KERNELS)} "
          f"in parallel, {time.perf_counter() - t0:.1f} s")


def phase_gemm_check(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {"abs": 0.0, "rel": 0.0}
    shapes = [(M, N, K) for M in SLICE_M for (N, K) in SLICE_NK]
    shapes.append((5, 100, 300))       # ragged, unaligned: element loads
    n = 0
    for M, N, K in shapes:
        for cname, cfg in CHECK_CONFIGS.items():
            for dtype in (torch.bfloat16, torch.float32):
                if dtype == torch.float32 and not cfg["acc32"]:
                    continue
                a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
                b = (torch.randn((K, N), generator=gen, device=dev)
                     / K ** 0.5).to(dtype)
                small = ops.shrink_gemm_cfg(cfg, M, N, K)
                got = kmatmul.gemm(a, b, small)
                want = kmatmul.matmul_plain(a, b, small)
                torch.cuda.synchronize()
                ea, er = rel_err(got, want)
                if not (er <= TOL[dtype] and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"gemm kernel vs plain: rel err {er:.3e} > "
                        f"{TOL[dtype]} at M={M} N={N} K={K} {dtype} {cname}")
                worst["abs"] = max(worst["abs"], ea)
                worst["rel"] = max(worst["rel"], er)
                _, er_ref = rel_err(ops.matmul(a, b, cfg), matmul_ref(a, b))
                if er_ref > TOL[dtype]:
                    raise AssertionError(
                        f"gemm vs matmul_ref: rel err {er_ref:.3e} at "
                        f"M={M} N={N} K={K} {dtype} {cname}")
                n += 1
    phase("gemm", f"{n} kernel-vs-plain checks passed; max abs err "
          f"{worst['abs']:.3e}, max rel err {worst['rel']:.3e} "
          f"(tolerance bf16 {TOL[torch.bfloat16]}, fp32 "
          f"{TOL[torch.float32]})")
    return worst


def phase_conv_check(dev: torch.device) -> dict:
    """Kernel partials against the plain version's, every config at every
    Table 5 shape in bf16 (and the default config in fp32 at four); the
    reduced result against the fp32 oracle where the config accumulates in
    fp32.  acc32=0 rounds the running sum after every window, which is the
    plain version's rounding too; its drift from the oracle is printed,
    and the tune phase's gate rejects a config where it passes the bf16
    tolerance."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = {"abs": 0.0, "rel": 0.0, "oracle_rel": 0.0, "acc32_0_rel": 0.0}
    cases = [(x, row[-1], cname, cfg, torch.bfloat16)
             for x, row in zip(CONV_SHAPES, TABLE5)
             for cname, cfg in CONV_CHECK_CONFIGS.items()]
    cases += [(x, row[-1], "default", dict(ops.DEFAULT_CONV), torch.float32)
              for x, row in zip(CONV_SHAPES, TABLE5) if row[-1] in CONV_FP32]
    for x, name, cname, cfg, dtype in cases:
        i, f = conv_operands(x, dtype, gen, dev)
        small = ops.shrink_conv_cfg(cfg, *conv_dims(x))
        got = kconv.conv(i, f, small)
        want = kconv.conv2d_plain(i, f, small)
        torch.cuda.synchronize()
        ea, er = rel_err(got, want)
        if not (er <= TOL[dtype] and torch.isfinite(got).all()):
            raise AssertionError(f"conv kernel vs plain: rel err {er:.3e} > "
                                 f"{TOL[dtype]} at {name} {dtype} {cname}")
        worst["abs"] = max(worst["abs"], ea)
        worst["rel"] = max(worst["rel"], er)
        _, er_ref = rel_err(ops.conv2d(i, f, cfg), conv2d_ref(i, f))
        if not small["acc32"]:
            worst["acc32_0_rel"] = max(worst["acc32_0_rel"], er_ref)
        elif er_ref > TOL[dtype]:
            raise AssertionError(f"conv vs conv2d_ref: rel err {er_ref:.3e} "
                                 f"at {name} {dtype} {cname}")
        else:
            worst["oracle_rel"] = max(worst["oracle_rel"], er_ref)
        del i, f, got, want
    phase("conv", f"{len(cases)} kernel-vs-plain checks over the 14 Table 5 "
          f"shapes passed; max abs err {worst['abs']:.3e}, max rel err "
          f"{worst['rel']:.3e}; acc32=1 cases vs the fp32 oracle max rel "
          f"err {worst['oracle_rel']:.3e}; acc32=0 cases' drift from the "
          f"oracle (not held) max rel err {worst['acc32_0_rel']:.3e} "
          f"(tolerance bf16 "
          f"{TOL[torch.bfloat16]}, fp32 {TOL[torch.float32]})")
    return worst


def phase_attention_check(dev: torch.device) -> dict:
    """The attention kernel against its plain version (same config, same
    block walk and rounding) and the fp32 oracle, every config at every
    shape in bf16, the acc32=1 configs in fp32 too.  The three C1 shapes
    are non-causal with a KV length no block size divides."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    worst = {"abs": 0.0, "rel": 0.0, "oracle_rel": 0.0}
    n = 0
    for name, (B, Hq, Hkv, Lq, Lkv, D), causal, off in ATTN_CHECKS:
        x = attention_input(B, Hq, Hkv, Lq, Lkv, D)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_operands(x, dtype, gen, dev)
            oracle = dispatch._attention_oracle(q, k, v, causal) if off == 0 \
                else attention_ref(q, k, v, causal=causal, q_offset=off)
            for cname, cfg in ATTN_CHECK_CONFIGS.items():
                if dtype == torch.float32 and not cfg["acc32"]:
                    continue
                bits = torch.finfo(dtype).bits
                small = ops.shrink_attention_cfg(cfg, Lq, Lkv, D, bits)
                got = kattention.attention(q, k, v, small, causal=causal,
                                           q_offset=off)
                want = kattention.attention_plain(q, k, v, small,
                                                  causal=causal, q_offset=off)
                torch.cuda.synchronize()
                ea, er = rel_err(got, want)
                _, eo = rel_err(got, oracle)
                tol_o = TOL[torch.bfloat16] if dtype == torch.bfloat16 \
                    else ORACLE_TOL_FP32["attention"]
                if not (er <= TOL[dtype] and eo <= tol_o
                        and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"attention kernel at {name} {dtype} {cname}: rel err "
                        f"{er:.3e} vs plain (tol {TOL[dtype]}), {eo:.3e} vs "
                        f"the fp32 oracle (tol {tol_o})")
                worst = {"abs": max(worst["abs"], ea),
                         "rel": max(worst["rel"], er),
                         "oracle_rel": max(worst["oracle_rel"], eo)}
                n += 1
                del got, want
            del q, k, v, oracle
    phase("attention", f"{n} kernel-vs-plain and kernel-vs-oracle checks "
          f"passed over {len(ATTN_CHECKS)} shapes (decode with q_offset, "
          f"causal prefill with GQA 3 and 5, the C1 shapes); max abs err "
          f"{worst['abs']:.3e}, max rel err {worst['rel']:.3e} vs plain; max "
          f"rel err {worst['oracle_rel']:.3e} vs the fp32 oracle (tolerance "
          f"bf16 {TOL[torch.bfloat16]}; fp32 {TOL[torch.float32]} vs plain, "
          f"{ORACLE_TOL_FP32['attention']} vs the oracle)")
    return worst


def phase_ssd_check(dev: torch.device) -> dict:
    """The SSD kernel against its plain version and the sequential fp32
    oracle, every config at every shape in bf16, the acc32=1 ones in fp32."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    worst = {"abs": 0.0, "rel": 0.0, "oracle_rel": 0.0}
    n = 0
    for name, (B, L, H, P, S) in SSD_CHECKS:
        x = ssd_input(B, L, H, P, S)
        for dtype in (torch.bfloat16, torch.float32):
            args = ssd_operands(x, dtype, gen, dev)
            oracle = ssd_ref(*args)
            for cname, cfg in SSD_CHECK_CONFIGS.items():
                if dtype == torch.float32 and not cfg["acc32"]:
                    continue
                small = ops.shrink_ssd_cfg(cfg, L, H, P, S,
                                           torch.finfo(dtype).bits)
                got = kssd.ssd(*args, small)
                want = kssd.ssd_plain(*args, small)
                torch.cuda.synchronize()
                ea, er = rel_err(got, want)
                _, eo = rel_err(got, oracle)
                tol_o = TOL[torch.bfloat16] if dtype == torch.bfloat16 \
                    else ORACLE_TOL_FP32["ssd"]
                if not (er <= TOL[dtype] and eo <= tol_o
                        and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"ssd kernel at {name} {dtype} {cname} ({small}): rel "
                        f"err {er:.3e} vs plain (tol {TOL[dtype]}), {eo:.3e} "
                        f"vs the fp32 oracle (tol {tol_o})")
                worst = {"abs": max(worst["abs"], ea),
                         "rel": max(worst["rel"], er),
                         "oracle_rel": max(worst["oracle_rel"], eo)}
                n += 1
            del args, oracle
    phase("ssd", f"{n} kernel-vs-plain and kernel-vs-oracle checks passed "
          f"over {len(SSD_CHECKS)} shapes (a ragged L included); max abs err "
          f"{worst['abs']:.3e}, max rel err {worst['rel']:.3e} vs plain; max "
          f"rel err {worst['oracle_rel']:.3e} vs the sequential fp32 oracle "
          f"(tolerance bf16 {TOL[torch.bfloat16]}; fp32 {TOL[torch.float32]} "
          f"vs plain, {ORACLE_TOL_FP32['ssd']} vs the oracle)")
    return worst


def neighbours(x: dict, dims: tuple) -> list:
    """``x`` and, for each of ``dims``, ``x`` with that dim halved and
    doubled: the pool the tune phase's dataset is drawn from.  A dim given
    as a tuple of names scales them together (a causal prefill's Lq and
    Lkv)."""
    out = [dict(x)]
    for d in dims:
        names = d if isinstance(d, tuple) else (d,)
        for f in (0.5, 2):
            out.append({**x, **{k: max(1, int(x[k] * f)) for k in names}})
    return out


def tune_space(space, targets: list, dims, backend, store) -> dict:
    """The offline loop for one space, built from the library's public
    pieces: fit the sampler on the target-and-neighbour pool, label a
    dataset on the card, train the regressor, run a tuning session.
    ``dims`` names the dims each target's neighbours vary (or maps a
    target to them)."""
    pool = []
    for x in targets:
        d = dims(x) if callable(dims) else dims
        pool += [y for y in neighbours(x, d) if y not in pool]
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    sampler = CategoricalSampler(space).fit(pool, 2000, rng)
    t1 = time.perf_counter()
    inputs, cfgs, ys = [], [], []
    rejected = 0
    while len(cfgs) < TUNE_SAMPLES[space.name]:
        x = pool[rng.integers(len(pool))]
        cfg = sampler.sample_legal(x, rng)
        if cfg is None:
            continue
        try:
            ys.append(backend.measure(space.name, cfg, x))
        except ConfigRejected:      # the gate's verdict, as generate_dataset
            rejected += 1
            continue
        inputs.append(x)
        cfgs.append(cfg)
    t2 = time.perf_counter()
    train, val = Dataset(space, inputs, cfgs, np.asarray(ys)).split(
        val_frac=0.1, seed=0)
    feat, X, y = train.featurize(Featurizer(space))
    _, Xv, yv = val.featurize(feat)
    model = MLP.create(0, feat.dim, TUNE_HIDDEN)
    hist = model.fit(X, y, epochs=TUNE_EPOCHS, batch_size=TUNE_BATCH,
                     X_val=Xv, y_val=yv)
    t3 = time.perf_counter()
    tuner = InputAwareTuner(space=space, model=model, featurizer=feat,
                            sampler=sampler, backend=backend,
                            top_k=TUNE_TOP_K)
    report = TuningSession(tuner, store, workers=4).run(targets)
    if report.failed or report.tuned != len(targets):
        raise AssertionError(f"tune {space.name}: {report.tuned}/"
                             f"{len(targets)} tuned, {report.failed} failed: "
                             f"{report.errors}")
    out = {"space": space.name, "samples": len(cfgs), "pool": len(pool),
           "rejected": rejected,
           "val_mse": hist[-1], "sampler_s": t1 - t0, "label_s": t2 - t1,
           "train_s": t3 - t2, "session_s": report.wall_s,
           "tuned": report.tuned, "failed": report.failed}
    phase("tune", f"{space.name}: {out['samples']} samples measured on the "
          f"card over {out['pool']} shapes ({rejected} sampled configs "
          f"rejected by the gate), val MSE {out['val_mse']:.4f} "
          f"(log2 TFLOPS); wall: sampler {out['sampler_s']:.1f} s, label "
          f"{out['label_s']:.1f} s, train {out['train_s']:.1f} s, session "
          f"{out['session_s']:.1f} s; {report.tuned}/{len(targets)} tuned, "
          f"{report.failed} failed")
    for rec in sorted(report.records, key=lambda r: sorted(r.inputs.items())):
        phase("tune", f"  {space.name} {rec.inputs} -> {rec.config} "
              f"{rec.tflops:.3f} TFLOPS, {rec.latency_us:.2f} us")
    return out


def attention_dims(x: dict) -> tuple:
    """Neighbour dims of an attention target: a decode step's batch and
    cache length; a causal prefill's batch and its length (Lq and Lkv
    together, so the neighbour stays a causal square)."""
    return ("B", "Lkv") if x["Lq"] == 1 else ("B", ("Lq", "Lkv"))


def phase_tune(backend, store: RecordStore, fp: str, dev: torch.device
               ) -> dict:
    """The tuning path: all four spaces tuned into ``store``, then every
    tuned shape served through ``dispatch`` from it: each on the exact
    tier, within the bf16 tolerance of the plain version under the same
    config and of the fp32 oracle, at full size."""
    gemm_targets = [gemm_input(M, N, K, 16) for M in SLICE_M
                    for (N, K) in SLICE_NK]
    stats = [tune_space(GEMM_SPACE, gemm_targets, ("M", "N", "K"), backend,
                        store),
             tune_space(CONV_SPACE, CONV_SHAPES, ("N", "H", "W", "C", "K"),
                        backend, store),
             tune_space(ATTENTION_SPACE, [x for _, x, _ in ATTN_TARGETS],
                        attention_dims, backend, store),
             tune_space(SSD_SPACE, [x for _, x in SSD_TARGETS],
                        ("B", "L", "H"), backend, store)]
    install_store(store, fingerprint=fp)
    dispatch.reset_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    bf16 = torch.bfloat16
    # (space, name, shape, operands, q_offset for attention)
    cases = []
    for x in gemm_targets:
        a = torch.randn((x["M"], x["K"]), generator=gen, device=dev)
        b = torch.randn((x["K"], x["N"]), generator=gen, device=dev
                        ) / x["K"] ** 0.5
        cases.append(("gemm", f"M={x['M']} N={x['N']} K={x['K']}", x,
                      (a.bfloat16(), b.bfloat16()), 0))
    for x, row in zip(CONV_SHAPES, TABLE5):
        cases.append(("conv", row[-1], x, conv_operands(x, bf16, gen, dev), 0))
    cases += [("attention", name, x, None, off) for name, x, off in ATTN_TARGETS]
    cases += [("ssd", name, x, None, 0) for name, x in SSD_TARGETS]
    worst = {"plain": 0.0, "oracle": 0.0}
    for space, name, x, args, off in cases:
        cfg = store.get(space, x, backend=fp).config
        if space == "gemm":
            out, want_shape = dispatch.matmul(*args), (x["M"], x["N"])
            with plain_kernels():
                plain = ops.matmul(*args, cfg)
            oracle = matmul_ref(*args)
        elif space == "conv":
            out = dispatch.conv2d(*args)
            want_shape = (x["N"], x["H"], x["W"], x["K"])
            with plain_kernels():
                plain = ops.conv2d(*args, cfg)
            oracle = conv2d_ref(*args)
        elif space == "attention":
            args = attention_operands(x, bf16, gen, dev)
            out = dispatch.flash_attention(*args, causal=True, q_offset=off)
            want_shape = tuple(args[0].shape)
            with plain_kernels():
                plain = ops.flash_attention(*args, cfg, causal=True,
                                            q_offset=off)
            oracle = dispatch._attention_oracle(*args, True, q_offset=off)
        else:
            args = ssd_operands(x, bf16, gen, dev)
            out, want_shape = dispatch.ssd_scan(*args), tuple(args[0].shape)
            with plain_kernels():
                plain = ops.ssd_scan(*args, cfg)
            oracle = ssd_ref(*args)
        torch.cuda.synchronize()
        er = {"plain": rel_err(out, plain)[1], "oracle": rel_err(out, oracle)[1]}
        if tuple(out.shape) != want_shape or max(er.values()) > TOL[
                torch.bfloat16] or not torch.isfinite(out).all():
            raise AssertionError(f"dispatch.{space} at {name} under {cfg}: "
                                 f"shape {tuple(out.shape)}, rel err {er}")
        worst = {k: max(worst[k], er[k]) for k in worst}
        del args, out, plain, oracle
    tiers = dict(dispatch.tier_counts)
    want_tiers = {("gemm", "exact"): len(gemm_targets),
                  ("conv", "exact"): len(CONV_SHAPES),
                  ("attention", "exact"): len(ATTN_TARGETS),
                  ("ssd", "exact"): len(SSD_TARGETS)}
    if tiers != want_tiers:
        raise AssertionError(f"dispatch tiers {tiers}")
    phase("tune", f"dispatch.matmul over the 8 GEMM, dispatch.conv2d over "
          f"the 14 Table 5, dispatch.flash_attention over the "
          f"{len(ATTN_TARGETS)} attention and dispatch.ssd_scan over the "
          f"{len(SSD_TARGETS)} SSD shapes from the tuned store: all exact; "
          f"max rel err {worst['plain']:.3e} vs the plain version under the "
          f"same config, {worst['oracle']:.3e} vs the fp32 oracle (tolerance "
          f"{TOL[torch.bfloat16]})")
    return {"stats": stats}


def phase_times(dev: torch.device, peaks: dict, label: str) -> tuple:
    """Per shape: the tuned config (dispatch's exact tier), the vendor
    heuristic's config, the plain version under the tuned config, the
    library call and the bound."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gemm_lib = VendorHeuristicLibrary.gemm(GEMM_SPACE)
    gemm_rows = []
    for M in SLICE_M:
        for (N, K) in SLICE_NK:
            dtype = torch.bfloat16
            x = gemm_input(M, N, K, 16)
            cfg, tier = dispatch._resolve_cfg("gemm", x)
            heur = gemm_lib.select(x)
            a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            # cycle through enough weight copies that the set exceeds L2:
            # in a decode tick every weight matrix is read cold
            b_bytes = K * N * 2
            n_calls = min(1000, max(20, math.ceil(2.5 * L2_BYTES / b_bytes)))
            bs = [torch.randn((K, N), generator=gen, device=dev).to(dtype)
                  for _ in range(n_calls)]
            kernel = time_ms(lambda i: ops.matmul(a, bs[i], cfg), n_calls)
            heuristic = time_ms(lambda i: ops.matmul(a, bs[i], heur), n_calls)
            with plain_kernels():
                plain = time_ms(lambda i: ops.matmul(a, bs[i], cfg), n_calls)
            library = time_ms(lambda i: torch.matmul(a, bs[i]), n_calls)
            del bs
            gemm_rows.append({"M": M, "N": N, "K": K, "tier": tier,
                              "cfg": cfg, "heuristic_cfg": heur,
                              "kernel_ms": kernel, "heuristic_ms": heuristic,
                              "plain_ms": plain, "library_ms": library,
                              **gemm_bound(M, N, K, dtype, peaks)})
            r = gemm_rows[-1]
            phase("times", f"gemm M={M} N={N} K={K} bf16 tier={tier} "
                  f"tuned {kernel * 1e3:.2f} us, heuristic "
                  f"{heuristic * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
                  f"torch.matmul {library * 1e3:.2f} us, bound "
                  f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) [{label}]")
    conv_lib = VendorHeuristicLibrary.conv(CONV_SPACE)
    conv_rows = []
    for x, row in zip(CONV_SHAPES, TABLE5):
        dtype = torch.bfloat16
        cfg, tier = dispatch._resolve_cfg("conv", x)
        heur = conv_lib.select(x)
        i, f = conv_operands(x, dtype, gen, dev)
        nbytes = (i.numel() + f.numel()) * 2
        n_calls = max(2, min(8, math.ceil(2.5 * L2_BYTES / nbytes)))
        ins = [i] + [torch.randn(i.shape, generator=gen, device=dev
                                 ).to(dtype) for _ in range(n_calls - 1)]
        # the library call: cuDNN on the same NHWC / RSCK data as
        # channels-last views; padding="same" pads as XLA's SAME does
        w_cl = f.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_fn = lambda j: torch.nn.functional.conv2d(
            ins[j].permute(0, 3, 1, 2), w_cl, padding="same")
        _, er = rel_err(lib_fn(0).permute(0, 2, 3, 1), conv2d_ref(i, f))
        if er > TOL[dtype]:
            raise AssertionError(f"F.conv2d disagrees with conv2d_ref at "
                                 f"{row[-1]}: rel err {er:.3e}")
        kernel = time_ms(lambda j: ops.conv2d(ins[j], f, cfg), n_calls)
        heuristic = time_ms(lambda j: ops.conv2d(ins[j], f, heur), n_calls)
        with plain_kernels():
            plain = time_ms(lambda j: ops.conv2d(ins[j], f, cfg), n_calls)
        library = time_ms(lib_fn, n_calls)
        del ins
        conv_rows.append({"name": row[-1], **x, "tier": tier, "cfg": cfg,
                          "heuristic_cfg": heur, "kernel_ms": kernel,
                          "heuristic_ms": heuristic, "plain_ms": plain,
                          "library_ms": library,
                          **conv_bound(x, dtype, peaks)})
        r = conv_rows[-1]
        phase("times", f"conv {row[-1]} {conv_dims(x)} bf16 tier={tier} "
              f"tuned {kernel:.3f} ms, heuristic {heuristic:.3f} ms, plain "
              f"{plain:.3f} ms, F.conv2d {library:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{label}]")
    return gemm_rows, conv_rows


def phase_times_attention_ssd(dev: torch.device, peaks: dict, label: str
                              ) -> tuple:
    """Per attention and SSD target: the tuned config (dispatch's exact
    tier), the ops default config, the plain version under the tuned
    config, SDPA for attention (the PyTorch call the port never makes) and
    the bound.  Operand copies exceed the L2 where one set does not."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bf16 = torch.bfloat16
    attn_rows, ssd_rows = [], []
    for name, x, off in ATTN_TARGETS:
        cfg, tier = dispatch._resolve_cfg("attention", x)
        one = attention_operands(x, bf16, gen, dev)
        nbytes = sum(t.numel() for t in one) * 2
        n_calls = max(1, min(64, math.ceil(2.5 * L2_BYTES / nbytes)))
        sets = [one] + [attention_operands(x, bf16, gen, dev)
                        for _ in range(n_calls - 1)]
        causal = x["Lq"] == x["Lkv"]        # a decode step sees every key
        sdpa = lambda i: torch.nn.functional.scaled_dot_product_attention(
            *sets[i], is_causal=causal, enable_gqa=True)
        _, er = rel_err(sdpa(0), dispatch._attention_oracle(
            *one, True, q_offset=off))
        if er > TOL[bf16]:
            raise AssertionError(f"SDPA disagrees with attention_ref at "
                                 f"{name}: rel err {er:.3e}")
        run = lambda c: (lambda i: ops.flash_attention(
            *sets[i], c, causal=True, q_offset=off))
        kernel = time_ms(run(cfg), n_calls)
        default = time_ms(run(dict(ops.DEFAULT_ATTN)), n_calls)
        with plain_kernels():
            plain = time_ms(run(cfg), min(n_calls, 2))
        library = time_ms(sdpa, n_calls)
        del sets, one
        attn_rows.append({"name": name, **x, "tier": tier, "cfg": cfg,
                          "default_cfg": ops.shrink_attention_cfg(
                              {}, x["Lq"], x["Lkv"], x["D"], 16),
                          "kernel_ms": kernel, "default_ms": default,
                          "plain_ms": plain, "library_ms": library,
                          **attention_bound(x, bf16, peaks)})
        r = attn_rows[-1]
        phase("times", f"attention {name} (B={x['B']} Hq={x['Hq']} "
              f"Hkv={x['Hkv']} Lq={x['Lq']} Lkv={x['Lkv']} D={x['D']}) bf16 "
              f"tier={tier} tuned {cfg} {kernel:.4f} ms, ops default "
              f"{default:.4f} ms, plain {plain:.4f} ms, SDPA {library:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{label}]")
    for name, x in SSD_TARGETS:
        cfg, tier = dispatch._resolve_cfg("ssd", x)
        one = ssd_operands(x, bf16, gen, dev)
        nbytes = sum(t.numel() * t.element_size() for t in one)
        n_calls = max(1, min(16, math.ceil(2.5 * L2_BYTES / nbytes)))
        sets = [one] + [ssd_operands(x, bf16, gen, dev)
                        for _ in range(n_calls - 1)]
        run = lambda c: (lambda i: ops.ssd_scan(*sets[i], c))
        kernel = time_ms(run(cfg), n_calls)
        default = time_ms(run(dict(ops.DEFAULT_SSD)), n_calls)
        with plain_kernels():
            plain = time_ms(run(cfg), min(n_calls, 2))
        del sets, one
        ssd_rows.append({"name": name, **x, "tier": tier, "cfg": cfg,
                         "default_cfg": ops.shrink_ssd_cfg(
                             {}, x["L"], x["H"], x["P"], x["S"], 16),
                         "kernel_ms": kernel, "default_ms": default,
                         "plain_ms": plain, "library_ms": None,
                         **ssd_bound(x, bf16, peaks)})
        r = ssd_rows[-1]
        phase("times", f"ssd {name} (B={x['B']} L={x['L']} H={x['H']} "
              f"P={x['P']} S={x['S']}) bf16 tier={tier} tuned {cfg} "
              f"{kernel:.4f} ms, ops default {default:.4f} ms, plain "
              f"{plain:.4f} ms, no single PyTorch call computes it, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{label}]")
    return attn_rows, ssd_rows


def per_tick(rows: list, key: str, n_layers: int) -> float:
    """``key`` summed over one decode tick's projections (the M=4 shapes,
    each as often as the model calls it)."""
    return sum(r[key] * SLICE_NK[(r["N"], r["K"])] * n_layers
               for r in rows if r["M"] == 4)


def phase_serve(cfg, params, store_path: Path, fp: str, gemm_rows: list,
                label: str) -> dict:
    sc = ServeConfig(max_len=256, slots=4, tunedb=str(store_path),
                     tunedb_backend=fp, record_tick_times=True)
    eng = Engine(cfg, params, sc)
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(0, cfg.vocab, 32) for _ in range(2)],
                 max_new=2)                               # warm-up
    prompts = [rng.integers(0, cfg.vocab, 32) for _ in range(8)]
    ticks0, prefills0 = eng.ticks, eng.prefills
    eng.tick_times.clear()
    torch.cuda.synchronize()
    reset_launches()
    dispatch.reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kmatmul.launches
    tiers, attn_tiers = ({t: c for (s, t), c in dispatch.tier_counts.items()
                          if s == space} for space in ("gemm", "attention"))
    forwards = (eng.ticks - ticks0) + (eng.prefills - prefills0)
    if [len(o) for o in outs] != [16] * len(prompts):
        raise AssertionError(f"token counts {[len(o) for o in outs]}")
    if any(not (0 <= t < cfg.vocab) for o in outs for t in o):
        raise AssertionError("token outside the vocabulary")
    want = GEMMS_PER_LAYER * cfg.n_layers * forwards
    if launches != want:
        raise AssertionError(f"GEMM launches {launches} != {want} "
                             f"(210 x {forwards} forwards)")
    if tiers != {"exact": want}:
        raise AssertionError(f"dispatch tiers seen: {tiers}; every GEMM "
                             "should resolve on the exact tier")
    # every layer of every decode tick reads its KV split count from the
    # attention record tuned at this decode shape
    want_attn = cfg.n_layers * (eng.ticks - ticks0)
    if attn_tiers != {"exact": want_attn}:
        raise AssertionError(f"decode-split resolutions {attn_tiers}; want "
                             f"{want_attn} on the exact tier")
    splits = resolve_decode_splits(
        B=sc.slots, Hq=cfg.n_heads, Hkv=cfg.n_kv, Lkv=sc.max_len,
        D=cfg.head_dim, dtype_bits=16, default=cfg.decode_kv_splits)
    total = sum(len(o) for o in outs)
    tick_ms = statistics.median(t[1] for t in eng.tick_times) * 1e3
    tuned, heur = (per_tick(gemm_rows, k, cfg.n_layers)
                   for k in ("kernel_ms", "heuristic_ms"))
    phase("serve", f"{cfg.name} ({cfg.n_layers}L d={cfg.d_model} bf16): "
          f"{len(outs)} requests x 16 tokens, {forwards} forwards "
          f"({eng.prefills - prefills0} prefills + {eng.ticks - ticks0} "
          f"ticks), {launches} GEMM launches, tiers {tiers}; decode KV "
          f"splits {splits} from the tuned attention record (default "
          f"{cfg.decode_kv_splits}), {want_attn} resolutions, tiers "
          f"{attn_tiers}; {total / wall:.1f} tok/s, median tick "
          f"{tick_ms:.2f} ms; GEMM per decode tick {tuned:.3f} ms under "
          f"tuned configs, {heur:.3f} ms under the heuristic's [{label}]")
    return {"launches": launches, "tokens_per_s": total / wall,
            "tick_ms": tick_ms, "tiers": tiers, "splits": splits,
            "engine": eng}



def phase_profile(eng, cfg, dev: torch.device, label: str) -> dict:
    """Where a decode tick's time goes: the eager tick's wall time
    (synchronised), the host time to enqueue it, and the device time of
    the same tick replayed from a CUDA graph (no host in the way)."""
    last = torch.zeros((4, 1), dtype=torch.long, device=dev)
    idx = torch.full((4,), 40, dtype=torch.long, device=dev)
    tick = lambda: decode_step(eng.params, cfg, last, eng.cache, idx)
    n = 10
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            tick()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        tick()
        enqueues.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tick()
    graph.replay()
    torch.cuda.synchronize()
    devs = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        devs.append(e0.elapsed_time(e1))
    out = {"wall_ms": 1e3 * statistics.median(walls),
           "enqueue_ms": 1e3 * statistics.median(enqueues),
           "device_ms": statistics.median(devs)}
    phase("profile", f"decode tick (4 slots, 30 layers): eager wall "
          f"{out['wall_ms']:.2f} ms, host enqueue {out['enqueue_ms']:.2f} "
          f"ms, device (CUDA graph replay) {out['device_ms']:.2f} ms, "
          f"device busy {100 * out['device_ms'] / out['wall_ms']:.1f}% of "
          f"the eager tick [{label}]")
    return out


def phase_model(cfg, params, dev: torch.device) -> float:
    rng = np.random.default_rng(2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32)),
                              device=dev)
    steps = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 4)), device=dev)

    def run(plain: bool) -> torch.Tensor:
        cache = init_cache(cfg, 4, 256, dev)
        kv = cache["pos0"]["attn"]
        out = []
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        with ctx:
            for s in range(4):
                one = {"pos0": {"attn": {"k": kv["k"][:, s:s + 1],
                                         "v": kv["v"][:, s:s + 1]}}}
                lg, _ = prefill(params, cfg, {"tokens": prompts[s:s + 1]},
                                one)
                out.append(lg)
            idx = torch.full((4,), 32, dtype=torch.long, device=dev)
            for t in range(4):
                lg, _ = decode_step(params, cfg, steps[:, t:t + 1], cache,
                                    idx + t)
                out.append(lg)
        return torch.cat(out)

    got, want = run(False), run(True)
    torch.cuda.synchronize()
    _, er = rel_err(got, want)
    if not (torch.isfinite(got).all() and er <= LOGIT_TOL):
        raise AssertionError(f"logits kernel vs plain rel err {er:.3e}")
    phase("model", f"prefill x4 + 4 decode steps: logits kernel vs plain "
          f"rel err {er:.3e} (tolerance {LOGIT_TOL}), shape "
          f"{tuple(got.shape)}")
    return er


REPLACES = {"gemm": "src/repro/kernels/matmul.py:36",
            "conv": "src/repro/kernels/conv.py:38",
            "attention": "src/repro/kernels/attention.py:29",
            "ssd": "src/repro/kernels/ssd.py:28"}


def kernels_line(rows: dict, worst: dict, launches: dict, n_layers: int
                 ) -> dict:
    """One row per ported kernel.  GEMM: times summed over one decode
    tick's projections; conv: summed over the 14 Table 5 shapes, one call
    each; attention and SSD: summed over their tune targets, one call each.
    ``ms`` is the tuned config's kernel time.  ``launches`` is the count on
    the kernel's own path (serve for the GEMM, tune for the rest);
    ``launches_by_path`` gives every path's."""
    per = {"gemm": "one decode tick: 210 projections at M=4, tuned configs",
           "conv": "the 14 Table 5 shapes, bf16, one call each, tuned configs",
           "attention": "the 4 attention targets, bf16, one call each, tuned "
                        "configs",
           "ssd": "the 2 SSD targets, bf16, one call each, tuned configs"}
    path = {"gemm": "serve", "conv": "tune", "attention": "tune",
            "ssd": "tune"}
    out = []
    for name in KERNELS:
        if name == "gemm":
            tot = lambda key: per_tick(rows["gemm"], key, n_layers)
        else:
            tot = lambda key, n=name: sum(r[key] for r in rows[n])
        t_bytes, t_ops = tot("t_bytes"), tot("t_ops")
        alt = "heuristic_ms" if name in ("gemm", "conv") else "default_ms"
        library = None if name == "ssd" else tot("library_ms")
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[path[name]][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": worst[name]["abs"],
            "max_rel_err": worst[name]["rel"],
            "ms": tot("kernel_ms"), "kernel_ms": tot("kernel_ms"),
            alt: tot(alt), "plain_ms": tot("plain_ms"),
            "library_ms": library,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "per": per[name],
            "shapes": [{k: r[k] for k in r if k not in ("t_bytes", "t_ops")}
                       for r in rows[name]]})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    peaks = card_peaks(name)
    label = f"{smi}; peaks of H100 SXM"
    phase_build()
    worst = {"gemm": phase_gemm_check(dev), "conv": phase_conv_check(dev),
             "attention": phase_attention_check(dev),
             "ssd": phase_ssd_check(dev)}

    cfg = get_config("smollm-135m")
    backend = CheckedBackend(CudaEventBackend(device=dev))
    fp = backend.fingerprint
    phase("tune", f"backend fingerprint {fp}")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        store_path = Path(tmp) / "tunedb.jsonl"
        store = RecordStore.open(store_path)
        reset_launches()
        phase_tune(backend, store, fp, dev)
        launches["tune"] = read_launches()
        if not all(launches["tune"].values()):
            raise AssertionError(f"tune path launches {launches['tune']}")
        phase("tune", f"launches on the tune path: {launches['tune']}")
        gemm_rows, conv_rows = phase_times(dev, peaks, label)
        attn_rows, ssd_rows = phase_times_attention_ssd(dev, peaks, label)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen)
        serve = phase_serve(cfg, params, store_path, fp, gemm_rows, label)
        launches["serve"] = read_launches()
        phase_model(cfg, params, dev)
        phase_profile(serve.pop("engine"), cfg, dev, label)
        clear_store()
    rows = {"gemm": gemm_rows, "conv": conv_rows, "attention": attn_rows,
            "ssd": ssd_rows}
    print(json.dumps(kernels_line(rows, worst, launches, cfg.n_layers)),
          flush=True)
    phase("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
