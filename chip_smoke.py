#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits non-zero:

  1. device   the card's name and ``nvidia-smi`` name / power limit
  2. build    every CUDA kernel (gemm.cu, conv.cu) from ``csrc/``, one
              nvcc per source, in parallel
  3. gemm     the GEMM kernel against its plain version (and the fp32
              oracle) at the serving path's shapes, several configs
  4. conv     the conv kernel against its plain version (and the fp32
              oracle) at the paper's 14 Table 5 shapes, full size
  5. tune     the offline loop on the card for gemm and conv: fit the
              sampler, label a dataset with CheckedBackend(CudaEventBackend)
              (the gate, then the kernels timed), train the MLP, run a
              TuningSession with top-k re-measurement over the 8 SmolLM-135M
              projection shapes and the 14 Table 5 shapes into a record
              store, then serve every tuned shape through dispatch.matmul /
              dispatch.conv2d from it; every job must succeed, every call
              resolve exact and agree with the fp32 oracle at full size
  6. times    per shape: the tuned config's kernel time, the heuristic
              config's, the plain version, the library call the port never
              makes (``torch.matmul``; ``F.conv2d`` channels-last on cuDNN)
              and the bound max(bytes/HBM, FLOPs/peak)
  7. pending  the kernels still to port (attention, SSD): their bounds at
              a shape of a supported model, and SDPA's time for attention
  8. serve    SmolLM-135M at full width (30 layers, bf16, random weights
              from a seed) through ``Engine.generate`` from the tuned store;
              every projection launches the kernel on the exact tier
  9. model    prefill + 4 decode steps through the kernel path and again
              through the plain path on the card; logits must agree
 10. profile  a decode tick: eager wall time, host enqueue time, and the
              device time of the same tick replayed from a CUDA graph
 11. kernels  one JSON line summarising every ported kernel

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
from repro_torch.core.backend import CheckedBackend, CudaEventBackend  # noqa: E402
from repro_torch.core.dataset import Dataset  # noqa: E402
from repro_torch.core.features import Featurizer  # noqa: E402
from repro_torch.core.generative import CategoricalSampler  # noqa: E402
from repro_torch.core.heuristics import VendorHeuristicLibrary  # noqa: E402
from repro_torch.core.mlp import MLP  # noqa: E402
from repro_torch.core.space import (CONV_SPACE, GEMM_SPACE,  # noqa: E402
                                    ConfigRejected, conv_input, gemm_input)
from repro_torch.core.tuner import InputAwareTuner  # noqa: E402
from repro_torch.kernels import _build, dispatch, ops  # noqa: E402
from repro_torch.kernels import conv as kconv  # noqa: E402
from repro_torch.kernels import matmul as kmatmul  # noqa: E402
from repro_torch.kernels.ref import attention_ref, conv2d_ref, matmul_ref  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
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

# the tune phase: dataset size per space, regressor, top-k re-measured
TUNE_SAMPLES = {"gemm": 320, "conv": 192}
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
    """Send ``ops.matmul`` / ``ops.conv2d`` through the kernels' plain
    versions, on the card, under the same configs: the reference the kernel
    paths are held to.  The port itself has no switch for this; only the
    checks and timings here make it."""
    gemm, conv = kmatmul.gemm, kconv.conv
    kmatmul.gemm, kconv.conv = kmatmul.matmul_plain, kconv.conv2d_plain
    try:
        yield
    finally:
        kmatmul.gemm, kconv.conv = gemm, conv


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
            fn(i)
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


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(["gemm", "conv"])
    _build.load("gemm")
    _build.load("conv")
    phase("build", f"nvcc sm_90a, gemm.cu + conv.cu in parallel, "
          f"{time.perf_counter() - t0:.1f} s")


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


def neighbours(x: dict, dims: tuple) -> list:
    """``x`` and, for each of ``dims``, ``x`` with that dim halved and
    doubled: the pool the tune phase's dataset is drawn from."""
    out = [dict(x)]
    for d in dims:
        for v in (max(1, x[d] // 2), 2 * x[d]):
            out.append({**x, d: v})
    return out


def tune_space(space, targets: list, dims: tuple, backend, store
               ) -> dict:
    """The offline loop for one space, built from the library's public
    pieces: fit the sampler on the target-and-neighbour pool, label a
    dataset on the card, train the regressor, run a tuning session."""
    pool = []
    for x in targets:
        pool += [y for y in neighbours(x, dims) if y not in pool]
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


def phase_tune(backend, store: RecordStore, fp: str, dev: torch.device
               ) -> dict:
    """The tuning path: both spaces tuned into ``store``, then every tuned
    shape served through ``dispatch.matmul`` / ``dispatch.conv2d`` from it:
    each on the exact tier, within the bf16 tolerance of the plain version
    under the same config and of the fp32 oracle, at full size."""
    gemm_targets = [gemm_input(M, N, K, 16) for M in SLICE_M
                    for (N, K) in SLICE_NK]
    stats = [tune_space(GEMM_SPACE, gemm_targets, ("M", "N", "K"), backend,
                        store),
             tune_space(CONV_SPACE, CONV_SHAPES, ("N", "H", "W", "C", "K"),
                        backend, store)]
    install_store(store, fingerprint=fp)
    dispatch.reset_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = []
    for x in gemm_targets:
        a = torch.randn((x["M"], x["K"]), generator=gen, device=dev)
        b = torch.randn((x["K"], x["N"]), generator=gen, device=dev
                        ) / x["K"] ** 0.5
        cases.append(("gemm", f"M={x['M']} N={x['N']} K={x['K']}", x,
                      a.bfloat16(), b.bfloat16()))
    for x, row in zip(CONV_SHAPES, TABLE5):
        cases.append(("conv", row[-1], x,
                      *conv_operands(x, torch.bfloat16, gen, dev)))
    worst = {"plain": 0.0, "oracle": 0.0}
    for space, name, x, u, v in cases:
        cfg = store.get(space, x, backend=fp).config
        if space == "gemm":
            out, want_shape = dispatch.matmul(u, v), (x["M"], x["N"])
            with plain_kernels():
                plain = ops.matmul(u, v, cfg)
            oracle = matmul_ref(u, v)
        else:
            out = dispatch.conv2d(u, v)
            want_shape = (x["N"], x["H"], x["W"], x["K"])
            with plain_kernels():
                plain = ops.conv2d(u, v, cfg)
            oracle = conv2d_ref(u, v)
        torch.cuda.synchronize()
        er = {"plain": rel_err(out, plain)[1], "oracle": rel_err(out, oracle)[1]}
        if tuple(out.shape) != want_shape or max(er.values()) > TOL[
                torch.bfloat16] or not torch.isfinite(out).all():
            raise AssertionError(f"dispatch.{space} at {name} under {cfg}: "
                                 f"shape {tuple(out.shape)}, rel err {er}")
        worst = {k: max(worst[k], er[k]) for k in worst}
        del u, v, out, plain, oracle
    tiers = dict(dispatch.tier_counts)
    want_tiers = {("gemm", "exact"): len(gemm_targets),
                  ("conv", "exact"): len(CONV_SHAPES)}
    if tiers != want_tiers:
        raise AssertionError(f"dispatch tiers {tiers}")
    phase("tune", f"dispatch.matmul over the 8 GEMM and dispatch.conv2d over "
          f"the 14 Table 5 shapes from the tuned store: all exact; max rel "
          f"err {worst['plain']:.3e} vs the plain version under the same "
          f"config, {worst['oracle']:.3e} vs the fp32 oracle (tolerance "
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


def phase_pending(dev: torch.device, peaks: dict, label: str) -> dict:
    """The two TPU kernels not ported yet, at a shape of a configuration the
    repo supports: their bounds, and the time of the one PyTorch call that
    computes the same function where there is one (a yardstick; nothing in
    the port calls it)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bf16 = torch.bfloat16
    # attention: SmolLM-135M's decode tick, 4 slots over a 256-token cache
    B, Hq, Hkv, D, Lkv = 4, 9, 3, 64, 256
    n_calls = 200                     # K/V copies: 79 MB, past the L2
    q = torch.randn((B, Hq, 1, D), generator=gen, device=dev).to(bf16)
    ks = [torch.randn((B, Hkv, Lkv, D), generator=gen, device=dev).to(bf16)
          for _ in range(n_calls)]
    vs = [torch.randn((B, Hkv, Lkv, D), generator=gen, device=dev).to(bf16)
          for _ in range(n_calls)]
    sdpa = lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, ks[i], vs[i], enable_gqa=True)
    _, er = rel_err(sdpa(0), attention_ref(q, ks[0], vs[0], causal=False))
    if er > TOL[bf16]:
        raise AssertionError(f"SDPA disagrees with attention_ref: {er:.3e}")
    attn = {"sdpa_ms": time_ms(sdpa, n_calls),
            **bound((2 * B * Hq * D + 2 * B * Hkv * Lkv * D) * 2,
                    4.0 * B * Hq * Lkv * D, bf16, peaks)}
    del ks, vs
    # SSD: one mamba2-1.3b layer (d_inner 4096 = 64 heads of 64, state 128,
    # chunk 256) over a 2048-token prefill; FLOPs of the chunked form
    Bs, L, H, P, S, c = 1, 2048, 64, 64, 128, 256
    nc = L // c
    flops = 2.0 * Bs * H * nc * (c * c * (P + S) + c * S * P * 2 + P * S)
    nbytes = (2 * Bs * L * H * P + Bs * L * H + 2 * Bs * L * S) * 2 + H * 4
    ssd = bound(nbytes, flops, bf16, peaks)
    phase("pending", f"attention (not ported) at B={B} Hq={Hq} Hkv={Hkv} "
          f"D={D} Lq=1 Lkv={Lkv} bf16: SDPA {attn['sdpa_ms'] * 1e3:.2f} us, "
          f"bound {attn['bound_ms'] * 1e3:.3f} us ({attn['bound_by']}); "
          f"SSD scan (not ported) at B={Bs} L={L} H={H} P={P} S={S} chunk "
          f"{c}: bound {ssd['bound_ms'] * 1e3:.2f} us ({ssd['bound_by']}), "
          f"no single PyTorch call computes it [{label}]")
    return {"attention": attn, "ssd": ssd}


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
    kmatmul.launches = 0
    kconv.launches = 0
    dispatch.reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kmatmul.launches
    tiers = {t: c for (s, t), c in dispatch.tier_counts.items() if s == "gemm"}
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
    total = sum(len(o) for o in outs)
    tick_ms = statistics.median(t[1] for t in eng.tick_times) * 1e3
    tuned, heur = (per_tick(gemm_rows, k, cfg.n_layers)
                   for k in ("kernel_ms", "heuristic_ms"))
    phase("serve", f"{cfg.name} ({cfg.n_layers}L d={cfg.d_model} bf16): "
          f"{len(outs)} requests x 16 tokens, {forwards} forwards "
          f"({eng.prefills - prefills0} prefills + {eng.ticks - ticks0} "
          f"ticks), {launches} GEMM launches, tiers {tiers}; "
          f"{total / wall:.1f} tok/s, median tick {tick_ms:.2f} ms; GEMM "
          f"per decode tick {tuned:.3f} ms under tuned configs, "
          f"{heur:.3f} ms under the heuristic's [{label}]")
    return {"launches": launches, "tokens_per_s": total / wall,
            "tick_ms": tick_ms, "tiers": tiers, "engine": eng}



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


def kernels_line(gemm_rows: list, conv_rows: list, worst: dict,
                 launches: dict, n_layers: int) -> dict:
    """One row per ported kernel.  GEMM: times summed over one decode
    tick's projections; conv: summed over the 14 Table 5 shapes, one call
    each.  ``launches`` is the count on the kernel's own path (serve for
    the GEMM, tune for the conv); ``launches_by_path`` gives both."""
    def row(name, rows, tot, per, path):
        t_bytes, t_ops = tot("t_bytes"), tot("t_ops")
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": {"gemm": "src/repro/kernels/matmul.py:36",
                         "conv": "src/repro/kernels/conv.py:38"}[name],
            "launches": launches[path][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": worst[name]["abs"],
            "max_rel_err": worst[name]["rel"],
            "ms": tot("kernel_ms"), "kernel_ms": tot("kernel_ms"),
            "heuristic_ms": tot("heuristic_ms"),
            "plain_ms": tot("plain_ms"), "library_ms": tot("library_ms"),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "per": per,
            "shapes": [{k: r[k] for k in r if k not in ("t_bytes", "t_ops")}
                       for r in rows]}
    gemm_tot = lambda key: per_tick(gemm_rows, key, n_layers)
    conv_tot = lambda key: sum(r[key] for r in conv_rows)
    return {"kernels": [
        row("gemm", gemm_rows, gemm_tot,
            "one decode tick: 210 projections at M=4, tuned configs", "serve"),
        row("conv", conv_rows, conv_tot,
            "the 14 Table 5 shapes, bf16, one call each, tuned configs",
            "tune")]}


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
    worst = {"gemm": phase_gemm_check(dev), "conv": phase_conv_check(dev)}

    cfg = get_config("smollm-135m")
    backend = CheckedBackend(CudaEventBackend(device=dev))
    fp = backend.fingerprint
    phase("tune", f"backend fingerprint {fp}")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        store_path = Path(tmp) / "tunedb.jsonl"
        store = RecordStore.open(store_path)
        kmatmul.launches = 0
        kconv.launches = 0
        phase_tune(backend, store, fp, dev)
        launches["tune"] = {"gemm": kmatmul.launches, "conv": kconv.launches}
        if not all(launches["tune"].values()):
            raise AssertionError(f"tune path launches {launches['tune']}")
        gemm_rows, conv_rows = phase_times(dev, peaks, label)
        phase_pending(dev, peaks, label)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen)
        serve = phase_serve(cfg, params, store_path, fp, gemm_rows, label)
        launches["serve"] = {"gemm": serve["launches"],
                             "conv": kconv.launches}
        phase_model(cfg, params, dev)
        phase_profile(serve.pop("engine"), cfg, dev, label)
        clear_store()
    print(json.dumps(kernels_line(gemm_rows, conv_rows, worst, launches,
                                  cfg.n_layers)), flush=True)
    phase("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
