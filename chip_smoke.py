#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits non-zero:

  1. device   the card's name and ``nvidia-smi`` name / power limit
  2. build    every CUDA kernel of the serving path, from ``csrc/``
  3. gemm     the GEMM kernel against its plain version (and the fp32
              oracle) at the serving path's shapes, several configs
  4. times    per shape, under the config dispatch resolves: the kernel
              path, the plain version, ``torch.matmul`` (a yardstick the
              port never calls) and the bound max(bytes/HBM, FLOPs/peak)
  5. serve    SmolLM-135M at full width (30 layers, bf16, random weights
              from a seed) through ``Engine.generate`` with a tuning-record
              store; every projection must launch the kernel
  6. model    prefill + 4 decode steps through the kernel path and again
              through the plain path on the card; logits must agree
  7. profile  a decode tick: eager wall time, host enqueue time, and the
              device time of the same tick replayed from a CUDA graph
  8. kernels  one JSON line summarising every ported kernel

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
from repro_torch.core.space import gemm_input  # noqa: E402
from repro_torch.kernels import _build, dispatch, ops  # noqa: E402
from repro_torch.kernels import matmul as kmatmul  # noqa: E402
from repro_torch.kernels.ref import matmul_ref  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.tunedb.store import (RecordStore, TuneRecord, clear_store,  # noqa: E402
                                     install_store)

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

# hand-picked (not tuned: the tuner arrives with the next slice) configs for
# the prefill shapes, written to the store phase 5 serves from
STORE_CONFIGS = {
    (576, 576): {"bm": 32, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 2,
                 "order": 0, "acc32": 1, "prefetch": 2},
    (192, 576): {"bm": 32, "bn": 32, "bk": 64, "k_unroll": 1, "k_split": 4,
                 "order": 0, "acc32": 1, "prefetch": 2},
    (1536, 576): {"bm": 32, "bn": 128, "bk": 64, "k_unroll": 1, "k_split": 1,
                  "order": 0, "acc32": 1, "prefetch": 3},
    (576, 1536): {"bm": 32, "bn": 64, "bk": 128, "k_unroll": 1, "k_split": 4,
                  "order": 1, "acc32": 1, "prefetch": 2},
}

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
def plain_gemm():
    """Send ``ops.matmul`` through the kernel's plain version, on the card,
    under the same configs: the reference the kernel path is held to.  The
    port itself has no switch for this; only the checks here make it."""
    kernel = kmatmul.gemm
    kmatmul.gemm = kmatmul.matmul_plain
    try:
        yield
    finally:
        kmatmul.gemm = kernel


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


def bound_ms(M: int, N: int, K: int, dtype: torch.dtype, peaks: dict
             ) -> tuple:
    """(least time in ms, what bounds it): each input read once, the output
    written once, 2MNK FLOPs at the dtype's peak."""
    bpe = torch.finfo(dtype).bits // 8
    t_bytes = (M * K + K * N + M * N) * bpe / peaks["hbm"]
    t_ops = 2.0 * M * N * K / peaks[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops)


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
    _build.load("gemm")
    phase("build", f"nvcc sm_90a, {time.perf_counter() - t0:.1f} s")


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


def write_store(path: Path, fp: str) -> RecordStore:
    store = RecordStore.open(path)
    for (N, K), cfg in STORE_CONFIGS.items():
        store.add(TuneRecord(space="gemm", inputs=gemm_input(32, N, K, 16),
                             config=cfg, tflops=0.0, backend=fp,
                             source="chip_smoke"))
    return store


def phase_times(dev: torch.device, peaks: dict, label: str) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for M in SLICE_M:
        for (N, K) in SLICE_NK:
            dtype = torch.bfloat16
            cfg, tier = dispatch._resolve_cfg(
                "gemm", gemm_input(M, N, K, 16))
            a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            # cycle through enough weight copies that the set exceeds L2:
            # in a decode tick every weight matrix is read cold
            b_bytes = K * N * 2
            n_calls = min(1000, max(20, math.ceil(2.5 * L2_BYTES / b_bytes)))
            bs = [torch.randn((K, N), generator=gen, device=dev).to(dtype)
                  for _ in range(n_calls)]
            kernel = time_ms(lambda i: ops.matmul(a, bs[i], cfg), n_calls)
            with plain_gemm():
                plain = time_ms(lambda i: ops.matmul(a, bs[i], cfg), n_calls)
            library = time_ms(lambda i: torch.matmul(a, bs[i]), n_calls)
            bms, by, tb, to = bound_ms(M, N, K, dtype, peaks)
            del bs
            rows.append({"M": M, "N": N, "K": K, "tier": tier, "cfg": cfg,
                         "kernel_ms": kernel, "plain_ms": plain,
                         "library_ms": library, "bound_ms": bms,
                         "bound_by": by, "t_bytes": tb, "t_ops": to})
            phase("times", f"M={M} N={N} K={K} bf16 tier={tier} "
                  f"kernel {kernel * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
                  f"torch.matmul {library * 1e3:.2f} us, bound "
                  f"{bms * 1e3:.2f} us ({by}) [{label}]")
    return rows


def phase_serve(cfg, params, store_path: Path, fp: str, label: str) -> dict:
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
    if "exact" not in tiers or not ({"nearest", "degraded"} & set(tiers)):
        raise AssertionError(f"dispatch tiers seen: {tiers}")
    total = sum(len(o) for o in outs)
    tick_ms = statistics.median(t[1] for t in eng.tick_times) * 1e3
    phase("serve", f"{cfg.name} ({cfg.n_layers}L d={cfg.d_model} bf16): "
          f"{len(outs)} requests x 16 tokens, {forwards} forwards "
          f"({eng.prefills - prefills0} prefills + {eng.ticks - ticks0} "
          f"ticks), {launches} GEMM launches, tiers {tiers}; "
          f"{total / wall:.1f} tok/s, median tick {tick_ms:.2f} ms [{label}]")
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
        ctx = plain_gemm() if plain else contextlib.nullcontext()
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


def kernels_line(rows: list, worst: dict, serve: dict, n_layers: int,
                 peaks: dict) -> dict:
    """The GEMM row: times summed over one decode tick's projections
    (the M=4 shapes, each as often as the model calls it)."""
    per_tick = [(r, SLICE_NK[(r["N"], r["K"])] * n_layers)
                for r in rows if r["M"] == 4]
    tot = lambda key: sum(r[key] * n for r, n in per_tick)
    t_bytes, t_ops = tot("t_bytes"), tot("t_ops")
    return {"kernels": [{
        "name": "gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/matmul.py:36",
        "launches": serve["launches"],
        "max_abs_err": worst["abs"], "max_rel_err": worst["rel"],
        "ms": tot("kernel_ms"), "kernel_ms": tot("kernel_ms"),
        "plain_ms": tot("plain_ms"), "library_ms": tot("library_ms"),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "per": "one decode tick: 210 projections at M=4",
        "shapes": [{k: r[k] for k in ("M", "N", "K", "tier", "kernel_ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")} for r in rows],
    }]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    peaks = card_peaks(name)
    label = f"{smi}; peaks of H100 SXM"
    phase_build()
    worst = phase_gemm_check(dev)

    cfg = get_config("smollm-135m")
    fp = f"repro_torch-cuda-{name}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        store_path = Path(tmp) / "tunedb.jsonl"
        install_store(write_store(store_path, fp), fingerprint=fp)
        rows = phase_times(dev, peaks, label)   # under the store's tiers
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen)
        serve = phase_serve(cfg, params, store_path, fp, label)
        phase_model(cfg, params, dev)
        phase_profile(serve.pop("engine"), cfg, dev, label)
        clear_store()
    print(json.dumps(kernels_line(rows, worst, serve, cfg.n_layers, peaks)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
