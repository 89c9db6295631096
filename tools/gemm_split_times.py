#!/usr/bin/env python3
"""Per serving shape: where a GEMM call's time goes on the card.

    python3 tools/gemm_split_times.py [--samples 320] [--out PATH]

Tunes the GEMM space for SmolLM-135M's 8 projection shapes (M = 4 and 32)
as ``chip_smoke.py``'s tune phase does (the same pool, sampler, regressor
and session), then times, per shape, under the tuned config and under the
vendor heuristic's: ``ops.matmul`` (the kernel and, where ``k_split > 1``,
the split-K reduction), the kernel alone (``kmatmul.gemm``), the reduction
alone on the kernel's partials, ``torch.matmul`` and the bound.  Each is
the median device time of one call in a CUDA graph of calls that cycle
through enough weight copies to read them cold, as ``chip_smoke.py``
times; beside it the host's time to enqueue one eager ``ops.matmul``
call (median of 200, no synchronisation), what an eager prefill pays.  Per decode tick sums (the M=4 shapes, as often as the model calls
them) close the output.  Prints one line per shape and writes the rows as
JSON to ``--out`` (``results/gemm_split_times.json`` by default).

The reduction is the port's own pass where the tree has one
(``kmatmul.splitk_reduce``), else the PyTorch expression ``ops.matmul`` used
before it, so the script times either tree.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core.backend import CheckedBackend, CudaEventBackend  # noqa: E402
from repro_torch.core.heuristics import VendorHeuristicLibrary  # noqa: E402
from repro_torch.core.space import GEMM_SPACE, gemm_input  # noqa: E402
from repro_torch.kernels import _build, dispatch, ops  # noqa: E402
from repro_torch.kernels import matmul as kmatmul  # noqa: E402
from repro_torch.tunedb.store import RecordStore, clear_store, install_store  # noqa: E402

N_LAYERS = 30                      # SmolLM-135M


def reduction():
    """The split-K reduction ``ops.matmul`` runs on the card."""
    own = getattr(kmatmul, "splitk_reduce", None)
    if own is not None:
        return own, "kmatmul.splitk_reduce"
    return (lambda p: p.float().sum(dim=0).to(p.dtype),
            "parts.float().sum(0).to(dtype)")


def host_us(fn, n: int) -> float:
    """Median host time, in µs, to enqueue one eager ``fn(i)`` call."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(200):
        t0 = time.perf_counter()
        fn(i % n)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=cs.TUNE_SAMPLES["gemm"])
    ap.add_argument("--out", default=str(ROOT / "results"
                                         / "gemm_split_times.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_split_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, smi = cs.phase_device()
    peaks = cs.card_peaks(name)
    _build.load("gemm")
    reduce_fn, reduce_name = reduction()
    cs.TUNE_SAMPLES["gemm"] = args.samples
    backend = CheckedBackend(CudaEventBackend(device=dev))
    fp = backend.fingerprint
    targets = [gemm_input(M, N, K, 16) for M in cs.SLICE_M
               for (N, K) in cs.SLICE_NK]
    heur_lib = VendorHeuristicLibrary.gemm(GEMM_SPACE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    with tempfile.TemporaryDirectory(prefix="gemm_split_times-") as tmp:
        store = RecordStore.open(Path(tmp) / "tunedb.jsonl")
        tune = cs.tune_space(GEMM_SPACE, targets, ("M", "N", "K"), backend,
                             store)
        install_store(store, fingerprint=fp)
        for x in targets:
            M, N, K = x["M"], x["N"], x["K"]
            tuned, tier = dispatch._resolve_cfg("gemm", x)
            a = torch.randn((M, K), generator=gen, device=dev).bfloat16()
            n_calls = min(1000, max(20, math.ceil(2.5 * cs.L2_BYTES
                                                  / (K * N * 2))))
            bs = [torch.randn((K, N), generator=gen, device=dev).bfloat16()
                  for _ in range(n_calls)]
            row = {"M": M, "N": N, "K": K, "tier": tier,
                   **cs.gemm_bound(M, N, K, torch.bfloat16, peaks)}
            for label, cfg in (("tuned", tuned),
                               ("heuristic", heur_lib.select(x))):
                run = ops.shrink_gemm_cfg(cfg, M, N, K)
                parts = kmatmul.gemm(a, bs[0], run)
                row[label] = {
                    "cfg": cfg, "k_split": run["k_split"],
                    "ops_ms": cs.time_ms(lambda i: ops.matmul(a, bs[i], cfg),
                                         n_calls),
                    "kernel_ms": cs.time_ms(
                        lambda i: kmatmul.gemm(a, bs[i], run), n_calls),
                    "reduce_ms": cs.time_ms(lambda i: reduce_fn(parts),
                                            n_calls)
                    if run["k_split"] > 1 else 0.0,
                    "host_us": host_us(lambda i: ops.matmul(a, bs[i], cfg),
                                       n_calls)}
            row["library_ms"] = cs.time_ms(lambda i: torch.matmul(a, bs[i]),
                                           n_calls)
            del bs
            rows.append(row)
            t, h = row["tuned"], row["heuristic"]
            print(f"[gemm-split] M={M} N={N} K={K} tier={tier} tuned "
                  f"{t['cfg']} (k_split {t['k_split']}): ops.matmul "
                  f"{t['ops_ms'] * 1e3:.2f} us = kernel "
                  f"{t['kernel_ms'] * 1e3:.2f} us + reduction "
                  f"{t['reduce_ms'] * 1e3:.2f} us (host enqueue "
                  f"{t['host_us']:.2f} us); heuristic (k_split "
                  f"{h['k_split']}) {h['ops_ms'] * 1e3:.2f} us = "
                  f"{h['kernel_ms'] * 1e3:.2f} + {h['reduce_ms'] * 1e3:.2f} "
                  f"us; torch.matmul {row['library_ms'] * 1e3:.2f} us; "
                  f"bound {row['bound_ms'] * 1e3:.2f} us [{smi}]",
                  flush=True)
        clear_store()

    def tick(get) -> float:
        return sum(get(r) * cs.SLICE_NK[(r["N"], r["K"])] * N_LAYERS
                   for r in rows if r["M"] == 4)

    summary = {k: tick(lambda r, k=k: r["tuned"][k])
               for k in ("ops_ms", "kernel_ms", "reduce_ms")}
    summary["host_ms"] = tick(lambda r: r["tuned"]["host_us"] / 1e3)
    summary.update(heuristic_ops_ms=tick(lambda r: r["heuristic"]["ops_ms"]),
                   library_ms=tick(lambda r: r["library_ms"]),
                   bound_ms=tick(lambda r: r["bound_ms"]))
    print(f"[gemm-split] per decode tick (210 calls at M=4): tuned "
          f"ops.matmul {summary['ops_ms']:.3f} ms = kernel "
          f"{summary['kernel_ms']:.3f} + reduction ({reduce_name}) "
          f"{summary['reduce_ms']:.3f} ms (host enqueue "
          f"{summary['host_ms']:.3f} ms); heuristic "
          f"{summary['heuristic_ops_ms']:.3f} ms; torch.matmul "
          f"{summary['library_ms']:.3f} ms; bound {summary['bound_ms']:.3f} "
          f"ms [{smi}]", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": name, "nvidia_smi": smi,
                               "reduction": reduce_name, "tune": tune,
                               "rows": rows, "per_tick": summary}, indent=1,
                              default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
