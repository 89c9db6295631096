#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s serve phase in one process, and count what
the torch profiler would have counted beside it.

    python3 tools/serve_repeat.py [--runs 20] [--out PATH]

Tunes the 8 SmolLM-135M projection GEMMs and the 4 attention targets as
``chip_smoke.py``'s tune phase does, then runs ``phase_serve`` ``--runs``
times: each run checks that the graph run gives the device exactly 210 x
(prefills + replays) GEMM kernels and the expected split-K reduction
passes, counted from the captured graphs' kernel nodes.  After each
run one more graph run of the same 8 requests is traced with
``torch.profiler`` (CUDA activity), and its GEMM and reduction kernels
are counted from the profiler's events beside the exact count (the tick
graph's nodes times its replays, plus the 32-token prefill graph's times
its replays).  Prints
one JSON line per run and a summary, writes the runs as JSON to ``--out``
(``results/serve_repeat.json`` by default), and exits non-zero if any
run's exact check failed.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def traced_count(eng, prompts: list) -> dict:
    """One more graph run of ``prompts``: its GEMM and reduction kernels
    counted exactly (each graph's kernel nodes times its replays: the
    tick's, and each prompt length's prefill graph once a prompt, plus
    any launch from the host) and from the profiler's events."""
    per_tick = cs.graph_counts(eng.graph)[:2]
    before = eng.replays
    cs.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, max_new=16)
        torch.cuda.synchronize()
    replays = eng.replays - before
    exact = [n * replays for n in per_tick]
    exact[0] += cs.kmatmul.launches
    exact[1] += cs.kmatmul.reduce_launches
    graphs = eng.prefill_graphs
    for prompt in prompts:
        for i, n in enumerate(cs.graph_counts(graphs[len(prompt)])[:2]):
            exact[i] += n
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    return {"exact": exact,
            "profiler": [sum(1 for n in names if p.search(n))
                         for p in (cs.GEMM_KERNEL, cs.REDUCE_KERNEL)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "results"
                                         / "serve_repeat.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_repeat: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, smi = cs.phase_device()
    cs.phase_build()
    cfg = cs.get_config("smollm-135m")
    backend = cs.CheckedBackend(cs.CudaEventBackend(device=dev))
    fp = backend.fingerprint
    runs = []
    with tempfile.TemporaryDirectory(prefix="serve_repeat-") as tmp:
        path = Path(tmp) / "tunedb.jsonl"
        store = cs.RecordStore.open(path)
        targets = [cs.gemm_input(M, N, K, 16) for M in cs.SLICE_M
                   for (N, K) in cs.SLICE_NK]
        cs.tune_space(cs.GEMM_SPACE, targets, ("M", "N", "K"), backend,
                      store)
        cs.tune_space(cs.ATTENTION_SPACE, [x for _, x, _ in cs.ATTN_TARGETS],
                      cs.attention_dims, backend, store)
        # phase_serve reads k_split per shape; untimed rows print no time
        rows = []
        for x in targets:
            c = store.get("gemm", x, backend=fp).config
            rows.append({"M": x["M"], "N": x["N"], "K": x["K"],
                         "k_split": cs.ops.shrink_gemm_cfg(
                             c, x["M"], x["N"], x["K"])["k_split"]})
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = cs.init_params(cfg, gen)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, 32) for _ in range(8)]
        for i in range(args.runs):
            t0 = time.perf_counter()
            run = {"run": i}
            try:
                serve = cs.phase_serve(cfg, params, path, fp, rows, smi)
                run.update(ok=True, device=serve["device_launches"],
                           device_reduce=serve["device_reduce_launches"],
                           **traced_count(serve["engine"], prompts))
                del serve
            except AssertionError as e:
                run.update(ok=False, error=str(e))
            run["s"] = time.perf_counter() - t0
            runs.append(run)
            print(json.dumps(run), flush=True)
    ok = sum(r["ok"] for r in runs)
    short = sum(1 for r in runs if r["ok"] and r["profiler"] != r["exact"])
    print(f"serve phase: exact counts held in {ok} of {len(runs)} runs; the "
          f"profiler's count differed from the exact one in {short} of "
          f"{ok} traced runs [{smi}]")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": name, "nvidia_smi": smi,
                               "runs": runs}, indent=1))
    return 0 if ok == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
