#!/usr/bin/env python3
"""Which kernel events ``torch.profiler`` loses from traced replays of a
captured CUDA graph, and whether the port's code has a part in it.

    python3 tools/profiler_loss.py [--rounds 24] [--out PATH]

chip_smoke's moe phase traces rounds of 5 replays of the dbrx-132b tick
(full width, 8 of 40 layers, the decode path over every expert), and
such rounds lose one or two of the graph's kernel events.  This tool
traces ``--rounds`` rounds of 5 replays in six settings:

  moe          the tick (``decode_step`` captured as chip_smoke's profile
               phase captures SmolLM's), replays back to back;
  moe+sync     the same, ``torch.cuda.synchronize()`` after each replay;
  engine       the engine's own tick graph (``Engine.graph``, captured by
               a short ``generate``), which chip_smoke's moe phase traces;
  engine+sync  the same with a synchronise after each replay;
  plain        a captured graph of plain PyTorch ops that run no code of
               the port, shaped like the tick: an embedding gather from a
               (100352, 6144) table, an ``arange``, then 8 "layers" of
               element-wise ops and three batched products over 16
               (6144, 10752) or (10752, 6144) matrices, about as long on
               the device as the tick;
  plain+sync   the same with a synchronise after each replay.

A round's events are aligned, replay by replay, with the graph's kernel
nodes in capture order (``cuGraphGetNodes``, demangled as the profiler
names them): a node with no event in its place is lost, and its replay
and position in the replay are printed.  One JSON line per setting and a
summary; the rounds are written to ``--out``
(``results/profiler_loss.json`` by default).  Needs one NVIDIA GPU
with 60 GB free; no JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPS = cs.PROFILE_REPS


def capture(fn) -> tuple:
    """``fn`` warmed up on a side stream, then captured with its graph
    kept; returns (graph, its kernel nodes' names in capture order)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        gc.enable()
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    return graph, cs.demangle(cs.graph_kernel_names(graph))


def traced(graph, sync: bool) -> list:
    """The kernel events' names of one traced round of :data:`REPS`
    replays, in start order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            graph.replay()
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not ev.name.startswith(("Memcpy", "Memset"))),
                 key=lambda ev: ev.time_range.start)
    return [ev.name for ev in evs]


def align(names: list, order: list) -> dict:
    """``names`` walked against ``order`` repeated :data:`REPS` times: a
    node whose name is not next in ``names`` is lost (replay, position,
    name); events left over, or more than a tenth of the nodes lost, mean
    the events do not follow the capture order."""
    lost, j = [], 0
    for r in range(REPS):
        for pos, name in enumerate(order):
            if j < len(names) and names[j] == name:
                j += 1
            else:
                lost.append((r, pos, name[:80]))
    in_order = j == len(names) and len(lost) <= len(order) * REPS // 10
    extra = collections.Counter(names) - collections.Counter(order * REPS)
    return {"events": len(names), "want": len(order) * REPS,
            "lost": lost if in_order else None, "in_order": in_order,
            "foreign": sum(extra.values())}


def run(what: str, graph, order: list, rounds: int, sync: bool) -> dict:
    out = [align(traced(graph, sync), order) for _ in range(rounds)]
    n_lost = [r["want"] - r["events"] + r["foreign"] for r in out]
    positions = collections.Counter(
        (pos, name) for r in out for _, pos, name in (r["lost"] or []))
    summary = {"setting": what, "nodes": len(order), "rounds": rounds,
               "reps": REPS, "lost_per_round": n_lost,
               "rounds_whole": sum(n == 0 for n in n_lost),
               "events_in_capture_order": all(r["in_order"] for r in out),
               "foreign": sum(r["foreign"] for r in out),
               "lost_at": [[pos, name, c] for (pos, name), c
                           in sorted(positions.items())],
               "first_nodes": order[:3]}
    print(json.dumps(summary), flush=True)
    return {"summary": summary, "rounds": out}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=24)
    p.add_argument("--out", default=str(ROOT / "results"
                                        / "profiler_loss.json"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profiler_loss: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, smi = cs.phase_device()
    cs.init_cupti()
    results = []

    cfg = dataclasses.replace(cs.get_config("dbrx-132b"),
                              n_layers=cs.MOE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = cs.init_params(cfg, gen)
    cache = cs.init_cache(cfg, cs.MOE_SLOTS, cs.MOE_MAX_LEN, dev)
    last = torch.zeros((cs.MOE_SLOTS, 1), dtype=torch.long, device=dev)
    idx = torch.full((cs.MOE_SLOTS,), 40, dtype=torch.long, device=dev)
    graph, order = capture(lambda: cs.decode_step(params, cfg, last, cache,
                                                  idx))
    for sync in (False, True):
        results.append(run("moe" + "+sync" * sync, graph, order,
                           args.rounds, sync))
    del graph, cache
    eng = cs.Engine(cfg, params, cs.ServeConfig(
        max_len=cs.MOE_MAX_LEN, slots=cs.MOE_SLOTS), device=dev)
    eng.generate([list(range(1, cs.MOE_PROMPT + 1))] * 2, max_new=3)
    order = cs.demangle(cs.graph_kernel_names(eng.graph))
    for sync in (False, True):
        results.append(run("engine" + "+sync" * sync, eng.graph, order,
                           args.rounds, sync))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    # the same shape of work in plain PyTorch: no code of the port runs
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((100352, 6144), generator=g, device=dev
                        ).to(torch.bfloat16)
    w_in = [torch.randn((16, 6144, 10752), generator=g, device=dev
                        ).to(torch.bfloat16) for _ in range(2)]
    w_out = torch.randn((16, 10752, 6144), generator=g, device=dev
                        ).to(torch.bfloat16)
    tokens = torch.zeros((cs.MOE_SLOTS, 1), dtype=torch.long, device=dev)

    def plain() -> torch.Tensor:
        x = table[tokens]                                  # (4, 1, 6144)
        pos = torch.arange(1, device=dev) + 40
        x = x * (pos.float()[None, :, None] * 0 + 1).to(x.dtype)
        for _ in range(cs.MOE_LAYERS):
            h = x.float()
            for _ in range(40):                  # norms, rope, softmax...
                h = h * 1.0001 + 0.0001
            h = h.to(x.dtype).reshape(1, -1, 6144).expand(16, -1, -1)
            a = torch.bmm(h, w_in[0])
            b = torch.bmm(h, w_in[1])
            y = torch.bmm(torch.nn.functional.silu(a) * b, w_out)
            x = x + y.sum(0).reshape(x.shape)
        return x

    graph, order = capture(plain)
    for sync in (False, True):
        results.append(run("plain" + "+sync" * sync, graph, order,
                           args.rounds, sync))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": name, "smi": smi,
                               "results": results}, indent=1))
    print(json.dumps({"device": name, "smi": smi, "lost_per_round": {
        r["summary"]["setting"]: r["summary"]["lost_per_round"]
        for r in results}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
