"""Where one tuning draw's time and memory go on the card.

Runs the training-set draws of ``python -m repro_torch.tunedb tune --space
<space> --train-samples <n>`` (``generate_dataset`` with the CLI's seed,
pool and sampler: the same shapes and configs) through a backend that
labels each draw as ``CheckedBackend`` does, but times its parts, each
synchronised: the gate's operands and fp32 oracle (once per shape), the
gate's kernel run, its plain version, and the timer's measurement.  For
each part it also reads the device's peak memory over what the draw found
allocated, beside ``core.backend.footprint_bytes``.

  $ PYTHONPATH=src python3 tools/tune_draw_cost.py --space ssd --samples 64

Card only.  Prints one line per draw, then a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.backend import (CudaEventBackend,  # noqa: E402
                                      footprint_bytes)
from repro_torch.core.dataset import generate_dataset  # noqa: E402
from repro_torch.core.space import SPACES, ConfigRejected  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

PARTS = ("oracle", "kernel", "plain", "timer")


def tensor_bytes(case) -> int:
    xs, oracle = case
    return sum(t.numel() * t.element_size() for t in (*xs, oracle))


class PartsBackend:
    """``CheckedBackend(CudaEventBackend)`` with each part of a draw timed.
    A new shape gets a new timer and gate case, so a draw's peak is its
    own."""

    def __init__(self) -> None:
        self.dev = torch.device("cuda", 0)
        self.rows: list = []
        self.shape = None
        self.timer = self.case = None
        self.passed: set = set()

    def fits(self, space_name, inputs) -> bool:
        return CudaEventBackend(device=self.dev).fits(space_name, inputs)

    def clock(self, row, part, fn):
        """Run ``fn`` as ``part`` of the draw ``row``: its seconds, and its
        peak bytes over the draw's base."""
        torch.cuda.synchronize(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(self.dev)
        row[part] = time.perf_counter() - t0
        row["peak_bytes"][part] = \
            torch.cuda.max_memory_allocated(self.dev) - row["base"]
        return out

    def measure(self, space_name, cfg, inputs) -> float:
        small = dispatch.gate_instance(space_name, inputs, self.dev)
        shape = (space_name, tuple(sorted(small.items())))
        if shape != self.shape:
            self.shape, self.case = shape, None
            self.timer = CudaEventBackend(device=self.dev)
        torch.cuda.synchronize(self.dev)
        row = {"inputs": dict(inputs), "cfg": dict(cfg),
               **{p: 0.0 for p in PARTS}, "rejected": False,
               "peak_bytes": {p: 0 for p in PARTS},
               "base": torch.cuda.memory_allocated(self.dev) - (
                   tensor_bytes(self.case) if self.case else 0)}
        self.rows.append(row)
        key = (shape, tuple(sorted(cfg.items())))
        if key not in self.passed:
            if self.case is None:
                self.case = self.clock(row, "oracle", lambda: dispatch.
                                       _gate_case(space_name, small, self.dev))
            xs, oracle = self.case
            kernel, plain = dispatch._gate_runs(space_name, cfg, small)
            got = self.clock(row, "kernel", lambda: kernel(*xs))
            want = self.clock(row, "plain", lambda: plain(*xs))
            scale = max(float(oracle.abs().max()), 1e-6)
            errs = [float((got - w).abs().max()) / scale
                    for w in (want, oracle)]
            del got, want
            if not all(e <= dispatch.GATE_RTOL for e in errs):
                row["rejected"] = True
                self.finish(row, space_name, inputs)
                raise ConfigRejected(f"{space_name} {cfg}: rel err {errs}")
            self.passed.add(key)
        tflops = self.clock(row, "timer", lambda: self.timer.measure(
            space_name, cfg, inputs))
        self.finish(row, space_name, inputs)
        return tflops

    def finish(self, row, space_name, inputs) -> None:
        row["peak"] = max(row["peak_bytes"].values())
        row["footprint"] = footprint_bytes(space_name, inputs)
        row["total"] = sum(row[p] for p in PARTS)
        print(f"[draw {len(self.rows)}] {row['inputs']} {row['cfg']} "
              + " ".join(f"{p} {row[p]:.3f} s "
                         f"{row['peak_bytes'][p] / 1e9:.3f} GB"
                         for p in PARTS)
              + f"; total {row['total']:.3f} s, peak {row['peak'] / 1e9:.3f}"
              f" GB of footprint {row['footprint'] / 1e9:.3f} GB"
              + (" (rejected)" if row["rejected"] else ""), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--space", required=True, choices=sorted(SPACES))
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_draw_cost: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    be = PartsBackend()
    t0 = time.perf_counter()
    generate_dataset(SPACES[args.space], args.samples, backend=be,
                     seed=args.seed)
    wall = time.perf_counter() - t0
    rows = be.rows
    worst = max(rows, key=lambda r: r["peak"] / r["footprint"])
    print(json.dumps({
        "space": args.space, "samples": args.samples, "draws": len(rows),
        "card": smi, "wall_s": wall,
        "part_s": {p: sum(r[p] for r in rows) for p in PARTS},
        "mean_draw_s": sum(r["total"] for r in rows) / len(rows),
        "max_draw_s": max(r["total"] for r in rows),
        "slowest": max(rows, key=lambda r: r["total"]),
        "peak_over_footprint_max": worst["peak"] / worst["footprint"],
        "worst": worst,
        "draws_past_footprint": sum(r["peak"] > r["footprint"]
                                    for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
