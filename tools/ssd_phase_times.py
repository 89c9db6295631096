#!/usr/bin/env python3
"""Where the bf16 SSD kernel's time goes on the card, phase by phase.

    python3 tools/ssd_phase_times.py [--out PATH]

Builds ``csrc/ssd.cu`` and copies of it in which one phase of the bf16
body's chunk loop is cut out (its loop runs no iteration): the per-head
cumsum, the read-out ``C_i . state``, the intra-chunk ``W . x`` over the
slabs j <= i, the state update; and one copy with all four cut (what is
left: the cp.async ring, dt, the barriers and the y stores of nothing).
Then, for chunk 32, 64, 128 and 256 (``b_heads`` 1, the most stages that
fit, up to 3) at chip_smoke's two SSD targets (a mamba2-1.3b and a
jamba-v0.1 layer, bf16), times ``ops.ssd_scan`` on each build as
``chip_smoke.py`` times a kernel (a CUDA graph of calls cycling through
enough operand copies to exceed the L2, median of 5 replays).  A phase's
cost is read as the full kernel's time less the time without it: an
estimate, since a cut also shortens the barrier waits it causes.  Prints
one line per (target, config) and writes the rows as JSON to ``--out``
(``results/ssd_phase_times.json`` by default).  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402

# phase -> (the loop header in ssd.cu's bf16 body, the same loop run 0 times)
CUTS = {
    "cum": ("for (int hh = warp; hh < bh; hh += kWarps) {",
            "for (int hh = warp; hh < 0; hh += kWarps) {"),
    "readout": ("\n      for (int kk = 0; kk < n_sq * 16; kk += 16) {\n"
                "        uint32_t a[4];\n",
                "\n      for (int kk = 0; kk < 0; kk += 16) {\n"
                "        uint32_t a[4];\n"),
    "intra": ("for (int jt = 0; jt <= it; jt += 2) {",
              "for (int jt = 0; jt < 0; jt += 2) {"),
    "state": ("for (int u = warp; u < bh * n_pq * sn; u += kWarps) {",
              "for (int u = warp; u < 0; u += kWarps) {"),
}
VARIANTS = {"full": (), **{f"no_{p}": (p,) for p in CUTS},
            "none_of_them": tuple(CUTS)}
CHUNKS = (32, 64, 128, 256)


def build_variants() -> dict:
    """Each variant's library, bound like ``_build.load``: one nvcc per
    source, all started together, into ``build/kernels/ssd_phases``."""
    src = (_build.CSRC / "ssd.cu").read_text()
    out = _build.BUILD_DIR / "ssd_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        text = src
        for phase in cuts:
            old, new = CUTS[phase]
            if text.count(old) != 1:
                raise RuntimeError(f"ssd.cu no longer has the {phase} loop "
                                   f"this tool cuts: {old.strip()!r}")
            text = text.replace(old, new)
        cu = out / f"ssd_{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
               str(out / f"libssd_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    restype, argtypes = _build.SIGNATURES["ssd"]["ssd_launch"]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"libssd_{name}.so"))
        lib.ssd_launch.restype, lib.ssd_launch.argtypes = restype, argtypes
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results"
                                         / "ssd_phase_times.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_phase_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _, smi = cs.phase_device()
    libs = build_variants()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = []
    try:
        for target, x in cs.SSD_TARGETS:
            one = cs.ssd_operands(x, torch.bfloat16, gen, dev)
            nbytes = sum(t.numel() * t.element_size() for t in one)
            n_calls = max(1, min(16, math.ceil(2.5 * cs.L2_BYTES / nbytes)))
            sets = [one] + [cs.ssd_operands(x, torch.bfloat16, gen, dev)
                            for _ in range(n_calls - 1)]
            for chunk in CHUNKS:
                cfg = ops.shrink_ssd_cfg(
                    {"chunk": chunk, "b_heads": 1, "acc32": 1, "prefetch": 3},
                    x["L"], x["H"], x["P"], x["S"], 16)
                ms = {}
                for name, lib in libs.items():
                    _build._LIBS["ssd"] = lib
                    ms[name] = cs.time_ms(
                        lambda i: ops.ssd_scan(*sets[i], cfg), n_calls)
                cost = {p: ms["full"] - ms[f"no_{p}"] for p in CUTS}
                rows.append({"target": target, **x, "cfg": cfg, "ms": ms,
                             "phase_ms": cost, "device": smi})
                print(f"{target} chunk={cfg['chunk']} prefetch="
                      f"{cfg['prefetch']}: full {ms['full']:.4f} ms; phase "
                      "cost (full less the cut) " + ", ".join(
                          f"{p} {c:.4f}" for p, c in cost.items())
                      + f"; with all four cut {ms['none_of_them']:.4f} ms "
                      f"[{smi}]", flush=True)
            del sets, one
    finally:
        _build._LIBS.pop("ssd", None)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
