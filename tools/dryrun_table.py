"""The dry-run sweep's table, one row an (arch, shape), from a directory of
artifacts (``python -m repro_torch.launch.dryrun --all --out DIR``):
per-rank FLOPs, peak memory (argument + temp, and whether it fits 80 GB),
collective bytes, the roofline's bottleneck and MODEL/HLO at the pod and
multipod meshes, and the cells' walls.

    python tools/dryrun_table.py results/dryrun_torch

Model figures at the H100 SXM peaks (``analysis/roofline.py``), not card
measurements.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.roofline import roofline_from_artifacts  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES  # noqa: E402

MESHES = ("pod", "multipod")


def _load(root: Path, arch: str, shape: str, mesh: str):
    path = root / f"{arch}--{shape}--{mesh}.json"
    return json.loads(path.read_text()) if path.exists() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", type=Path)
    args = ap.parse_args(argv)
    head = ("| arch | shape | FLOPs/dev pod / multipod | peak/dev GB pod "
            "(argument + temp) / multipod | coll/dev B pod | bound | "
            "MODEL/HLO pod / multipod | wall s pod / multipod |")
    print(head)
    print("|" + "---|" * (head.count("|") - 1))
    run = failed = 0
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            arts = {m: _load(args.dir, arch, shape, m) for m in MESHES}
            if any(a is None for a in arts.values()):
                failed += 1
                print(f"| {arch} | {shape} | missing |")
                continue
            if "skipped" in arts["pod"]:
                continue
            run += 2
            rt = {m: roofline_from_artifacts(a) for m, a in arts.items()}
            mem = {m: a["memory"] for m, a in arts.items()}
            fits = lambda m: " **fits**" if mem[m]["fits"] else ""
            row = (f"| {arch} | {shape} "
                   f"| {arts['pod']['cost']['flops']:.3e} / "
                   f"{arts['multipod']['cost']['flops']:.3e} "
                   f"| {mem['pod']['peak_per_device'] / 1e9:.1f} "
                   f"({mem['pod']['argument'] / 1e9:.1f} + "
                   f"{mem['pod']['temp'] / 1e9:.1f}){fits('pod')} / "
                   f"{mem['multipod']['peak_per_device'] / 1e9:.1f}"
                   f"{fits('multipod')} "
                   f"| {arts['pod']['collectives']['total']:.3e} "
                   f"| {rt['pod'].bottleneck} "
                   f"| {rt['pod'].useful_ratio:.3f} / "
                   f"{rt['multipod'].useful_ratio:.3f} "
                   f"| {arts['pod']['wall_s']:.1f} / "
                   f"{arts['multipod']['wall_s']:.1f} |")
            print(row)
    print(f"\n{run} cells run, {failed} (arch, shape) pairs missing")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
