"""``python -m repro_torch.tunedb`` — tune shapes into a record store.

  tune   train (or load) an input-aware tuner whose labels are timings of
         the port's own kernels (``CheckedBackend(CudaEventBackend)``: the
         correctness gate, then CUDA events on the card), run a tuning
         session over explicit ``--shape`` jobs, and append one record per
         shape (plus the measured top-k losers as ``sample`` records)

  $ python -m repro_torch.tunedb tune --space gemm --shape M=4,N=576,K=576 \\
        --store tunedb.jsonl                                   # on the card
  $ python -m repro_torch.tunedb tune --device cpu --space conv \\
        --shape N=2,H=8,W=8,C=16,K=32,R=3,S=3 --train-samples 64 --epochs 2 \\
        --store /tmp/tunedb.jsonl           # the loop on the host (plain)
  $ python -m repro_torch.tunedb tune --space attention --train-samples 64 \\
        --shape B=4,Hq=9,Hkv=3,Lq=1,Lkv=256,D=64 --store tunedb.jsonl
  $ python -m repro_torch.tunedb tune --space ssd --train-samples 64 \\
        --shape B=1,L=2048,H=64,P=64,S=128 --store tunedb.jsonl

``--space`` is one of gemm, conv, attention, ssd; a ``--shape`` may omit
``dtype_bits`` (16), ``trans_a``/``trans_b`` (0) and ``causal`` (1).

The training draws come from the reference's ``workload_inputs``
distribution whatever the ``--shape``s are.  For attention and SSD on the
card that distribution does not fit: it draws attention up to B=64,
Hq=64, Lq=Lkv=32768, D=256 (q alone 68.7 GB in bf16; with k and v past
the card's 80 GB) and SSD up to B=64, L=65536; the first eight attention
draws of seed 0 include calls of 3e13-7e13 FLOPs, seconds each with this
kernel before the correctness gate's plain version and oracle run at the
same size.  So these two spaces are tuned on the card from draws around
the model's shapes (``chip_smoke.py`` does so with the library's pieces),
and with this CLI on the CPU (``--device cpu``: shrunken instances).

The records carry ``backend_fingerprint`` of the timing backend, which
names the package, the backend class and the device (not ``--seed``, which
seeds the training draws and the regressor); serving pins its lookups to
the same string (``repro_torch.launch.serve`` does by default).
The reference's other subcommands (train/predict/models, retune/watch,
fleet, plan, trace, stats/export/merge, fsck) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

# optional input params a --shape may omit
_SHAPE_DEFAULTS = {"dtype_bits": 16, "trans_a": 0, "trans_b": 0, "causal": 1}


def parse_shape(spec: str, space) -> Dict[str, int]:
    """'M=4096,N=16,K=2560' -> the full input dict of ``space``."""
    given: Dict[str, int] = {}
    for part in spec.split(","):
        if not part:
            continue
        k, eq, v = part.partition("=")
        if not eq:
            raise SystemExit(f"bad --shape entry {part!r} (want k=v)")
        given[k.strip()] = int(v)
    inputs = {}
    for name in space.input_params:
        if name in given:
            inputs[name] = given.pop(name)
        elif name in _SHAPE_DEFAULTS:
            inputs[name] = _SHAPE_DEFAULTS[name]
        else:
            raise SystemExit(f"--shape {spec!r} missing input param {name!r} "
                             f"(space {space.name} needs {space.input_params})")
    if given:
        raise SystemExit(f"--shape {spec!r}: unknown params {sorted(given)}")
    return inputs


def _cmd_tune(args: argparse.Namespace) -> int:
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    from repro_torch.core.space import SPACES
    from repro_torch.core.tuner import InputAwareTuner

    from .session import TuningSession, backend_fingerprint
    from .store import RecordStore

    space = SPACES[args.space]
    shapes = [parse_shape(s, space) for s in args.shape]
    backend = CheckedBackend(CudaEventBackend(device=args.device))
    store = RecordStore.open(args.store)
    if args.load_tuner:
        tuner = InputAwareTuner.load(args.load_tuner, space, backend=backend)
    else:
        print(f"[tunedb] training {args.space} tuner on "
              f"{backend_fingerprint(backend)} ({args.train_samples} "
              f"samples, {args.epochs} epochs)...", flush=True)
        tuner = InputAwareTuner.train(
            space, backend=backend, n_samples=args.train_samples,
            epochs=args.epochs, seed=args.seed)
        if args.save_tuner:
            tuner.save(args.save_tuner)
    tuner.top_k = args.top_k
    session = TuningSession(tuner, store, workers=args.workers,
                            remeasure=not args.no_remeasure,
                            skip_existing=not args.retune)
    report = session.run(shapes, verbose=True)
    print(f"[tunedb] session done: {report.tuned} tuned, {report.skipped} "
          f"skipped, {report.failed} failed in {report.wall_s:.1f}s -> "
          f"{args.store}")
    for err in report.errors:
        print(f"[tunedb]   failed: {err}", file=sys.stderr)
    return 1 if report.failed else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.tunedb",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tune", help="tune shapes into a store")
    t.add_argument("--space", default="gemm",
                   choices=["gemm", "conv", "attention", "ssd"])
    t.add_argument("--store", required=True, help="JSONL record store")
    t.add_argument("--shape", action="append", required=True,
                   help="shape to tune, e.g. M=4,N=576,K=576 (repeatable)")
    t.add_argument("--device", default=None,
                   help="cuda (default) or cpu; cuda without a GPU fails")
    t.add_argument("--workers", type=int, default=4,
                   help="session threads (measurements are serialised)")
    t.add_argument("--train-samples", type=int, default=8000)
    t.add_argument("--epochs", type=int, default=25)
    t.add_argument("--top-k", type=int, default=10,
                   help="configs re-measured per shape after the search")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--no-remeasure", action="store_true",
                   help="trust the model; skip top-k re-measurement")
    t.add_argument("--retune", action="store_true",
                   help="re-tune shapes already present in the store")
    t.add_argument("--load-tuner", default=None,
                   help="load a trained tuner dir instead of training")
    t.add_argument("--save-tuner", default=None)
    t.set_defaults(fn=_cmd_tune)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
