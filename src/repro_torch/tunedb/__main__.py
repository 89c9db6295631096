"""``python -m repro_torch.tunedb`` — tune shapes into a record store,
train the performance models that serve the shapes nobody tuned, and
export the frozen dispatch plans serving starts from.

  tune     train (or load) an input-aware tuner whose labels are timings of
           the port's own kernels (``CheckedBackend(CudaEventBackend)``: the
           correctness gate, then CUDA events on the card), run a tuning
           session over explicit ``--shape`` jobs and/or the hot shapes of a
           ``--telemetry`` dump (``--shapes-from-telemetry``), and append one
           record per shape (plus the measured top-k losers as ``sample``
           records); ``--progress`` makes the session resumable
  train    label ``--samples-per-shape`` random legal configs at every
           tuned shape through the same gated backend (``sample`` records),
           then train one regressor per (space, backend) from the store's
           whole log into ``<store>.models/`` (dispatch's model tier)
  predict  the model's pick (and top-k) for a ``--shape``; reads artifacts
  models   the artifacts' metadata as JSON; reads artifacts
  plan export   compile the store (its records, the model tier and a
           ``--telemetry`` dump's hot set) into a plan artifact under
           ``<store>.plan/<generation>/`` (``ServeConfig.plan_dir``)
  plan inspect  verify an artifact (schema, digest) and print its manifest
  plan publish  compile the store and publish it as a registry's next
           generation (``<registry>/generations/<n>/`` and ``CURRENT.json``)
  plan follow   poll a registry and install each new generation (digest
           verified, sentry-diffed)
  fleet start   create a fleet directory (the bus) and publish jobs (mined
           from ``--telemetry`` or explicit ``--shape``s); ``--workers N``
           starts N local worker processes and waits for them
  fleet worker  claim jobs (the hottest first), tune them on ``--device``
           (cuda by default) and append to the worker's own shard
  fleet status  queue, lease, done and failed counts and shard sizes
           (``--json``: the ``/status`` document with its fleet section)
  fleet drain   tell the workers to exit once the queue is empty;
           ``--wait`` merges the shards, ``--train`` retrains,
           ``--publish`` publishes the merged store's plan
  fleet route   dry-run one routing decision of a ``--shape`` request
           against the per-replica registries of ``publish_replica_plans``
  retune   one retune-controller pass over a telemetry dump: diff it against
           the saved epoch baseline (``<telemetry>.epoch``); when drift or
           untuned mass crosses its threshold, tune the novel hot shapes,
           retrain the affected regressors and advance the baseline
  watch    ``retune`` passes every ``--interval`` seconds (``--max-polls``)
  diff     the regression sentry over two generations: two store files or
           two plan snapshots (``{"entries": [...]}``); exit 1 when the new
           one serves a slower record (beyond ``--margin``) or drops a
           planned shape
  stats    the store's statistics (and a ``--telemetry`` dump's) as JSON;
           ``--json`` prints the ``/status`` document instead
           (``obs.status_snapshot``, the status endpoint's serializer;
           ``--fleet`` adds a fleet bus's section)
  trace export   merge span files (JSONL dumps or Chrome trace JSON; torn
           files are skipped; ``--fleet``: the workers' dumps) into one
           Chrome trace (Perfetto)
  trace summary  per-span-name counts and latencies and the dispatch
           tiers' resolution latency over span files
  serve-status   the HTTP status endpoint (``/metrics``, ``/status``,
           ``/plan``, ``/trace``, ``/healthz``) over a store file (and a
           ``--fleet`` bus)
  export   write a compacted store: the latest record per shape
  merge    fold stores into one (``--out``)

  $ python -m repro_torch.tunedb tune --space gemm --shape M=4,N=576,K=576 \\
        --store tunedb.jsonl                                   # on the card
  $ python -m repro_torch.tunedb tune --device cpu --space conv \\
        --shape N=2,H=8,W=8,C=16,K=32,R=3,S=3 --train-samples 64 --epochs 2 \\
        --store /tmp/tunedb.jsonl           # the loop on the host (plain)
  $ python -m repro_torch.tunedb tune --space attention --train-samples 64 \\
        --shape B=4,Hq=9,Hkv=3,Lq=1,Lkv=256,D=64 --store tunedb.jsonl
  $ python -m repro_torch.tunedb tune --space ssd --train-samples 64 \\
        --shape B=1,L=2048,H=64,P=64,S=128 --store tunedb.jsonl
  $ python -m repro_torch.tunedb train --space gemm --store tunedb.jsonl
  $ python -m repro_torch.tunedb predict --space gemm --shape M=100,N=576,K=576 \\
        --store tunedb.jsonl
  $ python -m repro_torch.tunedb models --store tunedb.jsonl
  $ python -m repro_torch.tunedb plan export --store tunedb.jsonl \
        --telemetry shapes.json                 # -> tunedb.jsonl.plan/00000001
  $ python -m repro_torch.tunedb plan inspect tunedb.jsonl.plan/00000001
  $ python -m repro_torch.tunedb tune --space gemm --shapes-from-telemetry \
        --telemetry shapes.json --progress tune.progress \
        --train-samples 512 --store tunedb.jsonl
  $ python -m repro_torch.tunedb retune --telemetry shapes.json \
        --store tunedb.jsonl --train-samples 512      # the tuner on the card
  $ python -m repro_torch.tunedb watch --telemetry shapes.json \
        --store tunedb.jsonl --interval 60 --device cpu --train-samples 400
  $ python -m repro_torch.tunedb diff old.jsonl new.jsonl --json
  $ python -m repro_torch.tunedb stats --store tunedb.jsonl [--json]
  $ python -m repro_torch.tunedb trace summary --input spans.json
  $ python -m repro_torch.tunedb trace export --input a.jsonl \
        --input b.json --out merged.json
  $ python -m repro_torch.tunedb serve-status --store tunedb.jsonl \
        --port 9177
  $ python -m repro_torch.tunedb merge a.jsonl b.jsonl --out all.jsonl
  $ python -m repro_torch.tunedb fleet start --fleet /tmp/fleet \
        --store tunedb.jsonl --telemetry shapes.json --drain
  $ python -m repro_torch.tunedb fleet worker --fleet /tmp/fleet \
        --load-tuner tuners/                     # one per process, the card
  $ python -m repro_torch.tunedb fleet drain --fleet /tmp/fleet --wait \
        --train --publish registry/
  $ python -m repro_torch.tunedb fleet start --fleet /tmp/fleet \
        --store /tmp/db.jsonl --space gemm --shape M=4,N=576,K=576 \
        --workers 2 --device cpu --worker-train-samples 64 --worker-epochs 2
  $ python -m repro_torch.tunedb plan publish --store tunedb.jsonl \
        --registry registry/
  $ python -m repro_torch.tunedb plan follow --registry registry/ \
        --max-polls 10 --interval 1
  $ python -m repro_torch.tunedb fleet route --registry-root replicas/ \
        --space gemm --shape M=32,N=576,K=576

``--space`` is one of gemm, conv, attention, ssd; a ``--shape`` may omit
``dtype_bits`` (16), ``trans_a``/``trans_b`` (0) and ``causal`` (1).

The training draws come from the reference's ``workload_inputs``
distribution whatever the ``--shape``s are.  That distribution reaches
past the card (attention up to B=64, Hq=64, Lq=Lkv=32768, D=256: q alone
68.7 GB in bf16; SSD up to B=64, L=65536; conv calls of petaFLOPs), so on
the card a draw whose call exceeds ``core.backend.FLOP_BUDGET``, whose
tensors, the correctness gate's plain version and fp32 oracle included,
exceed ``MEM_SHARE`` of the free device memory, or (SSD) whose gate oracle
exceeds ``SSD_STEP_BUDGET`` sequential steps is dropped and drawn again
(``CudaEventBackend.fits``); the CPU backend refuses nothing, so there
the draws are the reference's.

The records carry ``backend_fingerprint`` of the timing backend, which
names the package, the backend class and the device (not ``--seed``, which
seeds the training draws and the regressor); serving pins its lookups to
the same string (``repro_torch.launch.serve`` does by default).
``retune``, ``watch`` and ``fleet worker`` train a tuner per space they
tune (``--train-samples``, labelled on ``--device``) unless
``--load-tuner`` gives one (a directory of ``InputAwareTuner.save``
files, one set a space).  The reference's ``fsck`` waits for the chaos
slice (ROADMAP A6.4).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import time
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

    from .telemetry import ShapeTelemetry

    space = SPACES[args.space]
    telemetry = None
    if args.shapes_from_telemetry:
        if not args.telemetry:
            raise SystemExit("--shapes-from-telemetry needs --telemetry PATH")
        if not os.path.exists(args.telemetry):
            raise SystemExit(f"telemetry file not found: {args.telemetry}")
        telemetry = ShapeTelemetry.load(args.telemetry)
    shapes = [parse_shape(s, space) for s in args.shape]
    if telemetry is None and not shapes:
        raise SystemExit("need --shapes-from-telemetry and/or --shape")
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
    session = TuningSession(tuner, store, telemetry, workers=args.workers,
                            remeasure=not args.no_remeasure,
                            skip_existing=not args.retune,
                            progress_path=args.progress)
    reports = []
    if telemetry is not None:
        reports.append(session.run(verbose=True))       # the mined hot set
    if shapes:
        reports.append(session.run(shapes, verbose=True))
    tuned = sum(r.tuned for r in reports)
    failed = sum(r.failed for r in reports)
    print(f"[tunedb] session done: {tuned} tuned, "
          f"{sum(r.skipped for r in reports)} skipped, {failed} failed in "
          f"{sum(r.wall_s for r in reports):.1f}s -> {args.store}")
    for r in reports:
        for err in r.errors:
            print(f"[tunedb]   failed: {err}", file=sys.stderr)
    return 1 if failed else 0


def _cmd_train(args: argparse.Namespace) -> int:
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend

    from .model import collect_samples, default_models_dir, train_models
    from .store import RecordStore

    store = RecordStore.open(args.store)
    if not store.records():
        print(f"[tunedb] store {args.store} has no records; run `tune` first",
              file=sys.stderr)
        return 1
    if args.samples_per_shape > 0:
        backend = CheckedBackend(CudaEventBackend(device=args.device))
        n = collect_samples(store, backend, per_shape=args.samples_per_shape,
                            space=args.space, seed=args.seed)
        print(f"[tunedb] collected {n} exploration samples "
              f"({args.samples_per_shape}/shape) on {backend.fingerprint}")
    models = train_models(store, space=args.space, hidden=args.hidden,
                          epochs=args.epochs, seed=args.seed,
                          min_samples=args.min_samples, verbose=True)
    if not len(models):
        print("[tunedb] no (space, backend) group had enough samples; "
              "try --samples-per-shape", file=sys.stderr)
        return 1
    out = args.models_dir or default_models_dir(args.store)
    models.save(out)
    print(f"[tunedb] saved {len(models)} model(s) -> {out}")
    for key, meta in models.stats()["models"].items():
        mse = meta["val_mse"]
        print(f"[tunedb]   {key}: {meta['n_samples']} samples, "
              f"val mse {'n/a' if mse is None else f'{mse:.4f}'}")
    return 0


def _cmd_predict(args: argparse.Namespace) -> int:
    from repro_torch.core.space import SPACES

    from .model import ModelSet, default_models_dir

    space = SPACES[args.space]
    models = ModelSet.load(args.models_dir or default_models_dir(args.store))
    pm = models.resolve_model(args.space, args.backend)
    if pm is None:
        have = sorted(f"{s}/{b}" for s, b in models.models)
        print(f"[tunedb] no model for space {args.space!r}"
              + (f" backend {args.backend!r}" if args.backend else "")
              + f"; available: {have or 'none'} (run `train` first)",
              file=sys.stderr)
        return 1
    for spec in args.shape:
        inputs = parse_shape(spec, space)
        try:
            res = pm.predict_config(inputs, top_k=args.top_k)
        except ValueError as e:          # no legal configuration
            print(f"[tunedb] predict failed for {spec!r}: {e}",
                  file=sys.stderr)
            return 1
        print(json.dumps({
            "space": args.space, "backend": pm.backend, "inputs": inputs,
            "config": res.best,
            "predicted_tflops": round(res.predicted_tflops, 3),
            "n_candidates": res.n_candidates,
            "top_k": [{"config": c, "predicted_tflops": round(p, 3)}
                      for c, p in res.top_k],
        }, sort_keys=True))
    return 0


def _cmd_models(args: argparse.Namespace) -> int:
    from .model import ModelSet, default_models_dir

    models = ModelSet.load(args.models_dir or default_models_dir(args.store))
    print(json.dumps(models.stats(), indent=1, sort_keys=True))
    return 0 if len(models) or not models.skipped else 1


def _compile_plan_from_args(args: argparse.Namespace):
    """(store, DispatchPlan) compiled from --store/--models-dir/--telemetry."""
    from .model import ModelSet, default_models_dir
    from .store import RecordStore, compile_plan
    from .telemetry import ShapeTelemetry

    store = RecordStore.open(args.store)
    models = None
    if not args.no_models:
        mdir = pathlib.Path(args.models_dir or default_models_dir(args.store))
        if mdir.is_dir():
            loaded = ModelSet.load(mdir)
            if len(loaded):
                models = loaded
    telemetry = None
    if args.telemetry and os.path.exists(args.telemetry):
        telemetry = ShapeTelemetry.load(args.telemetry)
    plan = compile_plan(store, models, args.backend,
                        telemetry=telemetry, hot_k=args.hot_k)
    if plan is None or not len(plan):
        raise SystemExit(f"[tunedb] nothing to plan: store {args.store} has "
                         "no serving records under this fingerprint")
    return store, plan


def _cmd_plan_export(args: argparse.Namespace) -> int:
    from .plans import PlanArtifactError, default_plan_dir, export_plan

    store, plan = _compile_plan_from_args(args)
    out = args.out or default_plan_dir(store.path)
    try:
        dest = export_plan(plan, out, store=store,
                           generation=args.generation)
    except PlanArtifactError as e:
        print(f"[tunedb] plan export refused: {e}", file=sys.stderr)
        return 1
    print(f"[tunedb] exported plan ({len(plan)} entries) -> {dest}")
    return 0


def _cmd_plan_inspect(args: argparse.Namespace) -> int:
    from .plans import PlanArtifactError, load_plan, read_manifest

    try:
        manifest = read_manifest(args.plan_dir)
        plan = load_plan(args.plan_dir)      # digest and schema verified
    except PlanArtifactError as e:
        print(f"[tunedb] plan artifact rejected: {e}", file=sys.stderr)
        return 1
    out = dict(manifest.to_dict())
    out["verified"] = True
    out["tiers"] = plan.stats()["tiers"]
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def _build_retune_controller(args: argparse.Namespace, telemetry, baseline,
                             tuners=None):
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    from repro_torch.core.space import SPACES
    from repro_torch.core.tuner import InputAwareTuner

    from .controller import RetuneConfig, RetuneController
    from .model import default_models_dir
    from .store import RecordStore

    def tuner_factory(space_name: str):
        backend = CheckedBackend(CudaEventBackend(device=args.device))
        if args.load_tuner:
            return InputAwareTuner.load(args.load_tuner, SPACES[space_name],
                                        backend=backend)
        print(f"[tunedb] training {space_name} tuner on "
              f"{backend.fingerprint} ({args.train_samples} samples, "
              f"{args.epochs} epochs)...", flush=True)
        return InputAwareTuner.train(
            SPACES[space_name], backend=backend,
            n_samples=args.train_samples, epochs=args.epochs, seed=args.seed)

    store = RecordStore.open(args.store)
    return RetuneController(
        store, telemetry=telemetry, tuners=tuners,
        tuner_factory=tuner_factory,
        models_dir=(None if args.no_train
                    else args.models_dir or default_models_dir(args.store)),
        cfg=RetuneConfig(
            drift_threshold=args.drift, untuned_mass_threshold=args.untuned,
            min_calls=args.min_calls, top_k_shapes=args.top_k,
            workers=args.workers, retrain=not args.no_train, seed=args.seed,
            publish=args.publish),
        baseline=baseline, verbose=True)


def _baseline_path(args: argparse.Namespace) -> str:
    return args.baseline or args.telemetry + ".epoch"


def _load_baseline(args: argparse.Namespace):
    from .telemetry import ShapeTelemetry

    path = _baseline_path(args)
    if os.path.exists(path):
        return ShapeTelemetry.load(path).snapshot()
    return ShapeTelemetry().snapshot()      # the first epoch: all is new


def _retune_pass(args: argparse.Namespace, tuner_cache=None) -> int:
    """One detect (+ tune + train + baseline advance) pass; the shapes
    tuned, or -1 without a telemetry file.  ``tuner_cache`` carries trained
    tuners across the watch loop's per-poll controllers."""
    from .telemetry import ShapeTelemetry

    if not os.path.exists(args.telemetry):
        print(f"[tunedb] telemetry file not found: {args.telemetry}",
              file=sys.stderr)
        return -1
    telemetry = ShapeTelemetry.load(args.telemetry)
    controller = _build_retune_controller(args, telemetry,
                                          _load_baseline(args), tuner_cache)
    decisions = controller.check()
    for dec in decisions.values():
        print(f"[retune:{dec.space}] {dec.reason or 'steady'}: drift "
              f"{dec.drift:.3f} (>= {args.drift} triggers), untuned mass "
              f"{dec.untuned_mass:.3f} (>= {args.untuned} triggers), "
              f"{dec.window_calls} window calls, "
              f"{len(dec.novel_shapes)} novel hot shapes")
    report = (controller.force_retune(decisions) if args.force
              else controller.maybe_retune(decisions))
    if tuner_cache is not None:
        tuner_cache.update(controller.tuners())
    if report is None:
        print("[tunedb] no retune: traffic within thresholds")
        return 0
    # the consumed telemetry is the next epoch's baseline
    shutil.copyfile(args.telemetry, _baseline_path(args))
    print(f"[tunedb] retuned {report.tuned} shape(s) in {report.wall_s:.1f}s; "
          f"retrained {report.retrained or 'nothing'}; serving generation "
          f"{report.generation} -> {args.store}")
    return report.tuned


def _cmd_retune(args: argparse.Namespace) -> int:
    return 1 if _retune_pass(args) < 0 else 0


def _cmd_watch(args: argparse.Namespace) -> int:
    polls = 0
    tuner_cache: Dict[str, object] = {}     # trained once, reused per poll
    while True:
        polls += 1
        print(f"[tunedb] watch poll {polls}"
              + (f"/{args.max_polls}" if args.max_polls else ""), flush=True)
        _retune_pass(args, tuner_cache)     # a missing dump is "not yet"
        if args.max_polls and polls >= args.max_polls:
            return 0
        time.sleep(args.interval)


def _load_generation(path: str):
    """A diffable generation: ("plan", dict) for a plan snapshot (a JSON
    object with ``entries``), else ("store", RecordStore)."""
    from .store import RecordStore

    with open(path, "r", encoding="utf-8") as fh:
        head = fh.read(4096).lstrip()
    if head.startswith("{"):
        try:
            doc = json.loads(pathlib.Path(path).read_text())
        except ValueError:
            doc = None
        if isinstance(doc, dict) and "entries" in doc:
            return "plan", doc
    return "store", RecordStore.open(path)


def _fmt_inputs(inputs) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(inputs.items()))


def _cmd_diff(args: argparse.Namespace) -> int:
    from .obs import RegressionSentry

    sentry = RegressionSentry(noise_margin=args.margin)
    old_kind, old = _load_generation(args.old)
    new_kind, new = _load_generation(args.new)
    if old_kind != new_kind:
        print(f"[tunedb] cannot diff a {old_kind} against a {new_kind}",
              file=sys.stderr)
        return 2
    report = (sentry.diff_plans(old, new) if old_kind == "plan"
              else sentry.diff_stores(old, new))
    if args.json:
        print(json.dumps(report.to_dict(), indent=1, sort_keys=True))
        return 0 if report.ok else 1
    print(f"[tunedb] diff {args.old} -> {args.new}: "
          f"{report.checked} shared key(s) checked, "
          f"{report.improved} improved, {report.unchanged} unchanged, "
          f"{report.added} added, {report.removed} removed "
          f"(noise margin {report.noise_margin:.0%})")
    for reg in report.regressions:
        if reg.old_tflops > 0:
            print(f"[tunedb]   REGRESSED {reg.space} "
                  f"{_fmt_inputs(reg.inputs)} [{reg.backend}]: "
                  f"{reg.old_tflops:.2f} -> {reg.new_tflops:.2f} "
                  f"TFLOPS (-{reg.drop:.0%})")
        else:
            print(f"[tunedb]   DROPPED {reg.space} "
                  f"{_fmt_inputs(reg.inputs)}: planned entry missing "
                  f"from the new generation")
    verdict = ("OK" if report.ok
               else f"{len(report.regressions)} regression(s)")
    print(f"[tunedb] verdict: {verdict}")
    return 0 if report.ok else 1


def _cmd_stats(args: argparse.Namespace) -> int:
    from .store import RecordStore
    from .telemetry import ShapeTelemetry

    store = RecordStore.open(args.store)
    telemetry = None
    if args.telemetry and os.path.exists(args.telemetry):
        telemetry = ShapeTelemetry.load(args.telemetry)
    if args.json:
        # the /status schema: one serializer for the CLI and the endpoint
        from .obs import status_snapshot
        out = status_snapshot(store=store, telemetry=telemetry,
                              fleet=args.fleet)
    else:
        out = {"store": store.stats()}
        if telemetry is not None:
            out["telemetry"] = telemetry.stats()
    print(json.dumps(out, indent=1, sort_keys=True, default=str))
    return 0


def _trace_spans(args: argparse.Namespace) -> list:
    """The spans of a ``--fleet``'s worker dumps and of every ``--input``
    file; a torn file is skipped."""
    from .obs.trace import collect_fleet_spans, load_span_file

    spans = []
    if args.fleet:
        spans.extend(collect_fleet_spans(args.fleet))
    for path in args.inputs or []:
        spans.extend(load_span_file(path))
    return spans


def _cmd_trace_export(args: argparse.Namespace) -> int:
    from .obs.trace import chrome_trace

    spans = _trace_spans(args)
    doc = chrome_trace(spans, pid=0)    # a merged view: no one process
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc))
    print(f"[trace] wrote {len(spans)} span(s) -> {out} "
          "(open in https://ui.perfetto.dev)")
    return 0


def _cmd_trace_summary(args: argparse.Namespace) -> int:
    from .obs.trace import summarize_spans

    summary = summarize_spans(_trace_spans(args))
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True, default=str))
        return 0
    print(f"spans: {summary['spans']}  traces: {summary['traces']}")
    for name, ent in sorted(summary["names"].items()):
        print(f"  {name:<20} x{int(ent['count']):<6} "
              f"mean {ent['mean_us']:.1f}us  max {ent['max_us']:.1f}us")
    if summary["tiers"]:
        print("dispatch tiers:")
        for tier, ent in sorted(summary["tiers"].items()):
            print(f"  {tier:<20} x{int(ent['count']):<6} "
                  f"mean {ent['mean_us']:.1f}us")
    return 0


def _cmd_serve_status(args: argparse.Namespace) -> int:
    from .obs import StatusServer
    from .store import RecordStore, install_serving
    from .telemetry import ShapeTelemetry

    store = telemetry = None
    if args.store and os.path.exists(args.store):
        store = RecordStore.open(args.store)
        # the store becomes the process's serving state, so the /metrics
        # collectors and /plan see it as an engine's would
        install_serving(store=store, fingerprint=args.backend)
    if args.telemetry and os.path.exists(args.telemetry):
        telemetry = ShapeTelemetry.load(args.telemetry)
    server = StatusServer(host=args.host, port=args.port, store=store,
                          telemetry=telemetry, fleet=args.fleet).start()
    print(f"[tunedb] status endpoint on {server.url} "
          "(/metrics /status /plan /trace /healthz); Ctrl-C stops it",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _cmd_export(args: argparse.Namespace) -> int:
    from .store import RecordStore

    n = RecordStore.open(args.store).export(args.out)
    print(f"[tunedb] exported {n} records -> {args.out}")
    return 0


def _cmd_merge(args: argparse.Namespace) -> int:
    from .store import RecordStore

    merged = RecordStore.open(args.out)
    total = 0
    for path in args.stores:
        total += merged.merge(RecordStore.open(path))
    print(f"[tunedb] merged {total} records from {len(args.stores)} "
          f"stores -> {args.out} ({len(merged)} shapes)")
    return 0


# ---------------------------------------------------------------------------
# fleet: distributed tuning over a shared directory
# ---------------------------------------------------------------------------

def _fleet_finalize(coord, args: argparse.Namespace, t0: float) -> int:
    """Wait out the outstanding jobs, merge, retrain (``--train``),
    publish (``--publish``) and report.  The report's done and failed
    counts are the directory's; the exit code judges this invocation:
    a failure that appeared while it waited, or a timeout."""
    from .model import default_models_dir

    failed_before = coord.fleet.counts()["failed"]
    ok = coord.wait(timeout_s=args.timeout if args.timeout > 0 else None,
                    poll_s=0.2, verbose=True)
    coord.poll()                         # the final merge
    retrained: List[str] = []
    if args.train and coord.affected:
        models_dir = args.models_dir or default_models_dir(coord.store.path)
        retrained = coord.retrain(models_dir=models_dir,
                                  min_samples=args.min_samples,
                                  epochs=args.epochs, seed=args.seed)
        print(f"[fleet] retrained {retrained or 'nothing'} -> {models_dir}")
    if args.publish:
        from .plans import PlanArtifactError
        try:
            man = coord.publish_plan(
                args.publish,
                models_dir=(args.models_dir
                            or default_models_dir(coord.store.path)))
            print(f"[fleet] published plan generation {man.generation} "
                  f"({man.n_entries} entries) -> {args.publish}")
        except (PlanArtifactError, ValueError) as e:
            print(f"[fleet] plan publish refused: {e}", file=sys.stderr)
    rep = coord.report(retrained=retrained, wall_s=time.time() - t0)
    print(json.dumps(rep.to_dict(), indent=1, sort_keys=True))
    if not ok:
        print(f"[fleet] timed out with {coord.outstanding()} job(s) "
              "outstanding", file=sys.stderr)
    if args.compact:
        if ok and coord.outstanding() == 0:
            archived = coord.compact_shards()
            print(f"[fleet] compacted {len(archived)} merged shard(s) "
                  f"-> {coord.fleet.shard_dir() / 'archive'}")
        else:
            print("[fleet] skipping --compact: jobs still outstanding",
                  file=sys.stderr)
    return 0 if ok and rep.failed <= failed_before else 1


def _add_fleet_finalize_args(sp) -> None:
    sp.add_argument("--timeout", type=float, default=0.0,
                    help="give up waiting after this many seconds "
                         "(0 = wait forever)")
    sp.add_argument("--train", action="store_true",
                    help="retrain the affected regressors after the merge")
    sp.add_argument("--models-dir", default=None,
                    help="retrained artifacts dir (default: <store>.models/)")
    sp.add_argument("--min-samples", type=int, default=24)
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--compact", action="store_true",
                    help="once every job landed and merged, archive the "
                         "merged shards out of <store>.shards/")
    sp.add_argument("--publish", default=None,
                    help="after the merge (and the --train retrain), "
                         "publish the merged store's plan to this registry "
                         "for serving replicas to follow")


def _spawn_workers(args: argparse.Namespace) -> List:
    """Start ``--workers`` local ``fleet worker`` processes on the bus,
    each with its own default id, this checkout first on their
    ``PYTHONPATH``."""
    import subprocess

    import repro_torch

    env = dict(os.environ)
    src_root = str(pathlib.Path(repro_torch.__file__).resolve().parents[1])
    env["PYTHONPATH"] = src_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.tunedb", "fleet", "worker",
           "--fleet", str(args.fleet),
           "--train-samples", str(args.worker_train_samples),
           "--epochs", str(args.worker_epochs)]
    if args.load_tuner:
        cmd += ["--load-tuner", args.load_tuner]
    if args.device:
        cmd += ["--device", args.device]
    procs = [subprocess.Popen(cmd, env=env) for _ in range(args.workers)]
    print(f"[fleet] spawned {len(procs)} local worker process(es): "
          f"{' '.join(str(p.pid) for p in procs)}", flush=True)
    return procs


def _reap_workers(procs: List) -> None:
    import subprocess

    for proc in procs:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            print(f"[fleet] worker pid {proc.pid} did not exit; terminating",
                  file=sys.stderr)
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


def _cmd_fleet_start(args: argparse.Namespace) -> int:
    from repro_torch.core.space import SPACES

    from .fleet import Coordinator, FleetJob
    from .store import RecordStore
    from .telemetry import ShapeTelemetry

    t0 = time.time()
    store = RecordStore.open(args.store)
    coord = Coordinator(args.fleet, store,
                        lease_timeout_s=args.lease_timeout,
                        max_attempts=args.max_attempts)
    jobs: List = []
    if args.telemetry:
        if not os.path.exists(args.telemetry):
            raise SystemExit(f"telemetry file not found: {args.telemetry}")
        telemetry = ShapeTelemetry.load(args.telemetry)
        jobs += coord.plan_from_telemetry(
            telemetry, spaces=[args.space] if args.space else None,
            top_k=args.top_k, backend=args.backend,
            skip_existing=not args.retune)
    if args.shape and not args.space:
        raise SystemExit("--shape needs --space")
    for spec in args.shape:
        jobs.append(FleetJob(space=args.space,
                             inputs=parse_shape(spec, SPACES[args.space])))
    if not jobs and not args.wait:
        print("[fleet] nothing to publish (no --telemetry/--shape jobs, or "
              "the store already serves them)", file=sys.stderr)
    # --retune also queues again jobs an earlier run of this directory
    # finished: a terminal marker must not pin a shape forever
    n = coord.publish(jobs, force=args.retune)
    print(f"[fleet] published {n} job(s) ({len(jobs) - n} already known) "
          f"-> {args.fleet}", flush=True)
    if args.workers > 0:
        args.drain = True               # spawned workers exit when it empties
    if args.drain:
        coord.fleet.request_drain()
    else:
        coord.fleet.clear_drain()
    procs = _spawn_workers(args) if args.workers > 0 else []
    if args.wait or procs:
        # --workers implies --wait: merge, report and reap the children
        # even when finalizing fails
        try:
            return _fleet_finalize(coord, args, t0)
        finally:
            _reap_workers(procs)
    return 0


def _launch_counts() -> Dict[str, int]:
    """This process's kernel launches (each wrapper's counter)."""
    from repro_torch.kernels import attention, conv, matmul, ssd

    return {"gemm": matmul.launches, "gemm_reduce": matmul.reduce_launches,
            "conv": conv.launches, "attention": attention.launches,
            "ssd": ssd.launches}


def _cmd_fleet_worker(args: argparse.Namespace) -> int:
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    from repro_torch.core.space import SPACES
    from repro_torch.core.tuner import InputAwareTuner

    from .fleet import Worker

    def tuner_factory(space_name: str):
        backend = CheckedBackend(CudaEventBackend(device=args.device))
        if args.load_tuner:
            return InputAwareTuner.load(args.load_tuner, SPACES[space_name],
                                        backend=backend)
        print(f"[fleet] training {space_name} tuner on "
              f"{backend.fingerprint} ({args.train_samples} samples, "
              f"{args.epochs} epochs)...", flush=True)
        return InputAwareTuner.train(
            SPACES[space_name], n_samples=args.train_samples,
            epochs=args.epochs, backend=backend, seed=args.seed)

    if args.trace_sample > 0:
        from .obs.trace import enable_tracing
        enable_tracing(args.trace_sample)
    worker = Worker(args.fleet, worker_id=args.worker_id,
                    tuner_factory=tuner_factory,
                    remeasure=not args.no_remeasure, verbose=True,
                    telemetry_export_s=args.telemetry_export,
                    trace_export=args.trace_sample > 0)
    print(f"[fleet] worker {worker.worker_id} claiming from {args.fleet}",
          flush=True)
    report = worker.run(
        max_jobs=args.max_jobs if args.max_jobs > 0 else None,
        idle_timeout_s=(args.idle_timeout if args.idle_timeout > 0
                        else None))
    print(f"[fleet] worker {report.worker_id}: {report.claimed} claimed, "
          f"{report.tuned} tuned, {report.failed} failed, {report.lost} "
          f"lost in {report.wall_s:.1f}s; kernel launches "
          f"{json.dumps(_launch_counts(), sort_keys=True)}", flush=True)
    for err in report.errors:
        print(f"[fleet]   failed: {err}", file=sys.stderr)
    return 1 if report.failed and not report.tuned else 0


def _cmd_fleet_status(args: argparse.Namespace) -> int:
    from .fleet import FleetDir

    if args.json or args.watch:
        # the /status schema off the bus: the endpoint's serializer
        from .obs import status_snapshot
        polls = 0
        while True:
            snap = status_snapshot(fleet=args.fleet)
            if args.watch:
                _print_fleet_line(snap)
            else:
                print(json.dumps(snap, indent=1, sort_keys=True,
                                 default=str))
            polls += 1
            if not args.watch or (args.max_polls and polls >= args.max_polls):
                return 0
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0
    fleet = FleetDir(args.fleet)
    out = fleet.status()
    report = fleet.root / "report.json"
    if report.exists():
        out["report"] = json.loads(report.read_text())
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def _print_fleet_line(snap: Dict) -> None:
    """One ``--watch`` line from the status document."""
    fleet = snap.get("fleet") or {}
    counts = fleet.get("counts") or {}
    report = fleet.get("report") or {}
    shards = fleet.get("shard_records") or {}
    print(f"[fleet] queue={counts.get('queue', 0)} "
          f"leases={counts.get('leases', 0)} done={counts.get('done', 0)} "
          f"failed={counts.get('failed', 0)} "
          f"shard_records={sum(shards.values())} "
          f"merged={report.get('merged_records', 0)} "
          f"sentry_blocked={report.get('sentry_blocked', 0)} "
          f"draining={bool(fleet.get('draining'))}", flush=True)


def _cmd_fleet_drain(args: argparse.Namespace) -> int:
    from .fleet import Coordinator, FleetDir

    t0 = time.time()
    FleetDir(args.fleet).request_drain()
    print(f"[fleet] drain requested: workers exit once {args.fleet} "
          "has an empty queue")
    if args.wait:
        return _fleet_finalize(Coordinator(args.fleet), args, t0)
    if args.compact:
        coord = Coordinator(args.fleet)
        coord.poll()                     # sweep and merge what landed
        if coord.outstanding() == 0:
            archived = coord.compact_shards()
            print(f"[fleet] compacted {len(archived)} merged shard(s) "
                  f"-> {coord.fleet.shard_dir() / 'archive'}")
        else:
            print(f"[fleet] skipping --compact: {coord.outstanding()} "
                  "job(s) still outstanding (use --wait)", file=sys.stderr)
    return 0


def _cmd_fleet_route(args: argparse.Namespace) -> int:
    """One routing decision, dry-run, against the per-replica registries
    ``Coordinator.publish_replica_plans`` writes: the ``--shape`` request
    scored against each replica's current plan by ``plan_coverage``."""
    from repro_torch.core.space import SPACES
    from repro_torch.serve.router import make_router, plan_coverage

    from .plans import PlanArtifactError, PlanRegistry

    if args.shape and not args.space:
        raise SystemExit("--shape needs --space")
    shapes = [(args.space, parse_shape(spec, SPACES[args.space]))
              for spec in args.shape]
    root = pathlib.Path(args.registry_root)
    replica_dirs = sorted(d for d in root.glob(args.glob) if d.is_dir())
    if not replica_dirs:
        raise SystemExit(f"[fleet] no replica registries matching "
                         f"{args.glob!r} under {root}")
    router = make_router(args.policy)
    plans: Dict[str, object] = {}
    for d in replica_dirs:
        reg = PlanRegistry(d)
        pointer = reg.current()
        plan = None
        if pointer is not None:
            try:
                plan = reg.pull(pointer)
            except PlanArtifactError as e:
                print(f"[fleet] {d.name}: plan rejected ({e})",
                      file=sys.stderr)
        plans[d.name] = plan
        router.add_replica(d.name, plan=plan)
    picked = router.route(shapes)
    out = {
        "policy": args.policy,
        "replica": picked.name,
        "outcome": next(iter(router.stats()["outcomes"])),
        "shapes": [{"space": s, "inputs": i} for s, i in shapes],
        "coverage": {name: plan_coverage(p, shapes)
                     for name, p in plans.items()},
        "plan_entries": {name: (len(p) if p is not None else 0)
                         for name, p in plans.items()},
    }
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def _cmd_plan_publish(args: argparse.Namespace) -> int:
    from .plans import PlanArtifactError, PlanRegistry

    store, plan = _compile_plan_from_args(args)
    try:
        manifest = PlanRegistry(args.registry).publish(plan, store=store)
    except PlanArtifactError as e:
        print(f"[tunedb] plan publish refused: {e}", file=sys.stderr)
        return 1
    print(f"[tunedb] published generation {manifest.generation} "
          f"({manifest.n_entries} entries, {manifest.digest}) "
          f"-> {args.registry}")
    return 0


def _cmd_plan_follow(args: argparse.Namespace) -> int:
    from .obs import RegressionSentry
    from .plans import PlanFollower
    from .store import RecordStore

    store = None
    if args.store and os.path.exists(args.store):
        store = RecordStore.open(args.store)
    sentry = None if args.no_sentry else RegressionSentry(
        noise_margin=args.margin)
    follower = PlanFollower(args.registry, store=store,
                            fingerprint=args.backend,
                            poll_s=args.interval, sentry=sentry)
    print(f"[tunedb] following {args.registry} every {args.interval:g}s; "
          "Ctrl-C stops", flush=True)
    polls = 0
    try:
        while True:
            installed = follower.poll_once()
            polls += 1
            if installed is not None:
                print(f"[tunedb] installed generation "
                      f"{installed['generation']} "
                      f"({installed.get('n_entries', '?')} entries, "
                      f"lag {follower.lag_s:.2f}s)", flush=True)
            if args.max_polls and polls >= args.max_polls:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        follower.stop()
    stats = follower.stats()
    print(json.dumps(stats, indent=1, sort_keys=True))
    return 0 if stats["installs"] or not args.max_polls else 1


def _hidden(spec: str):
    try:
        return tuple(int(x) for x in spec.split(",") if x)
    except ValueError:
        raise SystemExit(f"bad --hidden {spec!r} (want e.g. 64,128,64)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.tunedb",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tune", help="tune shapes into a store")
    t.add_argument("--space", default="gemm",
                   choices=["gemm", "conv", "attention", "ssd"])
    t.add_argument("--store", required=True, help="JSONL record store")
    t.add_argument("--shape", action="append", default=[],
                   help="shape to tune, e.g. M=4,N=576,K=576 (repeatable)")
    t.add_argument("--telemetry", default=None,
                   help="telemetry JSON dump (ShapeTelemetry.save)")
    t.add_argument("--shapes-from-telemetry", action="store_true",
                   help="tune the --telemetry dump's 8 hottest shapes of "
                        "--space")
    t.add_argument("--progress", default=None,
                   help="resumable progress file: a rerun skips the shapes "
                        "it lists as done")
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

    tr = sub.add_parser("train", help="train performance models from a store")
    tr.add_argument("--store", required=True, help="JSONL record store")
    tr.add_argument("--models-dir", default=None,
                    help="artifact dir (default: <store>.models/)")
    tr.add_argument("--space", default=None,
                    choices=["gemm", "conv", "attention", "ssd"],
                    help="restrict to one space (default: all in the store)")
    tr.add_argument("--device", default=None,
                    help="where samples are labelled: cuda (default) or cpu")
    tr.add_argument("--samples-per-shape", type=int, default=48,
                    help="label this many random legal configs per tuned "
                         "shape before training (0 = harvest only)")
    tr.add_argument("--min-samples", type=int, default=24,
                    help="skip (space, backend) groups smaller than this")
    tr.add_argument("--epochs", type=int, default=30)
    tr.add_argument("--hidden", type=_hidden, default=(64, 128, 64),
                    help="MLP hidden sizes, e.g. 64,128,64")
    tr.add_argument("--seed", type=int, default=0)
    tr.set_defaults(fn=_cmd_train)

    pr = sub.add_parser("predict", help="model-guided config for a shape")
    pr.add_argument("--store", required=True, help="JSONL record store")
    pr.add_argument("--models-dir", default=None)
    pr.add_argument("--space", default="gemm",
                    choices=["gemm", "conv", "attention", "ssd"])
    pr.add_argument("--backend", default=None,
                    help="backend fingerprint (default: newest model)")
    pr.add_argument("--shape", action="append", required=True,
                    help="shape to predict for, e.g. M=100,N=576,K=576")
    pr.add_argument("--top-k", type=int, default=5)
    pr.set_defaults(fn=_cmd_predict)

    mo = sub.add_parser("models", help="list persisted model artifacts")
    mo.add_argument("--store", required=True, help="JSONL record store")
    mo.add_argument("--models-dir", default=None)
    mo.set_defaults(fn=_cmd_models)

    pl = sub.add_parser("plan", help="frozen dispatch-plan artifacts")
    psub = pl.add_subparsers(dest="plan_cmd", required=True)

    def add_plan_compile_args(sp):
        sp.add_argument("--store", required=True, help="JSONL record store")
        sp.add_argument("--models-dir", default=None,
                        help="model artifacts consulted for the hot set "
                             "(default: <store>.models/)")
        sp.add_argument("--no-models", action="store_true",
                        help="compile from records and nearest only")
        sp.add_argument("--telemetry", default=None,
                        help="telemetry dump whose hot set is pre-resolved")
        sp.add_argument("--backend", default=None,
                        help="fingerprint the plan is keyed to "
                             "(default: any)")
        sp.add_argument("--hot-k", type=int, default=32,
                        help="hot shapes per space to pre-resolve")

    pe = psub.add_parser(
        "export", help="compile a store into a versioned plan artifact")
    add_plan_compile_args(pe)
    pe.add_argument("--out", default=None,
                    help="artifact root (default: <store>.plan/)")
    pe.add_argument("--generation", type=int, default=None,
                    help="explicit generation number (default: next free)")
    pe.set_defaults(fn=_cmd_plan_export)
    pi = psub.add_parser(
        "inspect", help="verify (schema, digest) and print a plan artifact")
    pi.add_argument("plan_dir", help="one generation's artifact directory")
    pi.set_defaults(fn=_cmd_plan_inspect)
    pp = psub.add_parser(
        "publish", help="compile and publish the next generation to a "
                        "registry")
    add_plan_compile_args(pp)
    pp.add_argument("--registry", required=True,
                    help="plan registry directory followers poll")
    pp.set_defaults(fn=_cmd_plan_publish)
    pf = psub.add_parser(
        "follow", help="poll a registry, install each new generation")
    pf.add_argument("--registry", required=True)
    pf.add_argument("--store", default=None,
                    help="record store to serve beside the plan")
    pf.add_argument("--backend", default=None,
                    help="fingerprint pin for the serving state")
    pf.add_argument("--interval", type=float, default=2.0,
                    help="seconds between registry polls")
    pf.add_argument("--max-polls", type=int, default=0,
                    help="stop after N polls (0 = until Ctrl-C)")
    pf.add_argument("--margin", type=float, default=0.10,
                    help="sentry noise margin for the coverage diff")
    pf.add_argument("--no-sentry", action="store_true",
                    help="skip the sentry's plan diff before an install")
    pf.set_defaults(fn=_cmd_plan_follow)

    fl = sub.add_parser("fleet", help="distributed tuning over a shared dir")
    fsub = fl.add_subparsers(dest="fleet_cmd", required=True)
    fs = fsub.add_parser("start", help="init a fleet dir and publish a plan")
    fs.add_argument("--fleet", required=True, help="fleet directory (the bus)")
    fs.add_argument("--store", required=True,
                    help="parent record store (shards land beside it)")
    fs.add_argument("--telemetry", default=None,
                    help="mine hot shapes from this telemetry dump")
    fs.add_argument("--space", default=None,
                    choices=["gemm", "conv", "attention", "ssd"],
                    help="restrict mining to one space (needed by --shape)")
    fs.add_argument("--shape", action="append", default=[],
                    help="explicit job, e.g. M=4,N=576,K=576 (repeatable)")
    fs.add_argument("--top-k", type=int, default=8,
                    help="hot shapes per space to publish")
    fs.add_argument("--backend", default=None,
                    help="skip shapes already tuned under this fingerprint "
                         "(default: any backend)")
    fs.add_argument("--retune", action="store_true",
                    help="publish shapes the store already serves too")
    fs.add_argument("--lease-timeout", type=float, default=30.0,
                    help="seconds without a heartbeat before a lease goes "
                         "back to the queue")
    fs.add_argument("--max-attempts", type=int, default=3)
    fs.add_argument("--drain", action="store_true",
                    help="mark the plan final: workers exit when it empties")
    fs.add_argument("--wait", action="store_true",
                    help="poll until every job lands, merging shards as "
                         "they fill; then report")
    fs.add_argument("--workers", type=int, default=0,
                    help="start N local fleet-worker processes (implies "
                         "--wait and --drain)")
    fs.add_argument("--load-tuner", default=None,
                    help="trained tuner dir passed to the started workers")
    fs.add_argument("--device", default=None,
                    help="where the started workers label: cuda (default) "
                         "or cpu")
    fs.add_argument("--worker-train-samples", type=int, default=4000,
                    help="tuner training size of the started workers")
    fs.add_argument("--worker-epochs", type=int, default=12)
    _add_fleet_finalize_args(fs)
    fs.set_defaults(fn=_cmd_fleet_start)

    fw = fsub.add_parser("worker", help="run one fleet worker process")
    fw.add_argument("--fleet", required=True)
    fw.add_argument("--worker-id", default=None,
                    help="stable shard id (default: host-pid-random)")
    fw.add_argument("--device", default=None,
                    help="where the tuners label: cuda (default) or cpu")
    fw.add_argument("--max-jobs", type=int, default=0,
                    help="exit after this many claims (0 = until drained)")
    fw.add_argument("--idle-timeout", type=float, default=0.0,
                    help="exit after this long with an empty queue "
                         "(0 = wait for DRAIN)")
    fw.add_argument("--no-remeasure", action="store_true")
    fw.add_argument("--load-tuner", default=None,
                    help="load a trained tuner dir (a space's files each) "
                         "instead of training")
    fw.add_argument("--train-samples", type=int, default=4000)
    fw.add_argument("--epochs", type=int, default=12)
    fw.add_argument("--seed", type=int, default=0)
    fw.add_argument("--telemetry-export", type=float, default=0.0,
                    help="dump this worker's shape telemetry onto the bus "
                         "every N seconds (0 = off)")
    fw.add_argument("--trace-sample", type=float, default=0.0,
                    help="enable tracing at this root sample rate (jobs "
                         "carrying a coordinator trace id are always "
                         "kept); spans dump to <fleet>/traces/<worker>.jsonl "
                         "at exit")
    fw.set_defaults(fn=_cmd_fleet_worker)

    fst = fsub.add_parser("status", help="print fleet state as JSON")
    fst.add_argument("--fleet", required=True)
    fst.add_argument("--json", action="store_true",
                     help="print the /status document (the status "
                          "endpoint's serializer)")
    fst.add_argument("--watch", action="store_true",
                     help="print one progress line every --interval "
                          "seconds (Ctrl-C stops)")
    fst.add_argument("--interval", type=float, default=2.0)
    fst.add_argument("--max-polls", type=int, default=0,
                     help="stop --watch after N polls (0 = until Ctrl-C)")
    fst.set_defaults(fn=_cmd_fleet_status)

    fd = fsub.add_parser("drain", help="stop the fleet once the queue empties")
    fd.add_argument("--fleet", required=True)
    fd.add_argument("--wait", action="store_true",
                    help="wait for outstanding jobs, merge, and report")
    _add_fleet_finalize_args(fd)
    fd.set_defaults(fn=_cmd_fleet_drain)

    fr = fsub.add_parser(
        "route", help="dry-run request routing against per-replica plan "
                      "registries")
    fr.add_argument("--registry-root", required=True,
                    help="the directory holding the per-replica registries "
                         "(Coordinator.publish_replica_plans writes them)")
    fr.add_argument("--glob", default="replica-*",
                    help="registry subdirectory pattern under the root")
    fr.add_argument("--space", default=None,
                    choices=["gemm", "conv", "attention", "ssd"],
                    help="the space of the --shape flags")
    fr.add_argument("--shape", action="append", default=[],
                    help="request shape, e.g. M=32,N=576,K=576 "
                         "(repeatable: a request may carry several)")
    fr.add_argument("--policy", default="affinity",
                    choices=["affinity", "round_robin", "random"])
    fr.set_defaults(fn=_cmd_fleet_route)

    def add_retune_args(rp):
        rp.add_argument("--store", required=True, help="JSONL record store")
        rp.add_argument("--telemetry", required=True,
                        help="telemetry JSON dump (ShapeTelemetry.save)")
        rp.add_argument("--baseline", default=None,
                        help="epoch-baseline telemetry dump "
                             "(default: <telemetry>.epoch)")
        rp.add_argument("--models-dir", default=None,
                        help="retrained artifacts dir "
                             "(default: <store>.models/)")
        rp.add_argument("--device", default=None,
                        help="where the tuners label: cuda (default) or cpu")
        rp.add_argument("--drift", type=float, default=0.25,
                        help="hot-shape mass TV-distance trigger")
        rp.add_argument("--untuned", type=float, default=0.5,
                        help="untuned window-mass trigger")
        rp.add_argument("--min-calls", type=int, default=32,
                        help="window calls before a space is judged")
        rp.add_argument("--top-k", type=int, default=4,
                        help="novel hot shapes tuned per retune")
        rp.add_argument("--workers", type=int, default=2)
        rp.add_argument("--no-train", action="store_true",
                        help="skip the regressor retrain step")
        rp.add_argument("--force", action="store_true",
                        help="retune every space with novel hot shapes, "
                             "whatever the thresholds")
        rp.add_argument("--load-tuner", default=None,
                        help="load a trained tuner dir instead of training")
        rp.add_argument("--train-samples", type=int, default=4000)
        rp.add_argument("--epochs", type=int, default=12)
        rp.add_argument("--seed", type=int, default=0)
        rp.add_argument("--publish", default=None,
                        help="after a successful swap, publish the new "
                             "generation's plan to this registry dir")

    rt = sub.add_parser(
        "retune", help="one drift-triggered retune pass over a telemetry dump")
    add_retune_args(rt)
    rt.set_defaults(fn=_cmd_retune)

    w = sub.add_parser("watch", help="poll telemetry and retune continuously")
    add_retune_args(w)
    w.add_argument("--interval", type=float, default=60.0,
                   help="seconds between polls")
    w.add_argument("--max-polls", type=int, default=0,
                   help="stop after this many polls (0 = forever)")
    w.set_defaults(fn=_cmd_watch)

    d = sub.add_parser(
        "diff", help="regression sentry: compare two store (or plan "
                     "snapshot) generations; exit 1 when the new one "
                     "regresses")
    d.add_argument("old", help="baseline store JSONL or plan snapshot JSON")
    d.add_argument("new", help="candidate store JSONL or plan snapshot JSON")
    d.add_argument("--margin", type=float, default=0.10,
                   help="noise margin: flag only records slower than "
                        "old*(1-margin) (default 0.10)")
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=_cmd_diff)

    st = sub.add_parser("stats", help="print store/telemetry statistics")
    st.add_argument("--store", required=True, help="JSONL record store")
    st.add_argument("--telemetry", default=None,
                    help="a telemetry dump (ShapeTelemetry.save)")
    st.add_argument("--json", action="store_true",
                    help="print the /status document (the serializer the "
                         "status endpoint uses)")
    st.add_argument("--fleet", default=None,
                    help="with --json: include this fleet bus's section")
    st.set_defaults(fn=_cmd_stats)

    tc = sub.add_parser("trace", help="request-trace span files")
    tsub = tc.add_subparsers(dest="trace_cmd", required=True)
    te = tsub.add_parser(
        "export", help="merge span files into one Chrome trace JSON")
    te.add_argument("--fleet", default=None,
                    help="merge every worker span dump under "
                         "<fleet>/traces/")
    te.add_argument("--input", dest="inputs", action="append", default=None,
                    metavar="FILE",
                    help="span JSONL dump or Chrome trace JSON "
                         "(repeatable); torn files are skipped")
    te.add_argument("--out", required=True,
                    help="Chrome trace-event JSON path (Perfetto loads it)")
    te.set_defaults(fn=_cmd_trace_export)
    tu = tsub.add_parser(
        "summary", help="per-span-name latency and dispatch-tier "
                        "attribution")
    tu.add_argument("--fleet", default=None,
                    help="merge every worker span dump under "
                         "<fleet>/traces/")
    tu.add_argument("--input", dest="inputs", action="append", default=None,
                    metavar="FILE",
                    help="span JSONL dump or Chrome trace JSON "
                         "(repeatable); torn files are skipped")
    tu.add_argument("--json", action="store_true")
    tu.set_defaults(fn=_cmd_trace_summary)

    ss = sub.add_parser(
        "serve-status",
        help="HTTP observability endpoint: /metrics, /status, /plan, "
             "/trace, /healthz")
    ss.add_argument("--store", required=True, help="JSONL record store")
    ss.add_argument("--telemetry", default=None,
                    help="a telemetry dump (ShapeTelemetry.save)")
    ss.add_argument("--fleet", default=None,
                    help="include this fleet bus in /status")
    ss.add_argument("--backend", default=None,
                    help="pin the installed serving view to one fingerprint")
    ss.add_argument("--host", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=9177)
    ss.set_defaults(fn=_cmd_serve_status)

    ex = sub.add_parser("export", help="compact a store (latest per shape)")
    ex.add_argument("--store", required=True, help="JSONL record store")
    ex.add_argument("--out", required=True)
    ex.set_defaults(fn=_cmd_export)

    me = sub.add_parser("merge", help="fold stores into one")
    me.add_argument("stores", nargs="+")
    me.add_argument("--out", required=True)
    me.set_defaults(fn=_cmd_merge)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
