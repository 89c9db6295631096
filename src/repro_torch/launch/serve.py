"""Serving launcher: batched generation through the port's engine.

  python -m repro_torch.launch.serve --arch smollm-135m            # on cuda
  python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu
  python -m repro_torch.launch.serve --arch mamba2-1.3b            # Mamba-2
  python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu
  python -m repro_torch.launch.serve --arch dbrx-132b --smoke --device cpu  # MoE
  python -m repro_torch.launch.serve --arch internvl2-76b --smoke --device cpu
  python -m repro_torch.launch.serve --tunedb db.jsonl \
      --plan-dir db.jsonl.plan/00000001 --admission store
  python -m repro_torch.launch.serve --tunedb db.jsonl --measure wallclock \
      --request-deadline 30 --shed-threshold 64
  python -m repro_torch.launch.serve --retune --retune-interval 16 \
      --retune-async --retune-sentry 0.1        # retune its own shapes
  python -m repro_torch.launch.serve --smoke --device cpu --retune \
      --retune-interval 8                       # the loop on the host
  python -m repro_torch.launch.serve --status-port 9177 --trace-sample 1 \
      --trace-out spans.json                    # scrape it, open in Perfetto
  python -m repro_torch.launch.serve --tunedb db.jsonl --retune \
      --retune-fleet fleet/ --retune-publish registry/ --telemetry-export 2 \
      --router affinity        # epochs tuned by `tunedb fleet worker`s
  python -m repro_torch.launch.serve --follow registry/ --follow-interval 1 \
      --rounds 0 --status-port 0    # a replica following the plans, until
                                    # Ctrl-C

With ``--retune`` the engine's retune controller trains a tuner per space
it retunes (``tunedb.controller._default_tuner_factory``: 4000 gated
samples labelled on this device, minutes a space on the card), unless
``--retune-fleet`` hands the epochs to fleet workers.  ``--rounds`` serves
the same prompts that many times (0: until interrupted), and
``--tokens-out`` writes each round's tokens and serving generation as a
JSON line, so two replicas' outputs compare.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.core.backend import CudaEventBackend
from repro_torch.device import resolve_device
from repro_torch.kernels import matmul as kmatmul
from repro_torch.models import init_params
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import ENCDEC_REFUSED
from repro_torch.tunedb.store import serving_state


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_NAMES, default="smollm-135m")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; cuda without a GPU fails")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--tunedb", default=None,
                   help="warm-start kernel dispatch from this record store")
    p.add_argument("--tunedb-backend", default=None,
                   help="pin dispatch to one backend fingerprint (default "
                        "with --tunedb: the one `python -m repro_torch."
                        "tunedb tune` writes on this device)")
    p.add_argument("--plan-dir", default=None,
                   help="serve from this plan artifact (`python -m "
                        "repro_torch.tunedb plan export`) instead of "
                        "compiling a plan at install; without --tunedb the "
                        "engine serves plan-only")
    p.add_argument("--admission", choices=["fifo", "store"], default="fifo",
                   help="'store' admits first the requests whose prompt "
                        "length's prefill shapes the plan or the store "
                        "covers, and groups equal lengths")
    p.add_argument("--request-deadline", type=float, default=None,
                   help="per-request deadline in seconds, checked at "
                        "admit and tick boundaries: an overdue pending "
                        "request is rejected unserved, an overdue active "
                        "one retires with the tokens it has")
    p.add_argument("--shed-threshold", type=int, default=None,
                   help="admission backlog cap: while active + pending "
                        "requests exceed it the newest pending ones are "
                        "shed")
    p.add_argument("--measure", choices=["wallclock"], default=None,
                   help="re-measure the model tier's top-k candidates of "
                        "each shape it resolves on this device, in the idle "
                        "gap after a decode tick, and serve the measured "
                        "winner from then on")
    p.add_argument("--retune", action="store_true",
                   help="retune in-process: tune the untuned or drifted "
                        "hot shapes, retrain and hot-swap mid-serve")
    p.add_argument("--retune-interval", type=int, default=64,
                   help="decode ticks between retune-controller polls")
    p.add_argument("--retune-async", action="store_true",
                   help="run a triggered epoch on a background thread: "
                        "the poll submits and returns, the swap lands when "
                        "the session and retrain end")
    p.add_argument("--retune-cooldown-ticks", type=int, default=0,
                   help="decode ticks a retune blocks the next trigger for")
    p.add_argument("--retune-max-sessions", type=int, default=0,
                   help="retune sessions allowed per --retune-window "
                        "seconds (0 = unlimited)")
    p.add_argument("--retune-window", type=float, default=600.0)
    p.add_argument("--retune-min-gain", type=float, default=0.0,
                   help="skip epochs whose projected gain over the "
                        "nearest-record tier is below this fraction")
    p.add_argument("--retune-sentry", type=float, default=None,
                   help="regression-sentry noise margin gating each "
                        "retune's serving swap (omit to disable)")
    p.add_argument("--retune-fleet", default=None,
                   help="fleet directory each retune epoch publishes its "
                        "shapes to (run `python -m repro_torch.tunedb "
                        "fleet worker` processes on it); implies --retune "
                        "and async epochs")
    p.add_argument("--retune-publish", default=None,
                   help="plan registry each successful retune publishes "
                        "its plan to")
    p.add_argument("--telemetry-export", type=float, default=0.0,
                   help="with --retune-fleet: dump this engine's telemetry "
                        "onto the bus every N seconds and retune off the "
                        "fleet-global view (0 = process-local)")
    p.add_argument("--follow", default=None,
                   help="plan registry to follow: each published "
                        "generation is pulled, verified and installed")
    p.add_argument("--follow-interval", type=float, default=2.0,
                   help="seconds between plan-registry polls")
    p.add_argument("--router", choices=["affinity", "round_robin", "random"],
                   default=None,
                   help="request-router policy (this engine its first "
                        "replica); omit to route nothing")
    p.add_argument("--rounds", type=int, default=1,
                   help="serve the prompts this many times (0 = until "
                        "interrupted)")
    p.add_argument("--tokens-out", default=None,
                   help="append each round's tokens, serving generation "
                        "and follower generation here as a JSON line")
    p.add_argument("--status-port", type=int, default=None,
                   help="serve /metrics, /status, /plan, /trace and "
                        "/healthz from inside the engine on this port "
                        "(0 = ephemeral)")
    p.add_argument("--trace-sample", type=float, default=0.0,
                   help="request-trace sampling rate (0 = tracing off, "
                        "1.0 = every trace root); spans export via /trace, "
                        "--trace-out and `tunedb trace`")
    p.add_argument("--trace-out", default=None,
                   help="write the run's spans as Chrome trace-event JSON "
                        "here after generation (open in Perfetto)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if device.type == "cpu" and not args.smoke and cfg.param_count > 1e9:
        raise SystemExit(f"{cfg.name} is too large for the CPU; use --smoke")
    if cfg.is_encdec:
        raise SystemExit(ENCDEC_REFUSED)
    fingerprint = args.tunedb_backend
    if args.tunedb and fingerprint is None:
        fingerprint = CudaEventBackend(device=device).fingerprint
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    eng = Engine(cfg, params, ServeConfig(
        max_len=args.max_len, slots=args.slots, temperature=args.temperature,
        seed=0, tunedb=args.tunedb, tunedb_backend=fingerprint,
        plan_dir=args.plan_dir, admission=args.admission,
        request_deadline_s=args.request_deadline,
        shed_threshold=args.shed_threshold, measure=args.measure,
        retune=args.retune, retune_interval=args.retune_interval,
        retune_async=args.retune_async,
        retune_cooldown_ticks=args.retune_cooldown_ticks,
        retune_max_sessions=args.retune_max_sessions,
        retune_window_s=args.retune_window,
        retune_min_gain=args.retune_min_gain,
        retune_sentry=args.retune_sentry, retune_fleet=args.retune_fleet,
        retune_publish=args.retune_publish,
        telemetry_export_s=args.telemetry_export, follow=args.follow,
        follow_interval_s=args.follow_interval, router=args.router,
        status_port=args.status_port, trace_sample=args.trace_sample),
        device=device)
    if eng.status_server is not None:
        print(f"status endpoint: {eng.status_server.url} "
              "(/metrics /status /plan /trace /healthz)", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len)
               for _ in range(args.requests)]
    kmatmul.launches = 0
    t0 = time.perf_counter()
    rounds = 0
    total = 0
    try:
        while args.rounds <= 0 or rounds < args.rounds:
            gen_before = serving_state().generation
            outs = eng.generate(prompts, max_new=args.max_new)
            if device.type == "cuda":
                # a stream's sync: an async retune's timer may be capturing
                torch.cuda.current_stream(device).synchronize()
            rounds += 1
            total += sum(len(o) for o in outs)
            if args.tokens_out:
                with open(args.tokens_out, "a", encoding="utf-8") as fh:
                    fh.write(json.dumps({
                        "round": rounds, "tokens": outs,
                        "generation_before": gen_before,
                        "generation_after": serving_state().generation,
                        "follower_generation": (
                            eng.follower.generation
                            if eng.follower is not None else None),
                        "ticks": eng.ticks, "captures": eng.captures,
                        "last_capture_tick": eng.last_capture_tick}) + "\n")
    except KeyboardInterrupt:
        print(f"interrupted after {rounds} round(s)", flush=True)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {device}: {rounds * len(prompts)} requests, "
          f"{total} tokens in {dt:.2f}s ({total / max(dt, 1e-9):.1f} tok/s, "
          f"{eng.ticks} decode ticks, {eng.prefills} prefills, "
          f"{kmatmul.launches} GEMM kernel launches)")
    if args.shed_threshold is not None or args.request_deadline is not None:
        print(f"degradation: {eng.shed_requests} request(s) shed, "
              f"{eng.deadline_retired} deadline-retired")
    if eng.measure_queue is not None:
        st = eng.measure_queue.stats()
        print(f"measure: {eng.measurer.counts['wallclock']} measurements "
              f"(calibration {eng.calibration_tflops} TFLOP/s), "
              f"{st['pushed']} shapes queued, {st['processed']} processed, "
              f"{st['upgrades']} upgraded, {st['dropped']} dropped, "
              f"{st['backlog']} left")
    if eng.controller is not None:
        if eng.controller.async_active():
            print("waiting for the in-flight async retune to land...")
            if (eng.controller.wait_async(timeout=60.0) is None
                    and eng.controller.async_active()):
                # a fleet with no live worker can outwait this launcher;
                # its jobs stay queued on the bus
                print("async retune still in flight after 60s; exiting "
                      "(fleet jobs stay queued: run `fleet worker` / `fleet "
                      "drain --wait` to finish and merge them)")
        st = eng.controller.stats()
        print(f"retune: {st['retunes']} epoch(s) over {st['checks']} polls, "
              f"serving generation {st['generation']}, "
              f"{st['sentry_blocked']} refused by the sentry; last "
              f"{st['last']}")
    if eng.router is not None:
        rt = eng.router.stats()
        print(f"router[{rt['policy']}]: {rt['decisions']} decision(s) "
              f"by outcome {rt['outcomes']}")
    if eng.follower is not None:
        eng.follower.stop()
        fs = eng.follower.stats()
        print(f"follower: generation {fs['generation']} of "
              f"{fs['published_generation']} published, {fs['installs']} "
              f"install(s), lag {fs['lag_s']} s, refused digest "
              f"{fs['refused_digest']} stale {fs['refused_stale']} sentry "
              f"{fs['refused_sentry']}")
    if eng.exporter is not None:
        eng.exporter.stop()
    plan = serving_state().plan
    if plan is not None:
        st = plan.stats()
        print(f"plan: {st['source']}, {st['entries']} entries {st['tiers']}, "
              f"{st['hits']} hits, {st['misses']} misses")
    if eng.tracer is not None:
        ts = eng.tracer.stats()
        print(f"trace: {ts['sampled']} root(s) sampled, "
              f"{ts['dropped']} dropped, {ts['spans']} span(s) retained")
        if args.trace_out:
            n = eng.tracer.export(args.trace_out)
            print(f"trace: wrote {n} span(s) -> {args.trace_out} "
                  "(open in https://ui.perfetto.dev)")
    if eng.status_server is not None:
        eng.status_server.stop()


if __name__ == "__main__":
    main()
