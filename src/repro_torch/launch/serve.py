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

With ``--retune`` the engine's retune controller trains a tuner per space
it retunes (``tunedb.controller._default_tuner_factory``: 4000 gated
samples labelled on this device, minutes a space on the card).
"""

from __future__ import annotations

import argparse
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
        retune_sentry=args.retune_sentry, status_port=args.status_port,
        trace_sample=args.trace_sample),
        device=device)
    if eng.status_server is not None:
        print(f"status endpoint: {eng.status_server.url} "
              "(/metrics /status /plan /trace /healthz)", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len)
               for _ in range(args.requests)]
    kmatmul.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=args.max_new)
    if device.type == "cuda":
        # a stream's sync: an async retune's timer may be capturing
        torch.cuda.current_stream(device).synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"{cfg.name} on {device}: {len(outs)} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, {eng.ticks} decode ticks, "
          f"{eng.prefills} prefills, {kmatmul.launches} GEMM kernel "
          "launches)")
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
            eng.controller.wait_async()     # an in-process epoch ends
        st = eng.controller.stats()
        print(f"retune: {st['retunes']} epoch(s) over {st['checks']} polls, "
              f"serving generation {st['generation']}, "
              f"{st['sentry_blocked']} refused by the sentry; last "
              f"{st['last']}")
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
