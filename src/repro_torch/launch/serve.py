"""Serving launcher: batched generation through the port's engine.

  python -m repro_torch.launch.serve --arch smollm-135m            # on cuda
  python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu
  python -m repro_torch.launch.serve --tunedb db.jsonl \
      --plan-dir db.jsonl.plan/00000001 --admission store
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
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    fingerprint = args.tunedb_backend
    if args.tunedb and fingerprint is None:
        fingerprint = CudaEventBackend(device=device).fingerprint
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    eng = Engine(cfg, params, ServeConfig(
        max_len=args.max_len, slots=args.slots, temperature=args.temperature,
        seed=0, tunedb=args.tunedb, tunedb_backend=fingerprint,
        plan_dir=args.plan_dir, admission=args.admission), device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len)
               for _ in range(args.requests)]
    kmatmul.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"{cfg.name} on {device}: {len(outs)} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, {eng.ticks} decode ticks, "
          f"{eng.prefills} prefills, {kmatmul.launches} GEMM kernel "
          "launches)")
    plan = serving_state().plan
    if plan is not None:
        st = plan.stats()
        print(f"plan: {st['source']}, {st['entries']} entries {st['tiers']}, "
              f"{st['hits']} hits, {st['misses']} misses")


if __name__ == "__main__":
    main()
