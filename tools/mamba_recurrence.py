#!/usr/bin/env python3
"""How far mamba2-1.3b's recurrent decode parts from its chunked prefill,
by depth and dtype, on the card.

    python3 tools/mamba_recurrence.py

For the full-width config (d_model 2048, random weights from seed 0) cut
to 8, 16, 32 and 48 layers in bf16, the 48 layers again with the GEMMs'
plain versions (``chip_smoke.plain_kernels``), and the 48 layers in fp32
(the same weights, widened): prefill of 262 tokens against prefill of 250
followed by 12 decode steps, as ``chip_smoke.py``'s mamba phase checks it.
Prints per case the last logits' largest and mean absolute difference,
its excess over the reference test's rtol = atol = 5e-2
(``tests/test_models.py`` ``test_smoke_decode_matches_forward``), the
logits' scale and both greedy tokens.  Dispatch runs without a store (the
vendor heuristic's GEMM configs).  Needs one NVIDIA GPU; about 1 min.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CASES = [(8, torch.bfloat16, False), (16, torch.bfloat16, False),
         (32, torch.bfloat16, False), (48, torch.bfloat16, False),
         (48, torch.bfloat16, True), (48, torch.float32, False)]


def main() -> int:
    if not torch.cuda.is_available():
        print("mamba_recurrence: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    warnings.simplefilter("ignore", RuntimeWarning)   # no store: heuristics
    dev = torch.device("cuda", 0)
    _, smi = cs.phase_device()
    cs._build.build(["gemm"])
    base = cs.get_config("mamba2-1.3b")
    n, k = cs.MAMBA_RECUR
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, base.vocab, (1, n + k)),
                           device=dev)
    for layers, dtype, plain in CASES:
        cfg = dataclasses.replace(base, n_layers=layers)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = cs.init_params(cfg, gen)
        if dtype == torch.float32:
            cfg = dataclasses.replace(cfg, dtype=dtype)
            params = cs.tree_map(lambda t: t.float(), params)
        ctx = cs.plain_kernels() if plain else contextlib.nullcontext()
        with ctx:
            full = cs.prefill(params, cfg, {"tokens": toks},
                              cs.init_cache(cfg, 1, 1, dev))[0]
            cache = cs.init_cache(cfg, 1, 1, dev)
            cs.prefill(params, cfg, {"tokens": toks[:, :n]}, cache)
            for j in range(k):
                step = cs.decode_step(params, cfg, toks[:, n + j:n + j + 1],
                                      cache, n + j)[0]
        full, step = full[:, :cfg.vocab].float(), step[:, :cfg.vocab].float()
        err = (step - full).abs()
        excess = float((err - cs.MAMBA_ATOL - cs.MAMBA_RTOL * full.abs()
                        ).max())
        print(f"{layers} layers {str(dtype).split('.')[-1]}"
              f"{', plain GEMMs' if plain else ''}: prefill {n} + {k} steps "
              f"vs prefill {n + k}: max abs diff {float(err.max()):.4e}, "
              f"mean {float(err.mean()):.4e}, excess over rtol = atol = "
              f"{cs.MAMBA_RTOL} {excess:.3e}; logits max "
              f"{float(full.abs().max()):.3f}, std {float(full.std()):.3f}; "
              f"greedy tokens {int(step.argmax())} {int(full.argmax())} "
              f"[{smi}]", flush=True)
        del params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
