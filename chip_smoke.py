#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits non-zero:

  1. device     the card's name and ``nvidia-smi`` name / power limit
  2. build      every CUDA kernel (gemm.cu, conv.cu, attention.cu, ssd.cu)
                from ``csrc/``, one nvcc per source, in parallel; the
                ``ptxas -v`` report: no GEMM, attention, conv or SSD kernel
                that a legal config launches spills
  3. gemm       the GEMM kernel against its plain version (and the reduced
                result against the fp32 oracle) at the serving path's
                shapes, two ragged unaligned ones (M=5 and 130), Table
                4's LINPACK 512, whisper-base's M = 6000 projections and
                internvl2-76b's at M = 4, 32 and 1152, under configs that cover every bf16 warp
                layout (bm x bn) and acc32=0; the split-K reduction pass
                against its plain version (bf16 within one ulp)
  4. conv       the conv kernel against its plain version (and the fp32
                oracle) at the paper's 14 Table 5 shapes, full size (C=1,
                K=174 and K=87 among them), under configs that cover b_c=8,
                acc32=0 and the smallest and largest tiles
  5. attention  the attention kernel against its plain version and the fp32
                oracle, bf16 and fp32, several configs: SmolLM-135M and
                qwen3-14b decode steps (causal with q_offset), causal
                prefills with GQA groups 3 and 5, the three ragged
                non-causal shapes the reference's offset trick got wrong,
                packed rows straddling two heads, decode at GQA 5 over a
                ragged cache and at GQA 8
  6. ssd        the SSD kernel against its plain version and the sequential
                fp32 oracle, bf16 and fp32, several configs (chunk 16 and
                256 among them), a ragged L, and P=24 S=40 (multiples of 8
                that the bf16 body computes at 16)
  7. tune       the offline loop on the card for all four spaces: fit the
                sampler, label a dataset with CheckedBackend(CudaEventBackend)
                (the gate, then the kernels timed), train the MLP, run a
                TuningSession with top-k re-measurement into a record store
                (GEMM: the 8 SmolLM-135M projection shapes; conv: the 14
                Table 5 shapes; attention: SmolLM-135M decode and prefill,
                qwen3-14b prefill and decode; SSD: a mamba2-1.3b and a
                jamba-v0.1 layer), then serve every tuned shape through
                ``dispatch`` from it; every job must succeed, every call
                be a hit of the install's dispatch plan on an entry
                compiled from the shape's exact record, and agree with the
                fp32 oracle at full size
  8. models     the tuner's model tier on the card: label 48 random legal
                configs at each tuned GEMM shape through the gated timer
                (``collect_samples``; the samples go into the installed
                store, so its plan must stand aside: a tuned shape
                resolves exact), train the GEMM regressor from the
                store's log, save it beside the store and load it back;
                serve 8 requests of prompt lengths nobody tuned (9-200)
                from an engine that finds the artifacts: each length's
                prefill graph and the tick graph are captured, each
                capture and its warm-up resolving a forward and no replay
                any; each untuned prefill shape resolves on the model tier
                once and is promoted into the plan, every other resolution
                is a plan hit; the 8 prefill graphs' pool bytes printed;
                graphs and the eager prefill and tick give the same greedy
                tokens; the 100-token prefill's logits agree with the plain
                version's; a reinstall compiles the telemetry's hot set
                into the plan, and a second serve (every graph captured
                again) books no model-tier resolution and gives the same
                tokens;
                then at the four projections and M in {1, 8, 17, 48, 100,
                128}: the model's pick, the best of its top 6 re-measured,
                the nearest tuned record's config, the heuristic's and
                ``torch.matmul``, timed; every pick passes the gate at its
                whole shape
  9. times      per shape: the tuned config's kernel time, the heuristic's
                (GEMM, conv) or the ops default's (attention, SSD), the
                plain version, the library call the port never makes
                (``torch.matmul``; ``F.conv2d`` channels-last on cuDNN;
                SDPA) and the bound max(bytes/HBM, FLOPs/peak); for the
                GEMM also the kernel alone and the split-K reduction pass
                alone beside ``ops.matmul``; for attention also the
                achieved TFLOP/s (prefill) or GB/s (decode), the share of
                the bound, and the tuned config's registers and spills;
                for SSD the TFLOP/s by 4·B·L·H·P·S, the share of the bound
                and the kernel's registers and spills
                gemm-table4: the paper's 17 Table 4 GEMMs in bf16 under the
                vendor heuristic's config (a transposed A or B as a
                transposed view, so its relayout is timed), against
                ``torch.matmul`` and the bound, with TFLOP/s; printed, not
                held (the results are held to the fp32 oracle)
 10. serve      SmolLM-135M at full width (30 layers, bf16, random weights
                from a seed) through ``Engine.generate`` from the tuned store,
                every prefill and decode tick replayed from the engine's
                CUDA graphs (a warm-up run captures the tick and the
                32-token prefill); the engine's install compiles a dispatch
                plan (its entries by tier and compile ms printed), and
                every capture, its warm-up and every eager forward resolve
                each projection's GEMM config and the decode KV split count
                as plan hits, each served shape's entry its tuned record's
                config (tier exact); then the same requests with the eager
                prefill and tick: the same greedy tokens, tok/s and median
                tick of both; the measured graph run launches no GEMM from
                the host and gives the device 210 x (prefills + replays)
                GEMM kernels and one reduction pass per split-K projection
                of each prefill and tick (each graph's kernel nodes, read
                through the driver API, times its replays), and the shape
                telemetry counts the same 210 x (prefills + replays) GEMM
                calls and 30 split-count lookups a tick, per shape as the
                eager run counts them
 11. plans      the serve phase's generation exported as a plan artifact
                (``<store>.plan/<generation>/``), loaded back (ms against
                the compile's), then a fresh engine with only the artifact
                (no store, no models) serves the same requests: the store
                run's greedy tokens, every resolution a plan hit, every
                served shape planned as its tuned record's config; a
                rejected artifact fails the phase
 12. host cost  us per ``dispatch._resolve_cfg`` over a decode tick's 210
                GEMM and 30 split-count shapes, plan hit against the slow
                path (``install_serving(build_plan=False)``: exact), median
                of 5 x 10,000 calls; the 32-token prefill as a graph replay
                (with the merge into the slot) and eager with and without
                the plan, median of 10 each, alternated; the graph's
                capture ms
 13. prefill parity  the graph prefill against the eager prefill at prompt
                lengths 200, 100, 32 and 9: logits bitwise equal, the same
                greedy token, the slot's cache rows equal and zero past n
 14. admission  the models phase's 8 lengths mixed with tuned 32-token
                prompts, FIFO and ``admission="store"``: the same tokens
                per request; admission orders and bucket decisions printed
 15. measure    the model tier's deferred re-measurement: the models
                phase's 8 prompts served with ``measure="wallclock"`` and
                a top-6 re-measure from a plan holding only the store's
                records; the calibration GEMM measured; the queue's stats,
                the drain ms per tick and the tick wall with and without
                a drain printed; after the drain every drained shape
                resolves on tier plan to its measured winner; a forward's
                GEMMs at the drained lengths timed under the winners, the
                blind argmax and the nearest record; after a reinstall a
                second serve's graph prefill logits agree with the plain
                version's
 16. degradation  request deadlines and load shedding (2 slots):
                ``shed_threshold=3`` on 6 requests sheds the 3 newest and
                serves the 3 oldest whole, healthy at the end;
                ``request_deadline_s=0`` rejects every request unserved;
                ``request_deadline_s=3600`` gives the tokens of none
 17. trace      tracing and the status endpoint: SmolLM-135M at full width
                from the tuned store, ``ServeConfig(slots=4, max_len=256,
                trace_sample=1.0, status_port=0)``, the serve phase's 8 x
                32-token prompts x 16 tokens from the graphs (its tokens);
                /healthz, /metrics, /status, /plan and /trace scraped from
                this process (ms printed); the Chrome trace (schema 1)
                holds engine.admit, engine.prefill, engine.tick and
                dispatch.resolve (each with a tier, all plan), one
                engine.tick root a tick, resolutions only in the capturing
                tick; /metrics carries the tunedb_* series; then tracing
                off: no Tracer call over a generate (E18.1), a plan hit's
                us through dispatch._tuned_cfg, and E18.2's quiet / traced
                at 1% / quiet triplets (the overhead against 2% + 2 x the
                A/A noise, printed)
 18. model      prefill + 4 decode steps through the kernel path and again
                through the plain path on the card; logits must agree
 19. profile    a decode tick: eager wall time, host enqueue time, and the
                device time of the same tick replayed from a CUDA graph;
                the replay traced until a round's kernel events are the
                captured graph's kernel nodes, replay by replay and name by
                name (at most 5 rounds), then its kernels by name (ms and
                count a tick, in order of time)
 20. retune     the retune loop closed on the card (``tunedb/controller.py``,
                ``ServeConfig.retune``): SmolLM-135M at full width from an
                EMPTY in-memory store, the tune phase's GEMM and attention
                tuners, ``ServeConfig(slots=4, max_len=256, retune=True,
                retune_interval=8, retune_min_calls=32, retune_top_k=4)``;
                every poll's decisions printed.  A (inline, traced at
                ``trace_sample=1.0``): 8 x 32-token
                prompts x 48 tokens: an epoch tunes its own untuned GEMM
                and split-count shapes on the card (``source="retune"``
                records under the card's fingerprint), retrains the GEMM
                regressor and flips the generation mid-serve; the next tick
                captures the tick graph again and each of its shapes with a
                record is planned exact on it; a replayed tick's logits are
                bitwise the eager tick's; tier counts, the epoch's wall
                (session, retrain, install), the tripping tick and the
                median tick before and after printed, and each tick's
                engine.tick root split into retune.epoch, measure.*,
                dispatch.resolve and the rest (medians before and after
                the swap); after every epoch the timer holds no operand
                set, and an epoch leaves the memory allocated within 8 MiB
                of its level before it (ROADMAP C12).  B (same engine): 96 x
                100-token prompts x 2 tokens: drift or untuned mass trips an
                epoch that tunes the four M = 100 shapes, and the 100-token
                prefill graph, captured again, resolves its 210 GEMMs on
                them.  C (``retune_async``, a fresh engine and store): A's
                traffic and 4 x 48-token prompts; a prefill capture of a new
                length starts and ends while the background epoch is in
                flight, no capture fails, the report surfaces on a later
                poll, every request is served whole; a thread scrapes
                /status and /metrics all the while (``status_port=0``): no
                scrape and no capture fails; the tick wall in flight and
                after (a serve with none in flight), its engine.tick split,
                the retune.epoch spans and the async records' TFLOP/s over
                A's printed
 20b. fleet     the fleet (``tunedb/fleet``, ``tunedb/plans.py``
                ``PlanRegistry`` / ``PlanFollower``, ``serve/router.py``):
                SmolLM-135M at full width (weights from seed 0 as
                ``launch.serve`` makes them) from an empty disk-backed
                store.  A: ``python -m repro_torch.tunedb fleet worker``
                in its own process (the tune phase's GEMM and attention
                tuners saved to disk, ``--load-tuner``); the engine
                (``retune_fleet``, ``retune_publish``, telemetry export,
                the affinity router, tracing, the status endpoint) serves
                8 x 32-token prompts x 48 tokens round after round until
                the worker's records are merged, swapped in and published;
                the jobs, the epoch's split, the ticks during the wait and
                after, the merged TFLOP/s over the tune phase's, both
                fingerprints, the longest heartbeat gap and the worker's
                launches printed; the worker's fleet.job spans in the
                epoch's trace; /status and /metrics carry the fleet and
                router.  B: a worker process killed (SIGKILL) after its
                claim: the job is requeued and tuned once by a second one,
                the merge gated by the sentry.  C: ``launch.serve --follow``
                in its own process adopts A's published generation
                mid-serve and then gives A's tokens; ``fleet route`` over
                two replica registries.  A child that fails, or is left
                running, fails the phase
 21. chaos      crash safety (``tunedb/chaos.py``, the store's quarantine
                and ``repair``, ``tunedb fsck``): A: 3 worker threads,
                each with its own copies of the tune phase's GEMM and
                attention tuners loaded from disk, tune SmolLM-135M's 8
                projection GEMMs and its decode attention shape on the
                card under ``FaultPlan(seed=11)`` (``worker.*`` kill,
                ``lease.*`` EIO, ``store.append`` torn write; a dead
                worker's thread starts a new one); disarmed, expired
                leases requeue and sweep workers drain the queue:
                every job done or failed exactly once, every done job's
                record merged; the faults by kind and site, the retries
                by site.  B: a merge killed by a torn append: the store
                reopened quarantines the fragment, ``fsck --fleet`` exits
                1, 0 (``--repair``), 0, and a restarted coordinator merges
                again.  C: SmolLM-135M at full width serves 8 x 32-token
                prompts x 16 tokens from the repaired store from its
                graphs: every resolution a plan hit on an exact record,
                tokens equal to eager, 0 ``FaultyIO`` calls disarmed
 22. mamba      mamba2-1.3b at full width (48 layers, bf16, random weights
                from seed 0): its 4 projection GEMMs (M = 4 and 32) tuned
                into the store, then 8 requests of 32-token prompts x 16
                tokens served through ``Engine.generate`` from the
                engine's CUDA graphs (a warm-up run captures the tick and
                the 32-token prefill): no GEMM launched from the host in
                the graph run, 96 x (prefills + replays) GEMM kernels and
                one reduction pass per split-K projection given to the
                device (graph nodes x replays), the telemetry's GEMM count
                the same and no split-count lookup, every served shape
                planned as its tuned record; the same requests eager: the
                same greedy tokens; tok/s and median tick of both; the
                32-token prefill, graph against eager; graph against eager
                prefill at 300/200/32/9/1 tokens: logits bitwise, the
                slot's conv and SSM state the single-slot cache's and the
                eager prefill's; prefill of 262 tokens against prefill of
                250 and 12 decode steps (fp32 held to the reference test's
                tolerance, bf16 printed); the SSD kernel under the mamba2
                target's record against ``ssd_chunked`` on layer 0's scan
                inputs at L=300 (both timed; not on the path); the
                replayed tick's device time against its byte bound; the
                phase's wall time
 23. moe        dbrx-132b at full width (d_model 6144, 48 / 8 heads, d_ff
                10752, 16 experts top-4, vocab 100352, bf16, random weights
                from seed 0), its depth cut to 8 of 40 layers (all 40 need
                about 262 GB): the earlier phases' memory freed first; its
                4 attention-projection GEMMs (M = 4 and 32) and its decode
                attention shape tuned into the store, then 8 requests of
                32-token prompts x 16 tokens served through
                ``Engine.generate`` from the engine's CUDA graphs (the MoE
                capacity dispatch in every prefill, the dense-over-experts
                decode path in every tick): no GEMM launched from the host
                in the graph run, 32 x (prefills + replays) GEMM kernels
                and one reduction pass per split-K projection given to the
                device (graph nodes x replays), the telemetry's GEMM count
                the same and 8 split-count lookups a tick, every served
                shape planned as its tuned record; the same requests eager:
                the same greedy tokens; tok/s and median tick of both; graph
                against eager prefill at 100/32/9/1 tokens (1: the decode
                path): logits and the slot's K/V rows bitwise; layer 0's
                capacity path at factor 8 against its decode path in fp32
                (rtol 1e-4, atol 1e-5) and the pairs dropped at 1.25; the
                replayed tick's device time against its byte bound, its
                kernels split into GEMM, reduction and other from a traced
                round held to the graph's nodes; parameter bytes and peak
                memory
 24. encdec     whisper-base at full width, nothing cut (6 encoder + 6
                decoder layers, d_model 512, bf16, random weights from seed
                0), through the model's entry points as the reference
                serves an encoder-decoder (its engine takes tokens only):
                its 9 GEMM shapes (M = 4, 128, 6000) and its decode
                attention shape tuned, the store installed with no plan
                (every resolution an exact record, ``dispatch.tier_counts``
                printed); ``encode``, ``prefill`` with 4 x 1500 frame
                embeddings and 32-token prompts, 16 greedy
                ``decode_step(memory=)`` ticks eager, then replayed from
                one CUDA graph: logits bitwise the eager ticks', tokens
                equal, 66 GEMM kernel nodes (6 x (4 self + 2 cross-K/V + 2
                cross-q/o + 3 MLP)) and one reduction node per projection
                whose tuned config splits K; encode, prefill and eager tick
                ms; the replayed tick's device time against its byte bound
 25. frontend   internvl2-76b at full width (d_model 8192, 64 / 8 heads,
                d_ff 28672, vocab 128256, bf16), its depth cut to 32 of 80
                layers (all 80 need about 139 GB), after the earlier
                phases' memory is freed: its 4 projection GEMMs (M = 4 and
                32) and decode attention shape tuned; 8 requests of
                32-token prompts x 16 tokens served on tokens through
                ``Engine.generate`` from the CUDA graphs (0 host GEMM
                launches, 224 x (prefills + replays) GEMM kernels from
                graph nodes, tokens equal to eager); the model-level
                prefill of 256 patch embeddings and 32 tokens for 4
                requests (M = 1152, untuned: its tier printed) and 16
                greedy decode steps from index 288; the replayed tick
                against its byte bound; the peak allocated held under 75
                GB; the two phases' wall
 25b. train    SmolLM-135M training at full width (30 layers, bf16, params
                from seed 0; 8 x 512 tokens a step, the launcher's
                defaults) from an empty store: A 20 steps on the heuristic
                tier (step wall, tokens/s, loss falling, peak memory, model
                TFLOP/s; each step 840 GEMM launches, each a dispatch call
                through the autograd Function, the split-K reduction
                launches of the resolved configs, no plain version); B the
                tune phase's GEMM tuner over A's 9 shapes, then 10 steps on
                the plan; C per shape tuned / heuristic / kernel alone /
                reduction / torch.matmul / bound times the calls a step,
                the transposed-operand copies, one eager step's device
                time by kernel kind; D the Function's output and both
                grads against the plain version at the 9 shapes, and a
                full step's loss and gradient norm; E checkpoint every 3
                of 6 steps, a new Trainer resumes at 6; F microbatches 2
                with int8 compression, and one SMOKE step of 5 other
                families; G ``python -m repro_torch.launch.train`` in a
                process of its own
 25c. parallel a 1-rank NCCL process group and ``make_host_mesh(model=1)``
                on the card (no fallback): dbrx-132b at full width, 2
                layers, a 4 x 32-token prefill under ``use_rules(mesh)``
                through ``moe_ep`` and through ``moe_ep_a2a``, each
                bitwise the no-mesh prefill (logits, K/V rows), GEMM
                launches > 0, collective bytes the formula's; one
                ``loss_fn`` step through ``moe_ep``, its gradients within
                1e-2 of the no-mesh step's; ``pipeline_apply`` over one
                stage running SmolLM-135M's 30 layers on 4 microbatches of
                hidden states, bitwise the plain walk; the FSDP/TP
                placements (``use_rules(mesh, placed=True)`` on
                ``shard_params`` / ``shard_batch``): dbrx's step through
                ``moe_ep`` on the batch shard and SmolLM-135M's at full
                width on 8 x 512 tokens within 1e-2 of the no-mesh step,
                GEMM launches equal, SmolLM's collective bytes
                ``analysis.comm.placed_bytes``'s, its 4 x 32 prefill
                bitwise the no-mesh one; the decode placements (a
                ``shard_cache`` cache): SmolLM-135M's 4 x 32 prefill and
                16 greedy decode steps, mamba2-1.3b's (48 layers,
                head-parallel TP) prefill and 8 steps, dbrx-132b's 8
                steps through the EP ``moe_decode``, each step's logits
                bitwise (or within 1e-3 of their max) the no-mesh step's,
                the greedy tokens equal, GEMM launches equal (SmolLM's
                collective bytes ``placed_bytes``'s); mamba2's placed
                ``loss_fn`` step at 8 of 48 layers on 8 x 512 tokens
                within 1e-2; the ms of each path
 25d. dryrun   the dry-run (``launch/dryrun.py``): B, two cells both
                ways, on meta tensors and on the card: V1 SmolLM-135M's
                training step at 8 x 512 (no mesh, split-K records
                installed) and V2 dbrx-132b at 2 of 40 layers, a 4 x 32
                prefill placed on the 1-rank NCCL host mesh, and V3
                SmolLM-135M's decode step at 16 x 32768 placed there (the
                meta passes in fake worlds of one, in children that have
                exited before any step is timed): GEMM calls, sum
                2·M·N·K, reduction passes, aten FLOPs and bytes (V2, V3:
                the collective bytes too) equal
                exactly; the estimated temp against the peak allocated
                above what was held, the step's wall against the
                roofline's largest term; then A, in a child process,
                ``python -m repro_torch.launch.dryrun --cell ...`` over
                full-size cells on the fake 256- and 512-rank meshes
                (each cell's wall, per-rank FLOPs, bytes, collective
                bytes, peak and ``fits``, and its roofline row)
 26. kernels    one JSON line summarising every hand-written kernel (the
                four ported TPU kernels and the GEMM's split-K reduction)
 27. summary    one line a phase (its figures, or its last line cut short),
                just before the last line, inside a 24 KB tail

``python3 chip_smoke.py --only PHASE`` runs PHASE (a name of
:data:`PHASES`) after the phases it needs (:data:`NEEDS`; device and
build always run) and prints no kernels line.

Each path (tune, models, serve, plans, admission, measure,
degradation, trace, retune, fleet (the engine's; fleet_worker: the
worker processes' own counts, from their reports), chaos (the engine's;
chaos_workers: the worker threads' timings), serve_mamba, serve_moe,
serve_encdec, serve_frontend, train, parallel, dryrun (V1's, V2's and
V3's counted card runs))
runs with every launch count set to 0 just before it and read just after; a kernel of the path
that never launched fails.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU (or outside a checkout of the repo) it exits non-zero and
prints no result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import errno
import functools
import gc
import io
import itertools
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import comm  # noqa: E402
from repro_torch.analysis.comm import collective_bytes  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.analysis.roofline import (format_table,  # noqa: E402
                                           model_flops,
                                           roofline_from_artifacts)
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.core.backend import (HBM_GBPS, PEAK_BF16_TFLOPS,  # noqa: E402
                                      PEAK_FP32_TFLOPS, CheckedBackend,
                                      CudaEventBackend, problem_flops)
from repro_torch.core.dataset import Dataset  # noqa: E402
from repro_torch.core.features import Featurizer  # noqa: E402
from repro_torch.core.generative import CategoricalSampler  # noqa: E402
from repro_torch.core.heuristics import VendorHeuristicLibrary  # noqa: E402
from repro_torch.core.mlp import MLP  # noqa: E402
from repro_torch.core.space import (ATTENTION_SPACE, CONV_SPACE,  # noqa: E402
                                    GEMM_SPACE, SSD_SPACE, ConfigRejected,
                                    attention_fits, attention_head_tile,
                                    attention_input, conv_fits, conv_input,
                                    gemm_fits, gemm_input, ssd_fits,
                                    ssd_input)
from repro_torch.core.tuner import InputAwareTuner  # noqa: E402
from repro_torch.kernels import _build, dispatch, ops  # noqa: E402
from repro_torch.kernels import attention as kattention  # noqa: E402
from repro_torch.kernels import conv as kconv  # noqa: E402
from repro_torch.kernels import matmul as kmatmul  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.kernels.ref import (attention_ref, conv2d_ref,  # noqa: E402
                                     matmul_ref, ssd_ref)
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import (decode_step, encode,  # noqa: E402
                                init_cache, init_params, loss_fn, prefill,
                                tree_leaves, tree_map)
from repro_torch.models import moe as mmoe  # noqa: E402
from repro_torch.models.model import _run_stack as model_run_stack  # noqa: E402
from repro_torch.models import ssm as mssm  # noqa: E402
from repro_torch.models.layers import attention, rms_norm  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig, global_norm  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.pipeline import (pipeline_apply,  # noqa: E402
                                           stage_split)
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.flash_decode import resolve_decode_splits  # noqa: E402
from repro_torch.tunedb.model import (ModelSet, clear_models,  # noqa: E402
                                      collect_samples, default_models_dir,
                                      train_models)
from repro_torch.tunedb.obs import (Tracer, enable_tracing,  # noqa: E402
                                    get_registry, load_span_file,
                                    reset_tracing)
from repro_torch.tunedb.plans import (default_plan_dir, export_plan,  # noqa: E402
                                      load_plan, read_manifest)
from repro_torch.tunedb.session import TuningSession  # noqa: E402
from repro_torch.tunedb.store import (RecordStore, TuneRecord,  # noqa: E402
                                      clear_store, install_serving,
                                      install_store, launchable,
                                      serving_state, shape_key)
from repro_torch.tunedb.telemetry import (clear_telemetry,  # noqa: E402
                                          get_telemetry)
from repro_torch.train import (TrainConfig, Trainer,  # noqa: E402
                               init_train_state)

# (N, K) of the serving path's projections and their count per layer:
# q and o (576x576), k and v (576->192), gate and up (576->1536), down
SLICE_NK = {(576, 576): 2, (192, 576): 2, (1536, 576): 2, (576, 1536): 1}
SLICE_M = (4, 32)                  # decode (4 slots) and prefill (32 tokens)
GEMMS_PER_LAYER = sum(SLICE_NK.values())
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
REDUCE_TOL_FP32 = 1e-6
LOGIT_TOL = 3e-2

# every bf16 warp layout (bm x bn: 1 warp at 16 x 32 to 8 at 128 x 128),
# acc32=0 with sub-dots of 64 elements, k_unroll up to 4, every k_split
CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_GEMM),
    "k_split=2": {"bm": 32, "bn": 64, "bk": 64, "k_unroll": 1, "k_split": 2,
                  "order": 0, "acc32": 1, "prefetch": 3},
    "k_split=4": {"bm": 16, "bn": 64, "bk": 128, "k_unroll": 1, "k_split": 4,
                  "order": 0, "acc32": 1, "prefetch": 2},
    "acc32=0,k_unroll=2": {"bm": 32, "bn": 128, "bk": 128, "k_unroll": 2,
                           "k_split": 1, "order": 0, "acc32": 0,
                           "prefetch": 2},
    "order=1": {"bm": 64, "bn": 32, "bk": 64, "k_unroll": 4, "k_split": 2,
                "order": 1, "acc32": 1, "prefetch": 1},
    "16x32,acc32=0": {"bm": 16, "bn": 32, "bk": 128, "k_unroll": 2,
                      "k_split": 1, "order": 0, "acc32": 0, "prefetch": 2},
    "16x128,k_split=8": {"bm": 16, "bn": 128, "bk": 64, "k_unroll": 2,
                         "k_split": 8, "order": 1, "acc32": 1,
                         "prefetch": 3},
    "32x32,acc32=0,k_split=2": {"bm": 32, "bn": 32, "bk": 64, "k_unroll": 1,
                                "k_split": 2, "order": 1, "acc32": 0,
                                "prefetch": 3},
    "64x64,acc32=0": {"bm": 64, "bn": 64, "bk": 128, "k_unroll": 2,
                      "k_split": 1, "order": 0, "acc32": 0, "prefetch": 2},
    "64x128,bk=32": {"bm": 64, "bn": 128, "bk": 32, "k_unroll": 1,
                     "k_split": 4, "order": 0, "acc32": 1, "prefetch": 3},
    "128x32,acc32=0,k_split=2": {"bm": 128, "bn": 32, "bk": 64,
                                 "k_unroll": 1, "k_split": 2, "order": 1,
                                 "acc32": 0, "prefetch": 2},
    "128x64,acc32=0,bk=256": {"bm": 128, "bn": 64, "bk": 256, "k_unroll": 4,
                              "k_split": 1, "order": 0, "acc32": 0,
                              "prefetch": 1},
    "128x128,acc32=0": {"bm": 128, "bn": 128, "bk": 128, "k_unroll": 2,
                        "k_split": 1, "order": 1, "acc32": 0, "prefetch": 3},
}
# the GEMM check's shapes beyond the serving path's: ragged and unaligned
# (K and N not multiples of 8: element loads), small and large M; and
# Table 4's LINPACK 512 (no tile shrinks there)
GEMM_EXTRA_SHAPES = [(5, 100, 300), (130, 100, 300), (512, 512, 512)]

# the paper's Table 4: (M, N, K, trans_a, trans_b, suite)
# (benchmarks/bench_gemm.py)
TABLE4 = [
    (512, 512, 512, 0, 1, "LINPACK"),
    (1024, 1024, 1024, 0, 1, "LINPACK"),
    (2048, 2048, 2048, 0, 1, "LINPACK"),
    (2560, 16, 2560, 0, 0, "DeepBench-F"),
    (2560, 32, 2560, 0, 0, "DeepBench-F"),
    (2560, 64, 2560, 0, 0, "DeepBench-F"),
    (2560, 128, 2560, 0, 0, "DeepBench-F"),
    (2560, 16, 2560, 1, 0, "DeepBench-B"),
    (2560, 32, 2560, 1, 0, "DeepBench-B"),
    (2560, 64, 2560, 1, 0, "DeepBench-B"),
    (2560, 128, 2560, 1, 0, "DeepBench-B"),
    (32, 32, 60000, 0, 1, "ICA"),
    (64, 64, 60000, 0, 1, "ICA"),
    (256, 256, 60000, 0, 1, "ICA"),
    (4096, 4096, 32, 0, 1, "LAPACK"),
    (3456, 3456, 32, 0, 1, "LAPACK"),
    (896, 896, 32, 0, 1, "LAPACK"),
]

# the paper's Table 5 (DeepBench): (N, P(H), Q(W), K, C, R, S, name)
TABLE5 = [
    (16, 79, 341, 32, 1, 5, 20, "Conv1-DeepSpeech"),
    (16, 38, 166, 32, 32, 5, 10, "Conv2-DeepSpeech"),
    (16, 24, 240, 32, 16, 3, 3, "Conv3-OCR"),
    (16, 12, 120, 64, 32, 3, 3, "Conv4-OCR"),
    (8, 54, 54, 64, 64, 3, 3, "Conv5-Face"),
    (8, 27, 27, 128, 128, 3, 3, "Conv6-Face"),
    (16, 14, 14, 48, 512, 5, 5, "Conv7-Face"),
    (16, 7, 7, 128, 832, 5, 5, "Conv8-Face"),
    (8, 112, 112, 128, 64, 3, 3, "Conv9-Vision"),
    (8, 56, 56, 256, 128, 3, 3, "Conv10-Vision"),
    (16, 128, 39, 174, 64, 5, 5, "Conv11-Speaker"),
    (16, 256, 19, 87, 128, 5, 5, "Conv12-Speaker"),
    (16, 7, 7, 512, 512, 3, 3, "Conv13-ResNET"),
    (16, 7, 7, 2048, 1024, 1, 1, "Conv14-ResNET"),
]
CONV_SHAPES = [conv_input(n, h, w, c, k, r, s) for n, h, w, k, c, r, s, _
               in TABLE5]

CONV_CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_CONV),
    "16x16,acc32=0": {
        "b_npq": 16, "b_k": 16, "b_c": 16, "rs_unroll": 2, "c_split": 1,
        "order": 0, "acc32": 0, "prefetch": 2},
    "128x128,b_c=8,acc32=0": {
        "b_npq": 128, "b_k": 128, "b_c": 8, "rs_unroll": 2, "c_split": 1,
        "order": 1, "acc32": 0, "prefetch": 3},
    "c_split=2,acc32=0,rs_unroll=4": {
        "b_npq": 128, "b_k": 32, "b_c": 8, "rs_unroll": 4, "c_split": 2,
        "order": 1, "acc32": 0, "prefetch": 3},
    "c_split=4,b_k=128": {
        "b_npq": 16, "b_k": 128, "b_c": 64, "rs_unroll": 2, "c_split": 4,
        "order": 0, "acc32": 1, "prefetch": 1},
    "c_split=8,acc32=0": {
        "b_npq": 32, "b_k": 64, "b_c": 16, "rs_unroll": 1, "c_split": 8,
        "order": 1, "acc32": 0, "prefetch": 2},
}
# fp32 cases: the default config at these Table 5 shapes
CONV_FP32 = ("Conv1-DeepSpeech", "Conv7-Face", "Conv11-Speaker",
             "Conv14-ResNET")

# attention: (name, (B, Hq, Hkv, Lq, Lkv, D), causal, q_offset) checked
# against the plain version and the oracle
ATTN_CHECKS = [
    ("smollm-135m decode", (4, 9, 3, 1, 256, 64), True, 255),
    ("qwen3-14b decode", (8, 40, 8, 1, 32768, 128), True, 32767),
    ("causal prefill, GQA 3", (1, 9, 3, 2048, 2048, 64), True, 0),
    ("causal prefill, GQA 5", (1, 40, 8, 1024, 1024, 128), True, 0),
    ("C1 Lq=4 Lkv=100", (1, 4, 2, 4, 100, 64), False, 0),
    ("C1 Lq=8 Lkv=200", (1, 4, 2, 8, 200, 64), False, 0),
    ("C1 Lq=130 Lkv=100", (1, 4, 2, 130, 100, 64), False, 0),
    ("packed rows straddling heads", (1, 10, 2, 100, 100, 64), True, 0),
    ("decode GQA 5, ragged cache", (2, 40, 8, 1, 1000, 128), True, 999),
    ("decode GQA 8", (1, 32, 4, 1, 4096, 128), True, 4095),
]
ATTN_CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_ATTN),
    "b_q=16,b_kv=128,prefetch=3": {"b_q": 16, "b_kv": 128, "acc32": 1,
                                   "prefetch": 3},
    "b_q=128,b_kv=16,prefetch=1": {"b_q": 128, "b_kv": 16, "acc32": 1,
                                   "prefetch": 1},
    "b_q=32,b_kv=32,acc32=0": {"b_q": 32, "b_kv": 32, "acc32": 0,
                               "prefetch": 2},
}
# SSD: (name, (B, L, H, P, S))
SSD_CHECKS = [
    ("mamba2-1.3b layer", (1, 2048, 64, 64, 128)),
    ("ragged L=1000", (2, 1000, 8, 64, 128)),
    ("jamba-v0.1 layer, L=1024", (1, 1024, 128, 64, 128)),
    ("P=24 S=40, ragged L=97", (2, 97, 4, 24, 40)),
]
SSD_CHECK_CONFIGS = {
    "default": dict(ops.DEFAULT_SSD),
    "chunk=256,prefetch=1": {"chunk": 256, "b_heads": 1, "acc32": 1,
                             "prefetch": 1},
    "chunk=16,b_heads=4,prefetch=3": {"chunk": 16, "b_heads": 4, "acc32": 1,
                                      "prefetch": 3},
    "chunk=128,b_heads=2,acc32=0": {"chunk": 128, "b_heads": 2, "acc32": 0,
                                    "prefetch": 1},
}
# the fp32 oracle's tolerance in fp32 (tests/test_kernels.py's)
ORACLE_TOL_FP32 = {"attention": 2e-3, "ssd": 1e-3}

# tune targets, bf16; an attention target's q_offset for its dispatch check
ATTN_TARGETS = [
    ("smollm-135m decode", attention_input(4, 9, 3, 1, 256, 64), 255),
    ("smollm-135m prefill 2048", attention_input(1, 9, 3, 2048, 2048, 64), 0),
    ("qwen3-14b prefill 4096", attention_input(1, 40, 8, 4096, 4096, 128), 0),
    ("qwen3-14b decode 32768", attention_input(8, 40, 8, 1, 32768, 128),
     32767),
]
SSD_TARGETS = [
    ("mamba2-1.3b layer", ssd_input(1, 2048, 64, 64, 128)),
    ("jamba-v0.1 mamba layer", ssd_input(1, 4096, 128, 64, 128)),
]

# the tune phase: dataset size per space, regressor, top-k re-measured
TUNE_SAMPLES = {"gemm": 320, "conv": 192, "attention": 96, "ssd": 64}
TUNE_HIDDEN = (64, 128, 64)
TUNE_EPOCHS = 60
TUNE_BATCH = 32
TUNE_TOP_K = 6

# the models phase: samples labelled per tuned GEMM shape (the reference
# CLI's default), the untuned M of the four projections, the configs the
# re-measured column measures, and the serve run's prompt lengths
MODEL_PER_SHAPE = 48
MODEL_EPOCHS = 30
MODEL_M = (1, 8, 17, 48, 100, 128)
MODEL_TOP_K = 6
MODEL_PROMPTS = (9, 17, 32, 48, 64, 100, 128, 200)

# the H100 SXM's data-sheet peaks (dense, ``core.backend``): HBM bytes/s
# and FLOP/s per IO dtype
H100_SXM = {"hbm": HBM_GBPS * 1e9, torch.bfloat16: PEAK_BF16_TFLOPS * 1e12,
            torch.float32: PEAK_FP32_TFLOPS * 1e12}

L2_BYTES = 50 * 1024 * 1024


# phase name -> [time of its first line, of its last, lines, last line]
PHASE_LOG: dict = {}
# phase name -> the figures the summary prints for it (else its last line)
SUMMARY: dict = {}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)
    now = time.perf_counter()
    entry = PHASE_LOG.setdefault(name, [now, now, 0, ""])
    entry[1:] = [now, entry[2] + 1, msg]


def card_peaks(name: str) -> dict:
    """The peaks ``bound_ms`` divides by; only the H100 SXM's are known."""
    if "H100" not in name or not ("HBM3" in name or "SXM" in name):
        raise RuntimeError(f"no peak rates for {name!r}: bound_ms is "
                           "computed for an H100 SXM only")
    return H100_SXM


@contextlib.contextmanager
def plain_kernels():
    """Send ``ops.matmul`` (its split-K reduction too) / ``ops.conv2d`` /
    ``ops.flash_attention`` / ``ops.ssd_scan`` through the kernels' plain
    versions, on the card, under the same configs: the reference the
    kernel paths are held to.  The port itself has no switch for this;
    only the checks and timings here make it."""
    saved = (kmatmul.gemm, kmatmul.splitk_reduce, kconv.conv,
             kattention.attention, kssd.ssd)
    kmatmul.gemm, kconv.conv = kmatmul.matmul_plain, kconv.conv2d_plain
    kmatmul.splitk_reduce = kmatmul.splitk_reduce_plain
    kattention.attention, kssd.ssd = kattention.attention_plain, kssd.ssd_plain
    try:
        yield
    finally:
        (kmatmul.gemm, kmatmul.splitk_reduce, kconv.conv,
         kattention.attention, kssd.ssd) = saved


def reset_launches() -> None:
    kmatmul.launches = kmatmul.reduce_launches = kconv.launches = 0
    kattention.launches = kssd.launches = 0


def read_launches() -> dict:
    return {"gemm": kmatmul.launches, "gemm_reduce": kmatmul.reduce_launches,
            "conv": kconv.launches, "attention": kattention.launches,
            "ssd": kssd.launches}


def rel_norm_diff(got: list, want: list, chunk: int = 1 << 26) -> float:
    """|got - want| / |want| over lists of tensors, in fp32 (0 where both
    are 0), ``chunk`` elements at a time: a bf16 leaf of several GB is
    never widened whole."""
    d = n = 0.0
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g.detach().reshape(-1).split(chunk),
                        w.detach().reshape(-1).split(chunk)):
            a, b = a.float(), b.float()
            d += float(torch.sum(torch.square(a - b)))
            n += float(torch.sum(torch.square(b)))
    return math.sqrt(d / n) if n else math.sqrt(d)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    g, w = got.float(), want.float()
    abs_err = float((g - w).abs().max())
    return abs_err, abs_err / max(float(w.abs().max()), 1e-6)


def time_ms(fn, n_calls: int, reps: int = 5) -> float:
    """Median device time of one ``fn(i)`` call: ``n_calls`` calls captured
    in a CUDA graph (no host launch cost between them), replayed ``reps``
    times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_calls)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n_calls)
    return statistics.median(times)


def median_ms(fn, reps: int) -> float:
    """Median host wall of ``fn()`` between synchronisations."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def replay_ms(graph, reps: int = 20) -> float:
    """Median device time of one replay of ``graph``, between CUDA
    events."""
    devs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        devs.append(e0.elapsed_time(e1))
    return statistics.median(devs)


def bound(nbytes: float, flops: float, dtype: torch.dtype, peaks: dict
          ) -> dict:
    """The least time the card could take: each input read once and the
    output written once at the HBM rate, or the FLOPs at the dtype's peak,
    whichever is larger."""
    t_bytes = nbytes / peaks["hbm"]
    t_ops = flops / peaks[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "t_bytes": t_bytes, "t_ops": t_ops}


def gemm_bound(M: int, N: int, K: int, dtype: torch.dtype, peaks: dict
               ) -> dict:
    bpe = torch.finfo(dtype).bits // 8
    return bound((M * K + K * N + M * N) * bpe, 2.0 * M * N * K, dtype, peaks)


def conv_bound(x: dict, dtype: torch.dtype, peaks: dict) -> dict:
    """Input, filter and output bytes; 2·N·P·Q·K·C·R·S FLOPs."""
    bpe = torch.finfo(dtype).bits // 8
    npq = x["N"] * x["H"] * x["W"]
    nbytes = (npq * x["C"] + x["R"] * x["S"] * x["C"] * x["K"]
              + npq * x["K"]) * bpe
    return bound(nbytes, 2.0 * npq * x["K"] * x["C"] * x["R"] * x["S"],
                 dtype, peaks)


def attention_bound(x: dict, dtype: torch.dtype, peaks: dict) -> dict:
    """q, k, v read once and the output written once; the FLOPs of the
    tuner's count (4·B·Hq·Lq·Lkv·D, halved for a causal square)."""
    bpe = torch.finfo(dtype).bits // 8
    qo = 2 * x["B"] * x["Hq"] * x["Lq"] * x["D"]
    kv = 2 * x["B"] * x["Hkv"] * x["Lkv"] * x["D"]
    return bound((qo + kv) * bpe, problem_flops("attention", x), dtype, peaks)


def ssd_flops(x: dict) -> float:
    """4·B·L·H·P·S: the least work any form of the scan does (ssd_bound)."""
    return 4.0 * x["B"] * x["L"] * x["H"] * x["P"] * x["S"]


def ssd_bound(x: dict, dtype: torch.dtype, peaks: dict) -> dict:
    """x, dt, B, C (and fp32 a) read once, y written once; 4·B·L·H·P·S
    FLOPs, the least any form of the scan does: every step and head adds
    its x·Bᵀ (P·S multiply-adds) into a P x S state and reads y from one
    (C·state, P·S more).  The recurrence does 5·P·S a step and head, the
    chunked form 4·P·S plus its intra-chunk terms.  Not the tuner's
    ``problem_flops``, which counts the chunked form at chunk min(256, L)
    with C·Bᵀ once per head: a yardstick, not the least work."""
    bpe = torch.finfo(dtype).bits // 8
    bl = x["B"] * x["L"]
    nbytes = (2 * bl * x["H"] * x["P"] + bl * x["H"] + 2 * bl * x["S"]) * bpe \
        + 4 * x["H"]
    return bound(nbytes, ssd_flops(x), dtype, peaks)


def attention_operands(x: dict, dtype: torch.dtype, gen: torch.Generator,
                       dev: torch.device) -> tuple:
    q = torch.randn((x["B"], x["Hq"], x["Lq"], x["D"]), generator=gen,
                    device=dev).to(dtype)
    kv = [torch.randn((x["B"], x["Hkv"], x["Lkv"], x["D"]), generator=gen,
                      device=dev).to(dtype) for _ in range(2)]
    return (q, *kv)


def ssd_operands(x: dict, dtype: torch.dtype, gen: torch.Generator,
                 dev: torch.device) -> tuple:
    """x, dt in [0.01, 0.1), a in (-2, -0.5] (fp32), B, C."""
    B, L, H, P, S = (x[k] for k in ("B", "L", "H", "P", "S"))
    xs = torch.randn((B, L, H, P), generator=gen, device=dev).to(dtype)
    dt = (0.01 + 0.09 * torch.rand((B, L, H), generator=gen, device=dev)
          ).to(dtype)
    a = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
    bm, cm = (torch.randn((B, L, S), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    return xs, dt, a, bm, cm


def conv_dims(x: dict) -> tuple:
    return tuple(x[k] for k in ("N", "H", "W", "C", "K", "R", "S"))


def conv_operands(x: dict, dtype: torch.dtype, gen: torch.Generator,
                  dev: torch.device) -> tuple:
    N, H, W, C, K, R, S = conv_dims(x)
    i = torch.randn((N, H, W, C), generator=gen, device=dev).to(dtype)
    f = (torch.randn((R, S, C, K), generator=gen, device=dev)
         / (R * S * C) ** 0.5).to(dtype)
    return i, f


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("device", f"{name}; count {torch.cuda.device_count()}")
    print(smi, flush=True)
    return name, smi


KERNELS = ("gemm", "conv", "attention", "ssd")


def ptxas_kernel(usage: dict, key: str) -> str:
    """The one (mangled) kernel name in the ptxas report ``usage`` that
    contains ``key``."""
    found = [k for k in usage if key in k]
    if len(found) != 1:
        raise AssertionError(f"ptxas report: {len(found)} kernels match {key}")
    return found[0]


def attention_kernel(usage: dict, cfg: dict, D: int, bits: int) -> str:
    """The attention kernel that ``cfg`` launches at head dim D."""
    if bits == 16:
        return ptxas_kernel(usage, f"attn_mma_kernelILi{cfg['b_q']}ELi"
                                   f"{cfg['b_kv']}ELi{attention_head_tile(D)}E")
    return ptxas_kernel(usage, f"attn_simt_kernelILi{cfg['b_q']}ELi"
                               f"{cfg['b_kv']}EE")


def gemm_kernel(usage: dict, cfg: dict, bits: int) -> str:
    """The GEMM kernel that ``cfg`` launches: the mma.sync body in bf16,
    the CUDA-core body in fp32."""
    if bits == 16:
        return ptxas_kernel(usage, f"gemm_mma_kernelILi{cfg['bm']}ELi"
                                   f"{cfg['bn']}ELb{cfg['acc32']}E")
    return ptxas_kernel(usage, f"gemm_simt_kernelILi{cfg['bm']}ELi"
                               f"{cfg['bn']}EE")


def conv_kernel(usage: dict, cfg: dict, bits: int) -> str:
    """The conv kernel that ``cfg`` launches: the mma.sync body in bf16,
    the CUDA-core body (acc32=1) in fp32."""
    if bits == 16:
        return ptxas_kernel(usage, f"conv_mma_kernelILi{cfg['b_npq']}ELi"
                                   f"{cfg['b_k']}ELb{cfg['acc32']}E")
    return ptxas_kernel(usage, f"conv_kernelIfLi{cfg['b_npq']}ELi"
                               f"{cfg['b_k']}ELb1E")


def ssd_kernel(usage: dict, bits: int) -> str:
    """The SSD kernel that a config launches: the mma.sync body in bf16,
    the CUDA-core body in fp32 (one kernel each, whatever the config)."""
    return ptxas_kernel(usage, "ssd_mma_kernel" if bits == 16
                        else "ssd_kernelIfE")


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    phase("build", f"nvcc sm_90a, {' + '.join(k + '.cu' for k in KERNELS)} "
          f"in parallel, {time.perf_counter() - t0:.1f} s")
    usage = {name: _build.ptxas_usage(name) for name in KERNELS}
    spills = {name: sorted(k for k, (_, s) in u.items() if s)
              for name, u in usage.items()}
    phase("build", "ptxas -v: " + "; ".join(
        f"{name}.cu {len(u)} kernels, {max(r for r, _ in u.values())} "
        f"registers at most, {len(spills[name])} spill"
        for name, u in usage.items()))
    # every GEMM, attention, conv and SSD kernel some legal config
    # launches: no spill
    launched = {"gemm": {}, "attention": {}, "conv": {}, "ssd": {}}
    for cfg in GEMM_SPACE.enumerate():
        for bits in (16, 32):
            if gemm_fits(cfg, bits):
                launched["gemm"][gemm_kernel(usage["gemm"], cfg, bits)] = (
                    cfg, bits)
    for cfg in ATTENTION_SPACE.enumerate():
        for bits, D in ((16, 64), (16, 128), (16, 256), (32, 64)):
            if attention_fits(cfg, bits, D):
                launched["attention"][attention_kernel(
                    usage["attention"], cfg, D, bits)] = (cfg, bits, D)
    for cfg in CONV_SPACE.enumerate():
        for bits in (16, 32):
            if conv_fits(cfg, bits):
                launched["conv"][conv_kernel(usage["conv"], cfg, bits)] = (
                    cfg, bits)
    for cfg in SSD_SPACE.enumerate():
        for bits in (16, 32):
            if ssd_fits(cfg, bits, 64, 128):
                launched["ssd"][ssd_kernel(usage["ssd"], bits)] = (cfg, bits)
    for name, kernels in launched.items():
        spilled = [v for k, v in kernels.items() if usage[name][k][1]]
        if spilled:
            raise AssertionError(f"{name} kernels a legal config launches "
                                 f"spill: {spilled}")
    phase("build", "; ".join(
        f"{name}.cu: none of the {len(k)} kernels that legal configs launch "
        f"spills ({max(usage[name][n][0] for n in k)} registers at most)"
        for name, k in launched.items()))


def ulp_distance(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in units of the last place between two bf16
    tensors: their bit patterns mapped to integers in the order of the
    values (+0 and -0 both 0)."""
    b = torch.stack([got, want]).contiguous().view(torch.int16).long()
    b = torch.where(b >= 0, b, -(1 << 15) - b)
    return int((b[0] - b[1]).abs().max())


def phase_gemm_check(dev: torch.device) -> dict:
    """The GEMM kernel's partials against its plain version's under every
    check config at every check shape, bf16 and (acc32=1) fp32; the
    reduced result against the fp32 oracle (an acc32=0 result may miss it
    only where its plain version, the config's own arithmetic, misses it
    too: a config the gate rejects at that shape); and, where the config
    splits K, the reduction pass on the kernel's partials against its
    plain version.  Both sum in fp32 and round once, in orders that may differ:
    bf16 within one ulp; fp32 within :data:`REDUCE_TOL_FP32` of the
    largest sum (near zero a reordered fp32 sum is many ulps off)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {"abs": 0.0, "rel": 0.0, "reduce_abs": 0.0, "reduce_ulp": 0,
             "reduce_fp32_rel": 0.0}
    shapes = [(M, N, K) for M in SLICE_M for (N, K) in SLICE_NK]
    shapes += GEMM_EXTRA_SHAPES
    # shapes only the encdec and frontend phases reach: whisper-base's 6000
    # frames, internvl2-76b's projections at its tick, its 32-token
    # prefill and its 256-patch prefill of 4 requests
    shapes += [(ENCDEC_M[-1], N, K) for N, K in ENCDEC_NK]
    shapes += [(M, N, K) for M in (FRONTEND_SLOTS, FRONTEND_PROMPT,
                                   FRONTEND_SLOTS * (256 + FRONTEND_PROMPT))
               for N, K in FRONTEND_NK]
    t0 = time.perf_counter()
    n = n_reduce = 0
    drift = []
    for M, N, K in shapes:
        for cname, cfg in CHECK_CONFIGS.items():
            for dtype in (torch.bfloat16, torch.float32):
                if dtype == torch.float32 and not cfg["acc32"]:
                    continue
                a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
                b = (torch.randn((K, N), generator=gen, device=dev)
                     / K ** 0.5).to(dtype)
                small = ops.shrink_gemm_cfg(cfg, M, N, K,
                                            torch.finfo(dtype).bits)
                got = kmatmul.gemm(a, b, small)
                want = kmatmul.matmul_plain(a, b, small)
                torch.cuda.synchronize()
                ea, er = rel_err(got, want)
                if not (er <= TOL[dtype] and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"gemm kernel vs plain: rel err {er:.3e} > "
                        f"{TOL[dtype]} at M={M} N={N} K={K} {dtype} {cname}")
                worst["abs"] = max(worst["abs"], ea)
                worst["rel"] = max(worst["rel"], er)
                if small["k_split"] > 1:
                    red = kmatmul.splitk_reduce(got)
                    red_want = kmatmul.splitk_reduce_plain(got)
                    torch.cuda.synchronize()
                    ea_r, er_r = rel_err(red, red_want)
                    if dtype == torch.bfloat16:
                        ulps = ulp_distance(red, red_want)
                        worst["reduce_ulp"] = max(worst["reduce_ulp"], ulps)
                        bad = ulps > 1
                    else:
                        worst["reduce_fp32_rel"] = max(
                            worst["reduce_fp32_rel"], er_r)
                        bad = er_r > REDUCE_TOL_FP32
                    if bad:
                        raise AssertionError(
                            f"split-K reduction vs plain: rel err "
                            f"{er_r:.3e} at M={M} N={N} K={K} {dtype} "
                            f"{cname}")
                    worst["reduce_abs"] = max(worst["reduce_abs"], ea_r)
                    n_reduce += 1
                oracle = matmul_ref(a, b)
                _, er_ref = rel_err(ops.matmul(a, b, cfg), oracle)
                if er_ref > TOL[dtype]:
                    # acc32=0 rounds the running sum to bf16 after every
                    # sub-dot; over a long K the config's own arithmetic
                    # drifts past the tolerance, and the gate rejects it
                    with plain_kernels():
                        _, er_plain = rel_err(ops.matmul(a, b, cfg), oracle)
                    if cfg["acc32"] or er_plain <= TOL[dtype]:
                        raise AssertionError(
                            f"gemm vs matmul_ref: rel err {er_ref:.3e} at "
                            f"M={M} N={N} K={K} {dtype} {cname} (plain "
                            f"version {er_plain:.3e})")
                    drift.append(f"{cname} at {M}x{N}x{K} ({er_ref:.3f}, "
                                 f"plain {er_plain:.3f})")
                n += 1
    phase("gemm", f"{n} kernel-vs-plain checks passed over {len(shapes)} "
          f"shapes and {len(CHECK_CONFIGS)} configs (every bf16 warp "
          f"layout); max abs err {worst['abs']:.3e}, max rel err "
          f"{worst['rel']:.3e} (tolerance bf16 {TOL[torch.bfloat16]}, fp32 "
          f"{TOL[torch.float32]}); every result within the tolerance of the "
          f"fp32 oracle but {len(drift)} acc32=0 ones whose plain version "
          f"drifts past it too (a config the gate rejects; the first "
          f"{drift[:4]}); "
          f"{n_reduce} split-K reduction passes vs plain: bf16 "
          f"at most {worst['reduce_ulp']} ulp apart (held to 1), fp32 max "
          f"rel err {worst['reduce_fp32_rel']:.3e} (held to "
          f"{REDUCE_TOL_FP32}); max abs err {worst['reduce_abs']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s")
    return worst


def phase_conv_check(dev: torch.device) -> dict:
    """Kernel partials against the plain version's, every config at every
    Table 5 shape in bf16 (and the default config in fp32 at four); the
    reduced result against the fp32 oracle where the config accumulates in
    fp32.  acc32=0 rounds the running sum after every window, which is the
    plain version's rounding too; its drift from the oracle is printed,
    and the tune phase's gate rejects a config where it passes the bf16
    tolerance."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = {"abs": 0.0, "rel": 0.0, "oracle_rel": 0.0, "acc32_0_rel": 0.0}
    cases = [(x, row[-1], cname, cfg, torch.bfloat16)
             for x, row in zip(CONV_SHAPES, TABLE5)
             for cname, cfg in CONV_CHECK_CONFIGS.items()]
    cases += [(x, row[-1], "default", dict(ops.DEFAULT_CONV), torch.float32)
              for x, row in zip(CONV_SHAPES, TABLE5) if row[-1] in CONV_FP32]
    for x, name, cname, cfg, dtype in cases:
        i, f = conv_operands(x, dtype, gen, dev)
        small = ops.shrink_conv_cfg(cfg, *conv_dims(x))
        got = kconv.conv(i, f, small)
        want = kconv.conv2d_plain(i, f, small)
        torch.cuda.synchronize()
        ea, er = rel_err(got, want)
        if not (er <= TOL[dtype] and torch.isfinite(got).all()):
            raise AssertionError(f"conv kernel vs plain: rel err {er:.3e} > "
                                 f"{TOL[dtype]} at {name} {dtype} {cname}")
        worst["abs"] = max(worst["abs"], ea)
        worst["rel"] = max(worst["rel"], er)
        _, er_ref = rel_err(ops.conv2d(i, f, cfg), conv2d_ref(i, f))
        if not small["acc32"]:
            worst["acc32_0_rel"] = max(worst["acc32_0_rel"], er_ref)
        elif er_ref > TOL[dtype]:
            raise AssertionError(f"conv vs conv2d_ref: rel err {er_ref:.3e} "
                                 f"at {name} {dtype} {cname}")
        else:
            worst["oracle_rel"] = max(worst["oracle_rel"], er_ref)
        del i, f, got, want
    phase("conv", f"{len(cases)} kernel-vs-plain checks over the 14 Table 5 "
          f"shapes passed; max abs err {worst['abs']:.3e}, max rel err "
          f"{worst['rel']:.3e}; acc32=1 cases vs the fp32 oracle max rel "
          f"err {worst['oracle_rel']:.3e}; acc32=0 cases' drift from the "
          f"oracle (not held) max rel err {worst['acc32_0_rel']:.3e} "
          f"(tolerance bf16 "
          f"{TOL[torch.bfloat16]}, fp32 {TOL[torch.float32]})")
    return worst


def phase_attention_check(dev: torch.device) -> dict:
    """The attention kernel against its plain version (same config, same
    block walk and rounding) and the fp32 oracle, every config at every
    shape in bf16, the acc32=1 configs in fp32 too.  The three C1 shapes
    are non-causal with a KV length no block size divides."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    worst = {"abs": 0.0, "rel": 0.0, "oracle_rel": 0.0}
    n = 0
    for name, (B, Hq, Hkv, Lq, Lkv, D), causal, off in ATTN_CHECKS:
        x = attention_input(B, Hq, Hkv, Lq, Lkv, D)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_operands(x, dtype, gen, dev)
            oracle = dispatch._attention_oracle(q, k, v, causal) if off == 0 \
                else attention_ref(q, k, v, causal=causal, q_offset=off)
            for cname, cfg in ATTN_CHECK_CONFIGS.items():
                if dtype == torch.float32 and not cfg["acc32"]:
                    continue
                bits = torch.finfo(dtype).bits
                small = ops.shrink_attention_cfg(cfg, Lq, Lkv, D, bits,
                                                 group=Hq // Hkv)
                got = kattention.attention(q, k, v, small, causal=causal,
                                           q_offset=off)
                want = kattention.attention_plain(q, k, v, small,
                                                  causal=causal, q_offset=off)
                torch.cuda.synchronize()
                ea, er = rel_err(got, want)
                _, eo = rel_err(got, oracle)
                tol_o = TOL[torch.bfloat16] if dtype == torch.bfloat16 \
                    else ORACLE_TOL_FP32["attention"]
                if not (er <= TOL[dtype] and eo <= tol_o
                        and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"attention kernel at {name} {dtype} {cname}: rel err "
                        f"{er:.3e} vs plain (tol {TOL[dtype]}), {eo:.3e} vs "
                        f"the fp32 oracle (tol {tol_o})")
                worst = {"abs": max(worst["abs"], ea),
                         "rel": max(worst["rel"], er),
                         "oracle_rel": max(worst["oracle_rel"], eo)}
                n += 1
                del got, want
            del q, k, v, oracle
    phase("attention", f"{n} kernel-vs-plain and kernel-vs-oracle checks "
          f"passed over {len(ATTN_CHECKS)} shapes (decode with q_offset, "
          f"causal prefill with GQA 3 and 5, the C1 shapes, packed rows "
          f"straddling heads, decode at GQA 5 and 8); max abs err "
          f"{worst['abs']:.3e}, max rel err {worst['rel']:.3e} vs plain; max "
          f"rel err {worst['oracle_rel']:.3e} vs the fp32 oracle (tolerance "
          f"bf16 {TOL[torch.bfloat16]}; fp32 {TOL[torch.float32]} vs plain, "
          f"{ORACLE_TOL_FP32['attention']} vs the oracle)")
    return worst


def phase_ssd_check(dev: torch.device) -> dict:
    """The SSD kernel against its plain version and the sequential fp32
    oracle, every config at every shape in bf16, the acc32=1 ones in fp32."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    worst = {"abs": 0.0, "rel": 0.0, "oracle_rel": 0.0}
    n = 0
    for name, (B, L, H, P, S) in SSD_CHECKS:
        x = ssd_input(B, L, H, P, S)
        for dtype in (torch.bfloat16, torch.float32):
            args = ssd_operands(x, dtype, gen, dev)
            oracle = ssd_ref(*args)
            for cname, cfg in SSD_CHECK_CONFIGS.items():
                if dtype == torch.float32 and not cfg["acc32"]:
                    continue
                small = ops.shrink_ssd_cfg(cfg, L, H, P, S,
                                           torch.finfo(dtype).bits)
                got = kssd.ssd(*args, small)
                want = kssd.ssd_plain(*args, small)
                torch.cuda.synchronize()
                ea, er = rel_err(got, want)
                _, eo = rel_err(got, oracle)
                tol_o = TOL[torch.bfloat16] if dtype == torch.bfloat16 \
                    else ORACLE_TOL_FP32["ssd"]
                if not (er <= TOL[dtype] and eo <= tol_o
                        and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"ssd kernel at {name} {dtype} {cname} ({small}): rel "
                        f"err {er:.3e} vs plain (tol {TOL[dtype]}), {eo:.3e} "
                        f"vs the fp32 oracle (tol {tol_o})")
                worst = {"abs": max(worst["abs"], ea),
                         "rel": max(worst["rel"], er),
                         "oracle_rel": max(worst["oracle_rel"], eo)}
                n += 1
            del args, oracle
    phase("ssd", f"{n} kernel-vs-plain and kernel-vs-oracle checks passed "
          f"over {len(SSD_CHECKS)} shapes (ragged L, P=24 S=40 included); "
          f"max abs err {worst['abs']:.3e}, max rel err {worst['rel']:.3e} vs plain; max "
          f"rel err {worst['oracle_rel']:.3e} vs the sequential fp32 oracle "
          f"(tolerance bf16 {TOL[torch.bfloat16]}; fp32 {TOL[torch.float32]} "
          f"vs plain, {ORACLE_TOL_FP32['ssd']} vs the oracle)")
    return worst


def neighbours(x: dict, dims: tuple) -> list:
    """``x`` and, for each of ``dims``, ``x`` with that dim halved and
    doubled: the pool the tune phase's dataset is drawn from.  A dim given
    as a tuple of names scales them together (a causal prefill's Lq and
    Lkv)."""
    out = [dict(x)]
    for d in dims:
        names = d if isinstance(d, tuple) else (d,)
        for f in (0.5, 2):
            out.append({**x, **{k: max(1, int(x[k] * f)) for k in names}})
    return out


def tune_space(space, targets: list, dims, backend, store,
               samples: int = 0) -> dict:
    """The offline loop for one space, built from the library's public
    pieces: fit the sampler on the target-and-neighbour pool, label a
    dataset of ``samples`` configs (default :data:`TUNE_SAMPLES`) on the
    card, train the regressor, run a tuning session.  ``dims`` names the
    dims each target's neighbours vary (or maps a target to them)."""
    samples = samples or TUNE_SAMPLES[space.name]
    pool = []
    for x in targets:
        d = dims(x) if callable(dims) else dims
        pool += [y for y in neighbours(x, d) if y not in pool]
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    sampler = CategoricalSampler(space).fit(pool, 2000, rng)
    t1 = time.perf_counter()
    inputs, cfgs, ys = [], [], []
    rejected = 0
    while len(cfgs) < samples:
        x = pool[rng.integers(len(pool))]
        cfg = sampler.sample_legal(x, rng)
        if cfg is None:
            continue
        try:
            ys.append(backend.measure(space.name, cfg, x))
        except ConfigRejected:      # the gate's verdict, as generate_dataset
            rejected += 1
            continue
        inputs.append(x)
        cfgs.append(cfg)
    t2 = time.perf_counter()
    train, val = Dataset(space, inputs, cfgs, np.asarray(ys)).split(
        val_frac=0.1, seed=0)
    feat, X, y = train.featurize(Featurizer(space))
    _, Xv, yv = val.featurize(feat)
    model = MLP.create(0, feat.dim, TUNE_HIDDEN)
    hist = model.fit(X, y, epochs=TUNE_EPOCHS, batch_size=TUNE_BATCH,
                     X_val=Xv, y_val=yv)
    t3 = time.perf_counter()
    tuner = InputAwareTuner(space=space, model=model, featurizer=feat,
                            sampler=sampler, backend=backend,
                            top_k=TUNE_TOP_K)
    report = TuningSession(tuner, store, workers=4).run(targets)
    if report.failed or report.tuned != len(targets):
        raise AssertionError(f"tune {space.name}: {report.tuned}/"
                             f"{len(targets)} tuned, {report.failed} failed: "
                             f"{report.errors}")
    out = {"space": space.name, "samples": len(cfgs), "pool": len(pool),
           "rejected": rejected,
           "val_mse": hist[-1], "sampler_s": t1 - t0, "label_s": t2 - t1,
           "train_s": t3 - t2, "session_s": report.wall_s,
           "tuned": report.tuned, "failed": report.failed, "tuner": tuner}
    phase("tune", f"{space.name}: {out['samples']} samples measured on the "
          f"card over {out['pool']} shapes ({rejected} sampled configs "
          f"rejected by the gate), val MSE {out['val_mse']:.4f} "
          f"(log2 TFLOPS); wall: sampler {out['sampler_s']:.1f} s, label "
          f"{out['label_s']:.1f} s, train {out['train_s']:.1f} s, session "
          f"{out['session_s']:.1f} s; {report.tuned}/{len(targets)} tuned, "
          f"{report.failed} failed")
    for rec in sorted(report.records, key=lambda r: sorted(r.inputs.items())):
        phase("tune", f"  {space.name} {rec.inputs} -> {rec.config} "
              f"{rec.tflops:.3f} TFLOPS, {rec.latency_us:.2f} us")
    return out


def attention_dims(x: dict) -> tuple:
    """Neighbour dims of an attention target: a decode step's batch and
    cache length; a causal prefill's batch and its length (Lq and Lkv
    together, so the neighbour stays a causal square)."""
    return ("B", "Lkv") if x["Lq"] == 1 else ("B", ("Lq", "Lkv"))


def phase_tune(backend, store: RecordStore, fp: str, dev: torch.device
               ) -> dict:
    """The tuning path: all four spaces tuned into ``store``, then every
    tuned shape served through ``dispatch`` from it: each a hit of the
    plan the install compiles, on an entry compiled from the shape's exact
    record, within the bf16 tolerance of the plain version under the same
    config and of the fp32 oracle, at full size."""
    gemm_targets = [gemm_input(M, N, K, 16) for M in SLICE_M
                    for (N, K) in SLICE_NK]
    stats = [tune_space(GEMM_SPACE, gemm_targets, ("M", "N", "K"), backend,
                        store),
             tune_space(CONV_SPACE, CONV_SHAPES, ("N", "H", "W", "C", "K"),
                        backend, store),
             tune_space(ATTENTION_SPACE, [x for _, x, _ in ATTN_TARGETS],
                        attention_dims, backend, store),
             tune_space(SSD_SPACE, [x for _, x in SSD_TARGETS],
                        ("B", "L", "H"), backend, store)]
    install_store(store, fingerprint=fp)
    plan = serving_state().plan
    dispatch.reset_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    bf16 = torch.bfloat16
    # (space, name, shape, operands, q_offset for attention)
    cases = []
    for x in gemm_targets:
        a = torch.randn((x["M"], x["K"]), generator=gen, device=dev)
        b = torch.randn((x["K"], x["N"]), generator=gen, device=dev
                        ) / x["K"] ** 0.5
        cases.append(("gemm", f"M={x['M']} N={x['N']} K={x['K']}", x,
                      (a.bfloat16(), b.bfloat16()), 0))
    for x, row in zip(CONV_SHAPES, TABLE5):
        cases.append(("conv", row[-1], x, conv_operands(x, bf16, gen, dev), 0))
    cases += [("attention", name, x, None, off) for name, x, off in ATTN_TARGETS]
    cases += [("ssd", name, x, None, 0) for name, x in SSD_TARGETS]
    worst = {"plain": 0.0, "oracle": 0.0}
    for space, name, x, args, off in cases:
        cfg = store.get(space, x, backend=fp).config
        if plan.lookup(space, shape_key(x)) != (cfg, "exact"):
            raise AssertionError(f"plan entry of {space} {name}: "
                                 f"{plan.lookup(space, shape_key(x))}, want "
                                 f"the exact record's {cfg}")
        if space == "gemm":
            out, want_shape = dispatch.matmul(*args), (x["M"], x["N"])
            with plain_kernels():
                plain = ops.matmul(*args, cfg)
            oracle = matmul_ref(*args)
        elif space == "conv":
            out = dispatch.conv2d(*args)
            want_shape = (x["N"], x["H"], x["W"], x["K"])
            with plain_kernels():
                plain = ops.conv2d(*args, cfg)
            oracle = conv2d_ref(*args)
        elif space == "attention":
            args = attention_operands(x, bf16, gen, dev)
            out = dispatch.flash_attention(*args, causal=True, q_offset=off)
            want_shape = tuple(args[0].shape)
            with plain_kernels():
                plain = ops.flash_attention(*args, cfg, causal=True,
                                            q_offset=off)
            oracle = dispatch._attention_oracle(*args, True, q_offset=off)
        else:
            args = ssd_operands(x, bf16, gen, dev)
            out, want_shape = dispatch.ssd_scan(*args), tuple(args[0].shape)
            with plain_kernels():
                plain = ops.ssd_scan(*args, cfg)
            oracle = ssd_ref(*args)
        torch.cuda.synchronize()
        er = {"plain": rel_err(out, plain)[1], "oracle": rel_err(out, oracle)[1]}
        if tuple(out.shape) != want_shape or max(er.values()) > TOL[
                torch.bfloat16] or not torch.isfinite(out).all():
            raise AssertionError(f"dispatch.{space} at {name} under {cfg}: "
                                 f"shape {tuple(out.shape)}, rel err {er}")
        worst = {k: max(worst[k], er[k]) for k in worst}
        del args, out, plain, oracle
    tiers = dict(dispatch.tier_counts)
    want_tiers = {("gemm", "plan"): len(gemm_targets),
                  ("conv", "plan"): len(CONV_SHAPES),
                  ("attention", "plan"): len(ATTN_TARGETS),
                  ("ssd", "plan"): len(SSD_TARGETS)}
    if tiers != want_tiers:
        raise AssertionError(f"dispatch tiers {tiers}")
    phase("tune", f"dispatch.matmul over the 8 GEMM, dispatch.conv2d over "
          f"the 14 Table 5, dispatch.flash_attention over the "
          f"{len(ATTN_TARGETS)} attention and dispatch.ssd_scan over the "
          f"{len(SSD_TARGETS)} SSD shapes from the tuned store: all plan "
          f"hits on entries compiled from the exact records "
          f"({plan.stats()['tiers']}, compiled in {plan.compile_ms:.2f} ms); "
          f"max rel err {worst['plain']:.3e} vs the plain version under the "
          f"same config, {worst['oracle']:.3e} vs the fp32 oracle (tolerance "
          f"{TOL[torch.bfloat16]})")
    return {"stats": stats,
            "tuners": {"gemm": stats[0]["tuner"],
                       "attention": stats[2]["tuner"]}}


def gemm_weights(M: int, N: int, K: int, gen: torch.Generator,
                 dev: torch.device) -> tuple:
    """A (M, K) operand and enough (K, N) weight copies that one pass over
    them exceeds L2 (in a forward every weight matrix is read cold)."""
    a = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    n_calls = min(1000, max(20, math.ceil(2.5 * L2_BYTES / (K * N * 2))))
    bs = [torch.randn((K, N), generator=gen, device=dev).bfloat16()
          for _ in range(n_calls)]
    return a, bs


def phase_models(backend, store: RecordStore, store_path: Path, fp: str,
                 cfg, params, dev: torch.device, label: str) -> dict:
    """The tuner's model tier on the card.  Label ``MODEL_PER_SHAPE``
    random legal configs at each tuned GEMM shape (gated, timed:
    ``collect_samples``), train the GEMM regressor from the store's whole
    log, save it beside the store and load it back.  Serve requests of
    prompt lengths nobody tuned from an engine that finds the artifacts:
    every prefill GEMM whose shape has no record resolves on the model
    tier, the rest (32-token prefills, the capture's ticks) exact; the
    graph tick's greedy tokens equal the eager tick's; the 100-token
    prefill's logits agree with the plain version's.  Then, at the four
    projections and M in ``MODEL_M``, time (a) the model's pick, (b) the
    best of its top ``MODEL_TOP_K`` re-measured, (c) the nearest tuned
    record's config (what dispatch served before the model tier), (d) the
    heuristic's config and (e) ``torch.matmul``; each pick (a) and (b)
    must pass ``dispatch.check_config`` at its whole shape."""
    reset_launches()
    t0 = time.perf_counter()
    n_samples = collect_samples(store, backend, per_shape=MODEL_PER_SHAPE,
                                space="gemm")
    t1 = time.perf_counter()
    # the samples went into the installed store: its plan stands aside
    plan = serving_state().plan
    x0 = gemm_input(SLICE_M[0], *next(iter(SLICE_NK)), 16)
    tier = dispatch._resolve_cfg("gemm", x0)[1]
    if plan.store_version == store.version or tier != "exact":
        raise AssertionError(f"models: plan at store version "
                             f"{plan.store_version}, store at {store.version}"
                             f"; a tuned shape resolved on tier {tier}")
    phase("models", f"collect_samples appended to the installed store "
          f"(version {plan.store_version} -> {store.version}): the plan "
          f"stands aside, a tuned shape resolves on the exact tier")
    trained = train_models(store, space="gemm", backend=fp,
                           hidden=TUNE_HIDDEN, epochs=MODEL_EPOCHS)
    t2 = time.perf_counter()
    models_dir = default_models_dir(store_path)
    trained.save(models_dir)
    models = ModelSet.load(models_dir)
    if len(models) != 1 or models.skipped:
        raise AssertionError(f"models: {len(models)} loaded from "
                             f"{models_dir}, skipped {models.skipped}")
    meta = models.resolve_model("gemm", fp).meta
    phase("models", f"gemm: {n_samples} samples labelled on the card "
          f"({MODEL_PER_SHAPE} per tuned shape, gated), {meta['n_samples']} "
          f"in the training set with the tune phase's records and samples; "
          f"MLP {TUNE_HIDDEN}, {MODEL_EPOCHS} epochs, val MSE "
          f"{meta['val_mse']:.4f} (log2 TFLOPS); collect {t1 - t0:.1f} s, "
          f"train {t2 - t1:.1f} s")

    serve = models_serve(store_path, fp, cfg, params, dev)
    picks = models_picks(models, backend, store, fp, cfg, dev, label)
    return {"counts": serve["counts"], "samples": n_samples, "meta": meta,
            **serve, **picks}


def models_serve(store_path: Path, fp: str, cfg, params, dev: torch.device
                 ) -> dict:
    """The models phase's serve run: prompt lengths nobody tuned, from an
    engine that finds the store's artifacts (see :func:`phase_models`).
    Each untuned length's 4 distinct projection shapes resolve on the
    model tier once and are promoted into the plan's overlay, so their
    repeats are plan hits.  Then a reinstall compiles the telemetry's hot
    set (every GEMM shape it saw) into the plan's base table, and a second
    serve of the same prompts books no model-tier resolution and gives
    the same tokens."""
    eng = Engine(cfg, params, ServeConfig(max_len=256, slots=4,
                                          tunedb=str(store_path),
                                          tunedb_backend=fp))
    if eng.tunedb_models is None or len(eng.tunedb_models) != 1:
        raise AssertionError("the engine did not find the model artifacts")
    prompts = model_prompts(cfg)
    per_fwd = GEMMS_PER_LAYER * cfg.n_layers
    dispatch.reset_counts()
    outs = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    tiers = {t: c for (sp, t), c in dispatch.tier_counts.items()
             if sp == "gemm"}
    untuned = [n for n in MODEL_PROMPTS if n not in SLICE_M]
    n_model = len(SLICE_NK) * len(untuned)
    # each graph's capture and its warm-up resolve a forward; a replay
    # resolves nothing (the untuned shapes on the model tier once, at
    # their length's warm-up, then from the plan's overlay)
    traced = 2 * (eng.prefill_captures + eng.captures)
    want = {"plan": per_fwd * traced - n_model, "model": n_model}
    if (eng.captures, eng.prefill_captures) != (1, len(MODEL_PROMPTS)) \
            or tiers != want:
        raise AssertionError(f"models serve: GEMM resolutions {tiers}, want "
                             f"{want} ({eng.captures} tick and "
                             f"{eng.prefill_captures} prefill captures)")
    pool_bytes = eng.prefill_graph_bytes()
    pool = pool_makeup(eng.prefill_pool_segments())
    if pool["bytes"] != pool_bytes:
        raise AssertionError(f"models: pool segments {pool}, {pool_bytes} "
                             "bytes")
    # the largest split-K partials buffer (k_split, M, N) bf16 each
    # length's graph allocates, under the configs it was captured with
    partials = {}
    for n in MODEL_PROMPTS:
        sizes = []
        for (N, K) in SLICE_NK:
            entry = serving_state().plan.lookup(
                "gemm", shape_key(gemm_input(n, N, K, 16)))
            if entry is None:
                raise AssertionError(f"models: M={n} N={N} K={K} not planned")
            sizes.append(entry[0]["k_split"] * n * N * 2
                         if entry[0]["k_split"] > 1 else 0)
        partials[n] = max(sizes)
    counts = read_launches()
    eng.prefill, eng.decode = eng.prefill_eager, eng.decode_eager
    try:
        eager = eng.generate(prompts, max_new=16)
    finally:
        eng.prefill, eng.decode = eng.prefill_graph, eng.decode_graph
    if eager != outs or [len(o) for o in outs] != [16] * len(prompts):
        raise AssertionError("models serve: greedy tokens from the graphs "
                             "differ from the eager prefill and tick's")
    tokens = torch.as_tensor(prompts[MODEL_PROMPTS.index(100)][None],
                             device=dev)
    got = prefill(params, cfg, {"tokens": tokens},
                  init_cache(cfg, 1, 256, dev))[0]
    with plain_kernels():
        plain = prefill(params, cfg, {"tokens": tokens},
                        init_cache(cfg, 1, 256, dev))[0]
    torch.cuda.synchronize()
    _, logit_err = rel_err(got, plain)
    if not (torch.isfinite(got).all() and logit_err <= LOGIT_TOL):
        raise AssertionError(f"models: 100-token prefill logits vs plain rel "
                             f"err {logit_err:.3e}")
    phase("models", f"serve: {len(prompts)} requests of prompt lengths "
          f"{list(MODEL_PROMPTS)} x 16 tokens; GEMM resolutions {tiers} "
          f"({len(MODEL_PROMPTS)} prefill graphs and 1 tick graph captured, "
          f"each capture and its warm-up resolving a forward, no replay "
          f"resolving any: each of the {len(untuned)} untuned lengths' "
          f"{len(SLICE_NK)} shapes on the model tier once, then promoted); "
          f"the {len(MODEL_PROMPTS)} lengths' prefill graphs hold "
          f"{pool_bytes} bytes ({pool_bytes / 2**20:.1f} MiB) in their "
          f"shared pool ({pool['segments']} segments of "
          f"{pool['segment_sizes']} bytes; {pool['active']} bytes in "
          f"{pool['n_active']} live blocks, the largest "
          f"{pool['largest_active']}; the largest split-K partials buffer "
          f"of each length's graph {partials} bytes); launches {counts}; "
          f"the graphs and "
          f"the eager "
          f"prefill and tick give the same greedy tokens; 100-token "
          f"prefill logits vs plain rel err {logit_err:.3e} (tolerance "
          f"{LOGIT_TOL})")

    # reinstall: the telemetry's hot set compiles into the base table
    state = serving_state()
    hot_k = len(get_telemetry().hot_shapes("gemm", 1 << 20))
    install_serving(store=state.store, models=state.models, fingerprint=fp,
                    plan_hot_k=hot_k)
    plan = serving_state().plan
    for n in untuned:
        for (N, K) in SLICE_NK:
            entry = plan.lookup("gemm", shape_key(gemm_input(n, N, K, 16)))
            if entry is None or entry[1] != "model":
                raise AssertionError(f"reinstalled plan: M={n} N={N} K={K} "
                                     f"-> {entry}, want a model entry")
    captures = (eng.captures, eng.prefill_captures)
    dispatch.reset_counts()
    again = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    tiers2 = {t: c for (sp, t), c in dispatch.tier_counts.items()
              if sp == "gemm"}
    recaptured = (eng.captures - captures[0],
                  eng.prefill_captures - captures[1])
    want2 = {"plan": per_fwd * 2 * sum(recaptured)}
    if again != outs or tiers2 != want2 or recaptured != (
            1, len(MODEL_PROMPTS)):
        raise AssertionError(f"models second serve: GEMM resolutions "
                             f"{tiers2}, want {want2} ({recaptured} tick "
                             f"and prefill captures); tokens equal: "
                             f"{again == outs}")
    phase("models", f"reinstall with plan_hot_k={hot_k} (the GEMM shapes "
          f"the telemetry saw): plan {plan.stats()['tiers']} in "
          f"{plan.compile_ms:.1f} ms; second serve of the same requests: "
          f"GEMM resolutions {tiers2} (0 on the model tier; the new "
          f"generation re-captures the tick and the {len(MODEL_PROMPTS)} "
          f"prefills), the same greedy tokens")
    return {"counts": counts, "logit_err": logit_err,
            "pool_bytes": pool_bytes}


def pool_makeup(segments: list) -> dict:
    """What a graph memory pool holds, from its allocator segments: their
    sizes, and the bytes of the blocks still live in them (a graph's
    output and whatever the allocator keeps for its replays)."""
    live = sorted((b["size"] for seg in segments for b in seg["blocks"]
                   if b["state"].startswith("active")), reverse=True)
    return {"bytes": sum(seg["total_size"] for seg in segments),
            "segments": len(segments),
            "segment_sizes": sorted((seg["total_size"] for seg in segments),
                                    reverse=True),
            "active": sum(live), "n_active": len(live),
            "largest_active": live[:4]}


def model_prompts(cfg) -> list:
    """The models phase's requests: one of each length nobody tuned
    (and one of the tuned 32)."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab, n) for n in MODEL_PROMPTS]


def models_picks(models: ModelSet, backend, store: RecordStore, fp: str,
                 cfg, dev: torch.device, label: str) -> dict:
    """(a)-(e) of :func:`phase_models` at the shapes nobody tuned."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    lib = VendorHeuristicLibrary.gemm(GEMM_SPACE)
    remeasure = ModelSet(measurer=backend.measure,
                         remeasure_top_k=MODEL_TOP_K)
    remeasure.models.update(models.models)
    legal = functools.partial(launchable, "gemm")
    cols = ("model", "remeasured", "nearest", "heuristic", "library")
    rows = []
    for M in MODEL_M:
        for (N, K) in SLICE_NK:
            x = gemm_input(M, N, K, 16)
            picks = {"model": models.predict("gemm", x, backend=fp),
                     "remeasured": remeasure.predict("gemm", x, backend=fp)}
            if None in picks.values():
                raise AssertionError(f"models: no pick at {x}: {picks}")
            picks = {k: v[0] for k, v in picks.items()}
            for what in ("model", "remeasured"):
                dispatch.check_config("gemm", picks[what], x, device=dev)
            picks["nearest"] = store.nearest("gemm", x, backend=fp,
                                             legal=legal).config
            picks["heuristic"] = lib.select(x)
            a, bs = gemm_weights(M, N, K, gen, dev)
            ms = {k: time_ms(lambda i, c=c: ops.matmul(a, bs[i], c), len(bs))
                  for k, c in picks.items()}
            ms["library"] = time_ms(lambda i: torch.matmul(a, bs[i]), len(bs))
            del a, bs
            rows.append({"M": M, "N": N, "K": K, "picks": picks, "ms": ms})
            phase("models", f"gemm M={M} N={N} K={K}: model "
                  f"{picks['model']} {ms['model'] * 1e3:.2f} us, "
                  f"re-measured top-{MODEL_TOP_K} {picks['remeasured']} "
                  f"{ms['remeasured'] * 1e3:.2f} us, nearest record "
                  f"{picks['nearest']} {ms['nearest'] * 1e3:.2f} us, "
                  f"heuristic {ms['heuristic'] * 1e3:.2f} us, torch.matmul "
                  f"{ms['library'] * 1e3:.2f} us [{label}]")
    sums = {M: {c: sum(r["ms"][c] * SLICE_NK[(r["N"], r["K"])] * cfg.n_layers
                       for r in rows if r["M"] == M) for c in cols}
            for M in MODEL_M}
    for M, t in sums.items():
        phase("models", f"M={M}, one forward's "
              f"{GEMMS_PER_LAYER * cfg.n_layers} GEMMs: model "
              f"{t['model']:.3f} ms, re-measured {t['remeasured']:.3f} ms, "
              f"nearest record {t['nearest']:.3f} ms, heuristic "
              f"{t['heuristic']:.3f} ms, torch.matmul {t['library']:.3f} ms "
              f"[{label}]; every pick passed the gate at its whole shape")
    return {"rows": rows, "sums": sums}


def reduce_bound(ks: int, M: int, N: int, dtype: torch.dtype, peaks: dict
                 ) -> dict:
    """The split-K reduction: ``ks`` partials read once, the sum written
    once; (ks - 1)·M·N fp32 adds."""
    bpe = torch.finfo(dtype).bits // 8
    return bound((ks + 1) * M * N * bpe, (ks - 1) * M * N, torch.float32,
                 peaks)


def phase_times(dev: torch.device, peaks: dict, label: str) -> tuple:
    """Per shape: the tuned config (dispatch's exact tier), the vendor
    heuristic's config, the plain version under the tuned config, the
    library call and the bound.  For the GEMM also the kernel alone and,
    where the tuned config splits K, the reduction pass alone on its
    partials, beside its plain version, ``parts.sum(dim=0)`` (one PyTorch
    call that computes the same function) and its bound."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gemm_lib = VendorHeuristicLibrary.gemm(GEMM_SPACE)
    gemm_rows = []
    for M in SLICE_M:
        for (N, K) in SLICE_NK:
            dtype = torch.bfloat16
            x = gemm_input(M, N, K, 16)
            cfg, tier = dispatch._resolve_cfg("gemm", x)
            heur = gemm_lib.select(x)
            # cycle through enough weight copies that the set exceeds L2:
            # in a decode tick every weight matrix is read cold
            a, bs = gemm_weights(M, N, K, gen, dev)
            n_calls = len(bs)
            run = ops.shrink_gemm_cfg(cfg, M, N, K)
            ks = run["k_split"]
            kernel = time_ms(lambda i: ops.matmul(a, bs[i], cfg), n_calls)
            alone = time_ms(lambda i: kmatmul.gemm(a, bs[i], run), n_calls)
            heuristic = time_ms(lambda i: ops.matmul(a, bs[i], heur), n_calls)
            with plain_kernels():
                plain = time_ms(lambda i: ops.matmul(a, bs[i], cfg), n_calls)
            library = time_ms(lambda i: torch.matmul(a, bs[i]), n_calls)
            red = {"reduce_ms": 0.0, "reduce_plain_ms": 0.0,
                   "reduce_library_ms": 0.0, "reduce_t_bytes": 0.0,
                   "reduce_t_ops": 0.0}
            if ks > 1:
                parts = kmatmul.gemm(a, bs[0], run)
                _, er = rel_err(parts.sum(dim=0),
                                kmatmul.splitk_reduce_plain(parts))
                if er > TOL[dtype]:
                    raise AssertionError(f"parts.sum disagrees with the "
                                         f"plain reduction: rel err {er:.3e}")
                rb = reduce_bound(ks, M, N, dtype, peaks)
                red = {"reduce_ms": time_ms(
                           lambda i: kmatmul.splitk_reduce(parts), n_calls),
                       "reduce_plain_ms": time_ms(
                           lambda i: kmatmul.splitk_reduce_plain(parts),
                           n_calls),
                       "reduce_library_ms": time_ms(
                           lambda i: parts.sum(dim=0), n_calls),
                       "reduce_t_bytes": rb["t_bytes"],
                       "reduce_t_ops": rb["t_ops"]}
            del bs
            gemm_rows.append({"M": M, "N": N, "K": K, "tier": tier,
                              "cfg": cfg, "k_split": ks,
                              "heuristic_cfg": heur, "kernel_ms": kernel,
                              "gemm_ms": alone, **red,
                              "heuristic_ms": heuristic,
                              "plain_ms": plain, "library_ms": library,
                              **gemm_bound(M, N, K, dtype, peaks)})
            r = gemm_rows[-1]
            phase("times", f"gemm M={M} N={N} K={K} bf16 tier={tier} "
                  f"tuned {cfg} (k_split {ks}): ops.matmul "
                  f"{kernel * 1e3:.2f} us (kernel alone {alone * 1e3:.2f} "
                  f"us, reduction pass alone {r['reduce_ms'] * 1e3:.2f} us; "
                  f"its plain version {r['reduce_plain_ms'] * 1e3:.2f} us, "
                  f"parts.sum {r['reduce_library_ms'] * 1e3:.2f} us), "
                  f"heuristic {heuristic * 1e3:.2f} us, plain "
                  f"{plain * 1e3:.2f} us, torch.matmul {library * 1e3:.2f} "
                  f"us, bound {r['bound_ms'] * 1e3:.2f} us "
                  f"({r['bound_by']}) [{label}]")
    conv_lib = VendorHeuristicLibrary.conv(CONV_SPACE)
    conv_rows = []
    for x, row in zip(CONV_SHAPES, TABLE5):
        dtype = torch.bfloat16
        cfg, tier = dispatch._resolve_cfg("conv", x)
        heur = conv_lib.select(x)
        i, f = conv_operands(x, dtype, gen, dev)
        nbytes = (i.numel() + f.numel()) * 2
        n_calls = max(2, min(8, math.ceil(2.5 * L2_BYTES / nbytes)))
        ins = [i] + [torch.randn(i.shape, generator=gen, device=dev
                                 ).to(dtype) for _ in range(n_calls - 1)]
        # the library call: cuDNN on the same NHWC / RSCK data as
        # channels-last views; padding="same" pads as XLA's SAME does
        w_cl = f.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_fn = lambda j: torch.nn.functional.conv2d(
            ins[j].permute(0, 3, 1, 2), w_cl, padding="same")
        _, er = rel_err(lib_fn(0).permute(0, 2, 3, 1), conv2d_ref(i, f))
        if er > TOL[dtype]:
            raise AssertionError(f"F.conv2d disagrees with conv2d_ref at "
                                 f"{row[-1]}: rel err {er:.3e}")
        kernel = time_ms(lambda j: ops.conv2d(ins[j], f, cfg), n_calls)
        heuristic = time_ms(lambda j: ops.conv2d(ins[j], f, heur), n_calls)
        with plain_kernels():
            plain = time_ms(lambda j: ops.conv2d(ins[j], f, cfg), n_calls)
        library = time_ms(lib_fn, n_calls)
        del ins
        conv_rows.append({"name": row[-1], **x, "tier": tier, "cfg": cfg,
                          "heuristic_cfg": heur, "kernel_ms": kernel,
                          "heuristic_ms": heuristic, "plain_ms": plain,
                          "library_ms": library,
                          **conv_bound(x, dtype, peaks)})
        r = conv_rows[-1]
        phase("times", f"conv {row[-1]} {conv_dims(x)} bf16 tier={tier} "
              f"tuned {kernel:.3f} ms, heuristic {heuristic:.3f} ms, plain "
              f"{plain:.3f} ms, F.conv2d {library:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{label}]")
    return gemm_rows, conv_rows


def phase_gemm_table4(dev: torch.device, peaks: dict, label: str) -> list:
    """The paper's Table 4 in bf16 under the vendor heuristic's config:
    ``ops.matmul`` (a transposed operand passed as a transposed view, so
    its relayout is part of the call), ``torch.matmul`` on the same views,
    the bound and TFLOP/s.  Times are printed, not held; every result is
    held to the fp32 oracle (the heuristic's configs accumulate in fp32)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    bf16 = torch.bfloat16
    lib = VendorHeuristicLibrary.gemm(GEMM_SPACE)
    rows = []
    for M, N, K, ta, tb, suite in TABLE4:
        x = gemm_input(M, N, K, 16, ta, tb)
        cfg = lib.select(x)
        n_calls = max(2, min(20, math.ceil(2.5 * L2_BYTES
                                           / ((M * K + K * N) * 2))))
        sets = []
        for _ in range(n_calls):
            a = torch.randn((K, M) if ta else (M, K), generator=gen,
                            device=dev).to(bf16)
            b = (torch.randn((N, K) if tb else (K, N), generator=gen,
                             device=dev) / K ** 0.5).to(bf16)
            sets.append((a.t() if ta else a, b.t() if tb else b))
        _, er = rel_err(ops.matmul(*sets[0], cfg), matmul_ref(*sets[0]))
        if er > TOL[bf16] or not cfg["acc32"]:
            raise AssertionError(f"Table 4 {suite} M={M} N={N} K={K} under "
                                 f"{cfg}: rel err {er:.3e} vs matmul_ref")
        kernel = time_ms(lambda i: ops.matmul(*sets[i], cfg), n_calls)
        library = time_ms(lambda i: torch.matmul(*sets[i]), n_calls)
        del sets
        bnd = gemm_bound(M, N, K, bf16, peaks)
        flops = 2.0 * M * N * K
        rows.append({"suite": suite, "M": M, "N": N, "K": K, "trans_a": ta,
                     "trans_b": tb, "cfg": cfg,
                     "run_cfg": ops.shrink_gemm_cfg(cfg, M, N, K),
                     "kernel_ms": kernel, "library_ms": library,
                     "tflops": flops / (kernel * 1e-3) / 1e12,
                     "library_tflops": flops / (library * 1e-3) / 1e12,
                     "bound_share": bnd["bound_ms"] / kernel, "rel_err": er,
                     **bnd})
        r = rows[-1]
        phase("gemm-table4", f"{suite} M={M} N={N} K={K} trans_a={ta} "
              f"trans_b={tb} heuristic {cfg}: ops.matmul {kernel:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% "
              f"of the bound), torch.matmul {library:.4f} ms "
              f"({r['library_tflops']:.1f} TFLOP/s), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); rel err vs the "
              f"fp32 oracle {er:.3e} [{label}]")
    return rows


def phase_times_attention_ssd(dev: torch.device, peaks: dict, label: str
                              ) -> tuple:
    """Per attention and SSD target: the tuned config (dispatch's exact
    tier), the ops default config, the plain version under the tuned
    config, SDPA for attention (the PyTorch call the port never makes) and
    the bound.  Operand copies exceed the L2 where one set does not."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bf16 = torch.bfloat16
    attn_rows, ssd_rows = [], []
    usage = _build.ptxas_usage("attention")
    ssd_usage = _build.ptxas_usage("ssd")
    ssd_regs, ssd_spill = ssd_usage[ssd_kernel(ssd_usage, 16)]
    for name, x, off in ATTN_TARGETS:
        cfg, tier = dispatch._resolve_cfg("attention", x)
        one = attention_operands(x, bf16, gen, dev)
        nbytes = sum(t.numel() for t in one) * 2
        n_calls = max(1, min(64, math.ceil(2.5 * L2_BYTES / nbytes)))
        sets = [one] + [attention_operands(x, bf16, gen, dev)
                        for _ in range(n_calls - 1)]
        causal = x["Lq"] == x["Lkv"]        # a decode step sees every key
        sdpa = lambda i: torch.nn.functional.scaled_dot_product_attention(
            *sets[i], is_causal=causal, enable_gqa=True)
        _, er = rel_err(sdpa(0), dispatch._attention_oracle(
            *one, True, q_offset=off))
        if er > TOL[bf16]:
            raise AssertionError(f"SDPA disagrees with attention_ref at "
                                 f"{name}: rel err {er:.3e}")
        run = lambda c: (lambda i: ops.flash_attention(
            *sets[i], c, causal=True, q_offset=off))
        kernel = time_ms(run(cfg), n_calls)
        default = time_ms(run(dict(ops.DEFAULT_ATTN)), n_calls)
        with plain_kernels():
            plain = time_ms(run(cfg), min(n_calls, 2))
        library = time_ms(sdpa, n_calls)
        del sets, one
        regs, spill = usage[attention_kernel(usage, cfg, x["D"], 16)]
        bnd = attention_bound(x, bf16, peaks)
        # prefill: operations bound it, so the rate is TFLOP/s; decode:
        # bytes, so GB/s of q, k, v read and out written once
        rate = (problem_flops("attention", x) / (kernel * 1e-3) / 1e12,
                "TFLOP/s") if x["Lq"] > 1 else (
            bnd["t_bytes"] * peaks["hbm"] / (kernel * 1e-3) / 1e9, "GB/s")
        attn_rows.append({"name": name, **x, "tier": tier, "cfg": cfg,
                          "default_cfg": ops.shrink_attention_cfg(
                              {}, x["Lq"], x["Lkv"], x["D"], 16,
                              group=x["Hq"] // x["Hkv"]),
                          "kernel_ms": kernel, "default_ms": default,
                          "plain_ms": plain, "library_ms": library,
                          "rate": rate[0], "rate_unit": rate[1],
                          "bound_share": bnd["bound_ms"] / kernel,
                          "registers": regs, "spill_bytes": spill, **bnd})
        r = attn_rows[-1]
        phase("times", f"attention {name} (B={x['B']} Hq={x['Hq']} "
              f"Hkv={x['Hkv']} Lq={x['Lq']} Lkv={x['Lkv']} D={x['D']}) bf16 "
              f"tier={tier} tuned {cfg} {kernel:.4f} ms ({rate[0]:.1f} "
              f"{rate[1]}, {100 * r['bound_share']:.1f}% of the bound; "
              f"{regs} registers, {spill} bytes spilled), ops default "
              f"{default:.4f} ms, plain {plain:.4f} ms, SDPA {library:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{label}]")
        if spill:
            raise AssertionError(f"the tuned attention config {cfg} at "
                                 f"{name} spills {spill} bytes")
    for name, x in SSD_TARGETS:
        cfg, tier = dispatch._resolve_cfg("ssd", x)
        one = ssd_operands(x, bf16, gen, dev)
        nbytes = sum(t.numel() * t.element_size() for t in one)
        n_calls = max(1, min(16, math.ceil(2.5 * L2_BYTES / nbytes)))
        sets = [one] + [ssd_operands(x, bf16, gen, dev)
                        for _ in range(n_calls - 1)]
        run = lambda c: (lambda i: ops.ssd_scan(*sets[i], c))
        kernel = time_ms(run(cfg), n_calls)
        default = time_ms(run(dict(ops.DEFAULT_SSD)), n_calls)
        with plain_kernels():
            plain = time_ms(run(cfg), min(n_calls, 2))
        del sets, one
        bnd = ssd_bound(x, bf16, peaks)
        ssd_rows.append({"name": name, **x, "tier": tier, "cfg": cfg,
                         "default_cfg": ops.shrink_ssd_cfg(
                             {}, x["L"], x["H"], x["P"], x["S"], 16),
                         "kernel_ms": kernel, "default_ms": default,
                         "plain_ms": plain, "library_ms": None,
                         "flops": ssd_flops(x),
                         "tflops": ssd_flops(x) / (kernel * 1e-3) / 1e12,
                         "bound_share": bnd["bound_ms"] / kernel,
                         "registers": ssd_regs, "spill_bytes": ssd_spill,
                         **bnd})
        r = ssd_rows[-1]
        phase("times", f"ssd {name} (B={x['B']} L={x['L']} H={x['H']} "
              f"P={x['P']} S={x['S']}) bf16 tier={tier} tuned {cfg} "
              f"{kernel:.4f} ms ({r['tflops']:.2f} TFLOP/s by 4·B·L·H·P·S, "
              f"{100 * r['bound_share']:.2f}% of the bound; {ssd_regs} "
              f"registers, {ssd_spill} bytes spilled), ops default "
              f"{default:.4f} ms, plain {plain:.4f} ms, no single PyTorch "
              f"call computes it, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{label}]")
    return attn_rows, ssd_rows


def per_tick(rows: list, key: str, n_layers: int) -> float:
    """``key`` summed over one decode tick's projections (the M=4 shapes,
    each as often as the model calls it)."""
    return sum(r[key] * SLICE_NK[(r["N"], r["K"])] * n_layers
               for r in rows if r["M"] == 4)


# demangled ("...::gemm_mma_kernel<...>") or mangled
# ("...15gemm_mma_kernelI..."): the bf16 and fp32 GEMM bodies, and the
# split-K reduction pass (``csrc/gemm.cu``)
GEMM_KERNEL = re.compile(r"(^|[\s:]|\d)gemm_(mma|simt)_kernel(\b|I)")
REDUCE_KERNEL = re.compile(r"(^|[\s:]|\d)splitk_reduce_kernel(\b|I)")
# cuBLAS / CUTLASS kernels (torch.matmul, bmm, einsum): the tied head and
# the attention's products in a training step
CUBLAS_KERNEL = re.compile(r"cublas|cutlass|xmma|nvjet|gemv|gemm", re.I)


def _cu(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} returned CUresult {rc}")


CU_GRAPH_NODE_TYPE_KERNEL, CU_GRAPH_NODE_TYPE_GRAPH = 0, 4


def graph_kernel_names(graph) -> list:
    """The function names of a captured CUDA graph's kernel nodes (child
    graphs included), read from its ``cudaGraph_t`` through the driver
    API: the kernels that every replay gives the device."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    cu.cuGraphGetNodes.argtypes = [vp, vp, ctypes.POINTER(sz)]
    cu.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphKernelNodeGetParams_v2.argtypes = [vp, vp]
    cu.cuGraphChildGraphNodeGetGraph.argtypes = [vp, ctypes.POINTER(vp)]
    cu.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    for fn in (cu.cuGraphGetNodes, cu.cuGraphNodeGetType,
               cu.cuGraphKernelNodeGetParams_v2,
               cu.cuGraphChildGraphNodeGetGraph, cu.cuFuncGetName):
        fn.restype = ctypes.c_int

    def walk(handle: int) -> list:
        n = sz(0)
        _cu(cu.cuGraphGetNodes, handle, None, ctypes.byref(n))
        nodes = (vp * n.value)()
        _cu(cu.cuGraphGetNodes, handle, nodes, ctypes.byref(n))
        names = []
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            _cu(cu.cuGraphNodeGetType, node, ctypes.byref(kind))
            if kind.value == CU_GRAPH_NODE_TYPE_GRAPH:
                child = vp()
                _cu(cu.cuGraphChildGraphNodeGetGraph, node,
                    ctypes.byref(child))
                names += walk(child.value)
            elif kind.value == CU_GRAPH_NODE_TYPE_KERNEL:
                # CUDA_KERNEL_NODE_PARAMS_v2 (under 128 bytes): the
                # CUfunction comes first
                params = (ctypes.c_byte * 256)()
                _cu(cu.cuGraphKernelNodeGetParams_v2, node, params)
                name = ctypes.c_char_p()
                _cu(cu.cuFuncGetName, ctypes.byref(name),
                    ctypes.c_void_p.from_buffer(params).value)
                names.append(name.value.decode())
        return names

    return walk(graph.raw_cuda_graph())


def check_plan_exact(plan, store: RecordStore, fp: str, shapes, what: str
                     ) -> None:
    """Every served (space, shape key) in ``shapes`` is planned as its
    tuned record's config on tier ``exact``: a plan hit ran the record's
    config, not a model's, nearest or promoted one."""
    for space, key in shapes:
        rec = store.get(space, dict(key), backend=fp)
        got = plan.lookup(space, key)
        if rec is None or got != (rec.config, "exact"):
            raise AssertionError(f"{what}: plan entry of {space} "
                                 f"{dict(key)} is {got}, want the tuned "
                                 f"record's "
                                 f"{rec.config if rec else None} on tier "
                                 f"exact")


def graph_counts(graph) -> tuple:
    """(GEMM kernel nodes, split-K reduction kernel nodes, all kernel
    nodes) of a captured graph."""
    names = graph_kernel_names(graph)
    return (sum(1 for n in names if GEMM_KERNEL.search(n)),
            sum(1 for n in names if REDUCE_KERNEL.search(n)), len(names))


def splits(store: RecordStore, fp: str, M: int, N: int, K: int) -> int:
    """1 where the shape's tuned config splits K (a reduction pass)."""
    rec = store.get("gemm", gemm_input(M, N, K, 16), backend=fp)
    return int(ops.shrink_gemm_cfg(rec.config, M, N, K)["k_split"] > 1)


def serve_run(eng, what: str, batch: list, max_new: int, per_fwd: int,
              red_pre: int, red_tick: int, attn_per_tick: int) -> dict:
    """One ``eng.generate`` of ``batch``, its host-side launches,
    resolutions and telemetry held to what a forward gives: ``per_fwd``
    GEMMs, ``red_pre`` / ``red_tick`` split-K reduction passes a prefill /
    a tick, ``attn_per_tick`` decode split-count lookups a tick.  The host
    traces a forward at every eager prefill and tick, and twice at a
    capture (the capture and its warm-up); a replay calls nothing on the
    host.  Every resolution must be a plan hit."""
    cfg, tel = eng.cfg, get_telemetry()
    before = (eng.ticks, eng.prefills, eng.captures, eng.replays,
              eng.prefill_captures, eng.prefill_replays,
              kmatmul.launches, kmatmul.reduce_launches)
    eng.tick_times.clear()
    torch.cuda.synchronize()
    dispatch.reset_counts()
    prev = tel.snapshot()
    t0 = time.perf_counter()
    outs = eng.generate(batch, max_new=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window = tel.diff(prev)
    (ticks, prefills, captures, replays, pcaptures, preplays, launches,
     reduce_launches) = (now - b for now, b in zip(
         (eng.ticks, eng.prefills, eng.captures, eng.replays,
          eng.prefill_captures, eng.prefill_replays, kmatmul.launches,
          kmatmul.reduce_launches), before))
    got = {"launches": launches, "reduce_launches": reduce_launches,
           "tiers": {t: c for (sp, t), c in dispatch.tier_counts.items()
                     if sp == "gemm"},
           "attn_tiers": {t: c for (sp, t), c in
                          dispatch.tier_counts.items()
                          if sp == "attention"}}
    if [len(o) for o in outs] != [max_new] * len(batch):
        raise AssertionError(f"{what}: token counts {[len(o) for o in outs]}")
    if any(not (0 <= t < cfg.vocab) for o in outs for t in o):
        raise AssertionError(f"{what}: token outside the vocabulary")
    # forwards the host traced: every eager prefill and tick, or a
    # capture and its eager warm-up
    graph_tick = eng.decode != eng.decode_eager
    graph_prefill = eng.prefill != eng.prefill_eager
    traced_tick = 2 * captures if graph_tick else ticks
    traced_pre = 2 * pcaptures if graph_prefill else prefills
    if (graph_tick and replays != ticks) or (
            graph_prefill and preplays != prefills):
        raise AssertionError(f"{what}: {replays} tick replays for "
                             f"{ticks} ticks, {preplays} prefill "
                             f"replays for {prefills} prefills")
    want_gemm = per_fwd * (traced_pre + traced_tick)
    want = {"launches": want_gemm,
            "reduce_launches": red_pre * traced_pre + red_tick * traced_tick,
            "tiers": {"plan": want_gemm} if want_gemm else {},
            "attn_tiers": {"plan": attn_per_tick * traced_tick}
            if traced_tick and attn_per_tick else {}}
    if got != want:
        raise AssertionError(f"{what}: host-side GEMM launches and "
                             f"resolutions {got}, want {want} ({prefills} "
                             f"prefills, {ticks} ticks, {captures} tick "
                             f"and {pcaptures} prefill captures)")
    # executions the telemetry counts: each prefill, each tick (a
    # replay or an eager forward), never a capture or its warm-up
    tel_got = {sp: window[sp].window_calls if sp in window else 0
               for sp in ("gemm", "attention")}
    tel_want = {"gemm": per_fwd * (prefills + ticks),
                "attention": attn_per_tick * ticks}
    if tel_got != tel_want:
        raise AssertionError(f"{what}: telemetry counted {tel_got}, want "
                             f"{tel_want}")
    shapes = {(sp, shape_key(i)): c for sp, d in window.items()
              for i, c in d.window_shapes}
    return {"outs": outs, "wall": wall, "ticks": ticks,
            "reduce_launches": got["reduce_launches"],
            "prefills": prefills, "captures": captures,
            "prefill_captures": pcaptures, "replays": replays,
            "launches": got["launches"],
            "tok_s": sum(len(o) for o in outs) / wall,
            "tick_ms": statistics.median(t[1] for t in eng.tick_times)
            * 1e3, "telemetry": tel_got, "shapes": shapes}


def phase_serve(cfg, params, store_path: Path, fp: str, gemm_rows: list,
                label: str) -> dict:
    """Serve 8 requests from the tuned store with the engine's CUDA graphs
    (each prompt length's prefill and the decode tick), then the same
    requests with its eager prefill and tick.  Launches and resolutions
    are counted as the reference counts them at trace time: the host sees
    a forward's 210 GEMMs and (a tick) 30 split-count lookups when a graph
    is captured and in the capture's eager warm-up, and every eager
    forward's; a replay runs the captured launches on the device and calls
    nothing on the host.  A warm-up run captures the tick and the
    32-token prefill, so the measured graph run launches no GEMM from the
    host, and the kernels it gives the device are read from the graphs
    alone: the tick graph's GEMM and split-K reduction kernel nodes
    (:func:`graph_kernel_names`) times its replays, plus the 32-token
    prefill graph's times its replays.  That must be 210 x (prefills +
    replays) GEMM kernels, and one reduction pass per projection whose
    tuned config splits K (at M=32 for a prefill, M=4 for a tick).  A
    second graph run of the same requests must give the same tokens; tok/s
    and the median tick come from it.

    The engine's install compiles a dispatch plan: every GEMM and
    split-count resolution (captures, warm-ups and eager forwards) must be
    a plan hit, and every served shape's entry its tuned record's config
    on tier ``exact`` (:func:`check_plan_exact`).  The shape telemetry
    counts executions: each run's window must hold 210 GEMM calls per
    prefill and per tick, 30 split-count lookups per tick, so the graph
    run's GEMM count equals the kernels given to the device; the eager
    run's per-shape counts equal the graph run's.  The phase's launch
    counts run from before the warm-up to after the second graph run; the
    eager run's are counted apart, for comparison."""
    sc = ServeConfig(max_len=256, slots=4, tunedb=str(store_path),
                     tunedb_backend=fp, record_tick_times=True)
    eng = Engine(cfg, params, sc)
    plan = serving_state().plan
    if plan is None or plan.source != "compiled":
        raise AssertionError("the serve engine installed no compiled plan")
    phase("serve", f"plan compiled at install: {len(plan)} entries "
          f"{plan.stats()['tiers']} in {plan.compile_ms:.1f} ms (exact "
          f"records under the fingerprint, then the telemetry's hot set "
          f"through the model and nearest tiers)")
    rng = np.random.default_rng(0)
    warm = [rng.integers(0, cfg.vocab, 32) for _ in range(2)]
    prompts = [rng.integers(0, cfg.vocab, 32) for _ in range(8)]
    per_fwd = GEMMS_PER_LAYER * cfg.n_layers        # 210 GEMMs a forward
    # reduction passes a forward launches: projections whose tuned config
    # splits K, at the prefill's M=32 and the tick's M=4
    red_fwd = {M: cfg.n_layers * sum(SLICE_NK[(r["N"], r["K"])]
                                     for r in gemm_rows
                                     if r["M"] == M and r["k_split"] > 1)
               for M in SLICE_M}

    run = functools.partial(serve_run, eng, per_fwd=per_fwd,
                            red_pre=red_fwd[32], red_tick=red_fwd[4],
                            attn_per_tick=cfg.n_layers)
    reset_launches()
    # warm-up: the engine captures its decode tick and the 32-token
    # prefill here, once each
    w = run("warm-up", warm, 2)
    if (w["captures"], w["prefill_captures"]) != (1, 1):
        raise AssertionError(f"warm-up: {w['captures']} tick and "
                             f"{w['prefill_captures']} prefill captures, "
                             "want 1 and 1")
    g = run("graph", prompts, 16)
    if g["captures"] or g["prefill_captures"] or g["launches"]:
        raise AssertionError(f"graph run: {g['captures']} tick and "
                             f"{g['prefill_captures']} prefill captures, "
                             f"{g['launches']} GEMM launches from the host "
                             "with the store unchanged")
    # the kernels the device was given: each replay runs its graph's nodes
    tick_gemm, tick_reduce, tick_nodes = graph_counts(eng.graph)
    pre_graphs = eng.prefill_graphs
    if sorted(pre_graphs) != [32]:
        raise AssertionError(f"prefill graphs of lengths {sorted(pre_graphs)}")
    pre_gemm, pre_reduce, pre_nodes = graph_counts(pre_graphs[32])
    if ((tick_gemm, tick_reduce) != (per_fwd, red_fwd[4])
            or (pre_gemm, pre_reduce) != (per_fwd, red_fwd[32])):
        raise AssertionError(f"captured tick: {tick_gemm} GEMM and "
                             f"{tick_reduce} split-K reduction kernel nodes "
                             f"of {tick_nodes}; 32-token prefill: "
                             f"{pre_gemm} and {pre_reduce} of {pre_nodes}; "
                             f"want {per_fwd} and {red_fwd[4]}, "
                             f"{per_fwd} and {red_fwd[32]}")
    g["device_launches"] = (tick_gemm * g["replays"]
                            + pre_gemm * g["prefills"])
    g["device_reduce_launches"] = (tick_reduce * g["replays"]
                                   + pre_reduce * g["prefills"])
    want_device = per_fwd * (g["prefills"] + g["replays"])
    want_reduce = red_fwd[32] * g["prefills"] + red_fwd[4] * g["replays"]
    if g["device_reduce_launches"] != want_reduce:
        raise AssertionError(f"graph run: {g['device_reduce_launches']} "
                             f"split-K reduction passes given to the "
                             f"device, want {want_reduce} ({red_fwd[32]} a "
                             f"prefill x {g['prefills']} + {red_fwd[4]} a "
                             f"tick x {g['replays']} replays)")
    if g["device_launches"] != want_device:
        raise AssertionError(f"graph run: {g['device_launches']} GEMM kernels "
                             f"given to the device, want {want_device} "
                             f"({per_fwd} x ({g['prefills']} prefills + "
                             f"{g['replays']} replays))")
    timed = run("graph (again)", prompts, 16)
    if timed["outs"] != g["outs"] or timed["captures"] or timed["launches"]:
        raise AssertionError("the second graph run differs from the first")
    # the main path's wrapper launches: the warm-up's captures and their
    # warm-ups (the graph runs replay and launch none from the host)
    counts = read_launches()
    if not (counts["gemm"] and counts["gemm_reduce"]):
        raise AssertionError(f"serve path launches {counts}")
    reset_launches()
    eng.prefill, eng.decode = eng.prefill_eager, eng.decode_eager
    try:
        e = run("eager", prompts, 16)
    finally:
        eng.prefill, eng.decode = eng.prefill_graph, eng.decode_graph
    eager_counts = read_launches()
    if e["outs"] != g["outs"]:
        raise AssertionError("greedy tokens from the graphs differ from the "
                             "eager prefill and tick's")
    if g["telemetry"]["gemm"] != g["device_launches"]:
        raise AssertionError(f"graph run: telemetry counted "
                             f"{g['telemetry']['gemm']} GEMM calls, the "
                             f"device was given {g['device_launches']}")
    if e["shapes"] != g["shapes"]:
        raise AssertionError("per-shape telemetry of the eager run differs "
                             "from the graph run's")
    # every shape served (the prefills' M=32 GEMMs, the tick's M=4 GEMMs
    # and its split-count lookup) hit its tuned record's config
    check_plan_exact(plan, eng.tunedb_store, fp, g["shapes"], "serve")
    splits = resolve_decode_splits(
        B=sc.slots, Hq=cfg.n_heads, Hkv=cfg.n_kv, Lkv=sc.max_len,
        D=cfg.head_dim, dtype_bits=16, default=cfg.decode_kv_splits)
    # the tick's GEMM time under tuned configs, where the rows were timed
    timed_rows = all("kernel_ms" in r for r in gemm_rows)
    if timed_rows:
        tuned, alone, red, heur = (per_tick(gemm_rows, k, cfg.n_layers)
                                   for k in ("kernel_ms", "gemm_ms",
                                             "reduce_ms", "heuristic_ms"))
        tick_gemm_ms = (f"; GEMM per decode tick {tuned:.3f} ms under tuned "
                        f"configs (kernel alone {alone:.3f} ms, reduction "
                        f"passes alone {red:.3f} ms), {heur:.3f} ms under "
                        f"the heuristic's")
    else:
        tick_gemm_ms = ""
    phase("serve", f"{cfg.name} ({cfg.n_layers}L d={cfg.d_model} bf16): "
          f"{len(prompts)} requests x 16 tokens; warm-up run: the tick and "
          f"the 32-token prefill captured ({w['launches']} GEMM launches "
          f"from the host: captures and their warm-ups, all plan hits); "
          f"graph run: {g['prefills']} prefills + {g['ticks']} ticks, all "
          f"replays, {g['launches']} GEMM launches from the host; telemetry "
          f"counted {g['telemetry']['gemm']} GEMM calls and "
          f"{g['telemetry']['attention']} split-count lookups "
          f"({len(g['shapes'])} shapes; the eager run's per-shape counts "
          f"equal); the captured tick holds {tick_gemm} GEMM and "
          f"{tick_reduce} reduction kernel nodes of {tick_nodes}, the "
          f"32-token prefill graph {pre_gemm} and {pre_reduce} of "
          f"{pre_nodes}, so {g['device_launches']} GEMM kernels given "
          f"to the device (210 x (prefills + replays)) and "
          f"{g['device_reduce_launches']} split-K reduction passes "
          f"({red_fwd[32]} a prefill, {red_fwd[4]} a tick); decode KV "
          f"splits {splits} from the tuned attention record (default "
          f"{cfg.decode_kv_splits}); graph (second run) "
          f"{timed['tok_s']:.1f} tok/s, median tick {timed['tick_ms']:.2f} "
          f"ms, {timed['wall'] * 1e3:.1f} ms in all; eager "
          f"{e['tok_s']:.1f} tok/s, median tick {e['tick_ms']:.2f} ms, "
          f"{e['wall'] * 1e3:.1f} ms in all ({e['launches']} GEMM "
          f"launches, all plan hits); the 8 requests' greedy tokens "
          f"equal; launches from the warm-up through the graph runs "
          f"{counts}, in the eager run {eager_counts}{tick_gemm_ms} "
          f"[{label}]")
    return {"launches": counts["gemm"],
            "device_launches": g["device_launches"],
            "reduce_launches": counts["gemm_reduce"],
            "device_reduce_launches": g["device_reduce_launches"],
            "tokens_per_s": timed["tok_s"], "tick_ms": timed["tick_ms"],
            "eager_tokens_per_s": e["tok_s"], "eager_tick_ms": e["tick_ms"],
            "splits": splits, "engine": eng, "counts": counts,
            "prompts": prompts, "outs": g["outs"],
            "telemetry": g["telemetry"], "shapes": g["shapes"]}


def phase_plans(cfg, params, store_path: Path, serve: dict, label: str
                ) -> dict:
    """Export the serve phase's generation as a plan artifact under
    ``<store>.plan/<generation>/``, load it back (timed against the
    install's compile), then serve the serve phase's requests from a fresh
    engine holding only the artifact (no store, no models): the same
    greedy tokens as the store-served graph run, every GEMM and
    split-count resolution a plan hit.  A rejected artifact fails here:
    the engine's warning is an error in this phase."""
    state = serving_state()
    plan, eng = state.plan, serve["engine"]
    dest = export_plan(plan, default_plan_dir(store_path),
                       store=eng.tunedb_store, generation=state.generation)
    t0 = time.perf_counter()
    loaded = load_plan(dest)
    load_ms = (time.perf_counter() - t0) * 1e3
    manifest = read_manifest(dest)
    if len(loaded) != len(plan) or loaded.digest != manifest.digest:
        raise AssertionError(f"plans: {len(loaded)} entries loaded of "
                             f"{len(plan)}")
    prompts = serve["prompts"]
    reset_launches()
    dispatch.reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        cold = Engine(cfg, params, ServeConfig(max_len=256, slots=4,
                                               plan_dir=str(dest)))
    st = serving_state()
    if not (st.store is None and st.models is None
            and st.plan.source == "loaded"
            and st.plan.digest == manifest.digest):
        raise AssertionError(f"plans: the cold engine installed {st}")
    # the artifact plans every shape the serve phase served as its tuned
    # record's config
    check_plan_exact(st.plan, eng.tunedb_store, eng.sc.tunedb_backend,
                     serve["shapes"], "plans")
    outs = cold.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    counts = read_launches()
    tiers = dict(dispatch.tier_counts)
    per_fwd = GEMMS_PER_LAYER * cfg.n_layers
    want = {("gemm", "plan"): per_fwd * 2 * (cold.prefill_captures
                                             + cold.captures),
            ("attention", "plan"): cfg.n_layers * 2 * cold.captures}
    if outs != serve["outs"] or tiers != want or not counts["gemm"]:
        raise AssertionError(f"plans: plan-only tokens equal "
                             f"{outs == serve['outs']}, resolutions {tiers} "
                             f"(want {want}), launches {counts}")
    phase("plans", f"exported generation {state.generation} ({len(plan)} "
          f"entries {plan.stats()['tiers']}, {plan.stats()['promoted']} "
          f"promoted) to <store>.plan/{dest.name}/, digest "
          f"{manifest.digest[:19]}...; load {load_ms:.2f} ms against the "
          f"install's compile {plan.compile_ms:.2f} ms; plan-only cold "
          f"start (no store, no models; the artifact is keyed to "
          f"{manifest.fingerprint}): {len(prompts)} requests give the "
          f"store-served "
          f"graph run's greedy tokens; resolutions {tiers}; launches "
          f"{counts} [{label}]")
    return {"counts": counts, "load_ms": load_ms,
            "compile_ms": plan.compile_ms, "entries": len(plan)}


RESOLVE_CALLS = 10_000
RESOLVE_REPS = 5


def time_resolutions(shapes: list) -> float:
    """µs per ``dispatch._resolve_cfg`` call over :data:`RESOLVE_CALLS`
    calls cycling through ``shapes``."""
    t0 = time.perf_counter()
    for i in range(RESOLVE_CALLS):
        space, x = shapes[i % len(shapes)]
        dispatch._resolve_cfg(space, x)
    return (time.perf_counter() - t0) / RESOLVE_CALLS * 1e6


def phase_host_cost(cfg, params, serve: dict, fp: str, dev: torch.device,
                    label: str) -> dict:
    """What the plan and the prefill graph save on the host: µs per
    ``_resolve_cfg`` call over a decode tick's 210 GEMM and 30 split-count
    shapes (the captured tick's, in its order), as plan hits and on the
    slow path (the same store and models installed with
    ``build_plan=False``: tier exact), median of :data:`RESOLVE_REPS`
    rounds; and the prefill of a 32-token prompt, ms, three ways: the
    engine's graph replay with the merge into the slot, and the eager
    prefill with and without the plan, median of 10 each.  The states
    alternate round by round (graph and eager with the plan alternate
    call by call); the plan is the installed one, re-installed as it is
    (no compile between timings), and each install is followed by one
    untimed prefill (and, with the plan, the graph's capture, timed
    once)."""
    eng = serve["engine"]
    shapes = eng._decode_shapes
    n_gemm = sum(1 for sp, _ in shapes if sp == "gemm")
    if (n_gemm, len(shapes) - n_gemm) != (GEMMS_PER_LAYER * cfg.n_layers,
                                          cfg.n_layers):
        raise AssertionError(f"host cost: the captured tick holds "
                             f"{n_gemm} GEMM of {len(shapes)} shapes")
    store, models = eng.tunedb_store, eng.tunedb_models
    plan = serving_state().plan
    tokens = torch.as_tensor(serve["prompts"][0][None], device=dev)
    single = init_cache(cfg, 1, 256, dev)

    def install(planned: bool) -> None:
        install_serving(store=store, models=models, fingerprint=fp,
                        plan=plan if planned else None, build_plan=False)

    def prefill_ms(graph: bool = False) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if graph:
            eng.prefill_graph(0, tokens)
        else:
            prefill(params, cfg, {"tokens": tokens}, single)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    res, pre = {True: [], False: []}, {True: [], False: []}
    replay, capture = [], []
    for _ in range(RESOLVE_REPS):
        for planned in (True, False):
            install(planned)
            dispatch.reset_counts()
            res[planned].append(time_resolutions(shapes))
            tier = "plan" if planned else "exact"
            if set(t for _, t in dispatch.tier_counts) != {tier}:
                raise AssertionError(f"host cost: tiers "
                                     f"{dict(dispatch.tier_counts)}, want "
                                     f"all {tier}")
    for _ in range(5):
        for planned in (True, False):
            install(planned)
            prefill_ms()                    # untimed, after the install
            if planned:
                # the install's new generation dropped the prefill graphs:
                # this call captures the 32-token one again (with its
                # warm-up and first replay)
                capture.append(prefill_ms(graph=True))
                for _ in range(2):
                    replay.append(prefill_ms(graph=True))
                    pre[planned].append(prefill_ms())
            else:
                pre[planned] += [prefill_ms() for _ in range(2)]
    install(True)
    res = {k: statistics.median(v) for k, v in res.items()}
    pre_ms = {k: statistics.median(v) for k, v in pre.items()}
    replay_ms = statistics.median(replay)
    phase("host cost", f"_resolve_cfg over a tick's {n_gemm} GEMM and "
          f"{len(shapes) - n_gemm} split-count shapes, median of "
          f"{RESOLVE_REPS} x {RESOLVE_CALLS} calls: plan hit "
          f"{res[True]:.3f} us, slow path (exact tier, no plan) "
          f"{res[False]:.3f} us a call; prefill of a 32-token prompt: "
          f"graph replay with the merge into the slot {replay_ms:.3f} ms, "
          f"eager {pre_ms[True]:.2f} ms with the plan, {pre_ms[False]:.2f} "
          f"ms without (median of 10 each, alternated; all: "
          f"{[round(v, 3) for v in replay]} / "
          f"{[round(v, 2) for v in pre[True]]} / "
          f"{[round(v, 2) for v in pre[False]]}); the graph's capture (its "
          f"eager warm-up, the capture and the first replay) "
          f"{capture[0]:.2f} ms [{label}]")
    return {"resolve_us": res, "prefill_ms": pre_ms,
            "replay_ms": replay_ms, "capture_ms": capture[0]}


PARITY_LENGTHS = (200, 100, 32, 9)  # falling: each replay follows a longer


def phase_prefill_parity(eng, cfg, dev: torch.device, label: str,
                         lengths: tuple = PARITY_LENGTHS,
                         name: str = "prefill parity") -> dict:
    """The serve engine's graph prefill against its eager prefill at
    ``lengths``, into the same slot: the logits bitwise equal, the same
    greedy token, the slot's cache rows equal, the rows past the prompt
    zero.  Lengths fall, so each replay follows a longer one that left the
    static cache and the slot dirty past ``n``."""
    rng = np.random.default_rng(9)
    kv = eng.cache["pos0"]["attn"]
    rows = []
    for n in lengths:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, n)[None],
                                 device=dev)
        graph = eng.prefill_graph(0, tokens)[:, : cfg.vocab].clone()
        slot = [kv[k][:, 0].clone() for k in ("k", "v")]
        eager = eng.prefill_eager(0, tokens)[:, : cfg.vocab]
        torch.cuda.synchronize()
        diff = float((graph - eager).abs().max())
        tok = (int(graph.argmax()), int(eager.argmax()))
        same_rows = all(torch.equal(got, kv[k][:, 0])
                        for k, got in zip(("k", "v"), slot))
        tail_zero = all(not got[:, n:].any() for got in slot)
        if not (torch.equal(graph, eager) and tok[0] == tok[1] and same_rows
                and tail_zero and torch.isfinite(graph).all()):
            raise AssertionError(f"{name} at n={n}: logits max abs "
                                 f"diff {diff:.3e}, tokens {tok}, slot rows "
                                 f"equal {same_rows}, rows past n zero "
                                 f"{tail_zero}")
        rows.append((n, tok[0]))
    phase(name, f"graph prefill vs eager prefill into slot 0 at "
          f"lengths {list(lengths)} (falling): logits bitwise equal "
          f"(max abs diff 0), greedy tokens {[t for _, t in rows]} equal, "
          f"the slot's K/V rows equal and zero past n [{label}]")
    return {"lengths": list(lengths)}


def phase_measure(cfg, params, store_path: Path, fp: str, dev: torch.device,
                  label: str) -> dict:
    """The model tier's deferred re-measurement, served.  With the
    telemetry cleared, the engine's plan holds the store's exact records
    only, so every untuned shape of the models phase's 8 prompts meets the
    model tier at serving: ``measure="wallclock"`` and a top-6 re-measure
    (``MODEL_TOP_K``) serve the argmax and queue the top-6, which the
    engine drains after its ticks (timed) and here after the serve until
    the queue is empty.  Every drained shape must then resolve on tier
    ``plan`` to its measured winner: the best of its candidates as the
    measurer timed them (a gate rejection drops out).  At the drained
    shapes, a forward's GEMMs are timed under the measured winners, the
    model's blind argmax and the nearest record's config.  Then a
    reinstall of the same plan (a new generation: every graph captured
    again, now under the winners) and a second serve of the same prompts:
    each prompt's graph prefill logits agree with the plain version's."""
    clear_telemetry()
    reset_launches()
    eng = Engine(cfg, params, ServeConfig(
        max_len=256, slots=4, tunedb=str(store_path), tunedb_backend=fp,
        measure="wallclock", record_tick_times=True))
    models, q, real = eng.tunedb_models, eng.measure_queue, eng.measurer
    if (models is None or models.measure_queue is not q
            or models.measurer is not real or eng.calibration_tflops is None
            or real.counts["wallclock"] != 1):
        raise AssertionError(f"measure: engine models {models}, calibration "
                             f"{eng.calibration_tflops}, {real.stats()}")
    calibration = eng.calibration_tflops
    models.remeasure_top_k = MODEL_TOP_K
    measured: dict = {}

    def recording(space, cfg_, inputs):
        tflops = real(space, cfg_, inputs)
        measured.setdefault(shape_key(inputs), []).append((dict(cfg_),
                                                           tflops))
        return tflops

    eng.measurer = recording
    drains, drained_ticks = [], set()
    drain = eng.maybe_retune

    def timed_drain():
        before = q.processed
        t0 = time.perf_counter()
        drain()
        if q.processed > before:
            drains.append((time.perf_counter() - t0) * 1e3)
            drained_ticks.add(eng.ticks)

    eng.maybe_retune = timed_drain
    prompts = model_prompts(cfg)
    ticks0 = eng.ticks
    first = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    walls = {True: [], False: []}
    for i, t in enumerate(eng.tick_times):
        walls[ticks0 + i + 1 in drained_ticks].append(t[1] * 1e3)
    in_serve = len(drains)
    while len(q):
        eng.maybe_retune()
    st = q.stats()
    untuned = [n for n in MODEL_PROMPTS if n not in SLICE_M]
    want = len(untuned) * len(SLICE_NK)
    if (st["pushed"], st["processed"], st["dropped"], len(measured)) != (
            want, want, 0, want):
        raise AssertionError(f"measure: queue {st}, {len(measured)} shapes "
                             f"measured, want {want} pushed and processed")
    n_measured = sum(len(v) for v in measured.values())
    if real.counts["wallclock"] != 1 + n_measured:
        raise AssertionError(f"measure: {real.counts} measurements, "
                             f"{n_measured} recorded")
    winners = {key: max(got, key=lambda t: t[1])[0]
               for key, got in measured.items()}

    def check_winners(when: str) -> None:
        for key, cfg_ in winners.items():
            got = dispatch._resolve_cfg("gemm", dict(key))
            if got != (cfg_, "plan"):
                raise AssertionError(f"measure ({when}): {dict(key)} "
                                     f"resolves to {got}, want the measured "
                                     f"winner {cfg_} on tier plan")

    check_winners("after the drain")
    # a forward's GEMMs at each drained length: measured winners, the
    # model's blind argmax and the nearest record's config
    pm = models.resolve_model("gemm", fp)
    legal = functools.partial(launchable, "gemm")
    store = eng.tunedb_store
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    sums = {}
    for M in untuned:
        tot = {"measured": 0.0, "argmax": 0.0, "nearest": 0.0}
        for (N, K), count in SLICE_NK.items():
            x = gemm_input(M, N, K, 16)
            picks = {"measured": winners[shape_key(x)],
                     "argmax": pm.predict_config(x).best}
            # a record within the store's radius, where there is one
            near = store.nearest("gemm", x, backend=fp, legal=legal)
            if near is not None:
                picks["nearest"] = near.config
            else:
                tot["nearest"] = None
            a, bs = gemm_weights(M, N, K, gen, dev)
            for k, c in picks.items():
                if tot[k] is not None:
                    tot[k] += count * cfg.n_layers * time_ms(
                        lambda i, c=c: ops.matmul(a, bs[i], c), len(bs))
            del a, bs
        sums[M] = tot
    for M, tot in sums.items():
        near = ("no record within the store's radius"
                if tot["nearest"] is None else
                f"{tot['nearest']:.3f} ms "
                f"({tot['nearest'] / tot['measured']:.2f}x)")
        phase("measure", f"M={M}, one forward's "
              f"{GEMMS_PER_LAYER * cfg.n_layers} GEMMs: measured winners "
              f"{tot['measured']:.3f} ms, blind argmax {tot['argmax']:.3f} "
              f"ms ({tot['argmax'] / tot['measured']:.2f}x), nearest record "
              f"{near} [{label}]")
    # a reinstall of the same plan: a new generation, every graph
    # captured again under the winners; a second serve of the same prompts
    state = serving_state()
    install_serving(store=state.store, models=state.models, fingerprint=fp,
                    plan=state.plan)
    check_winners("after the reinstall")
    pushed = q.pushed
    again = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    if q.pushed != pushed or eng.prefill_captures != 2 * len(MODEL_PROMPTS):
        raise AssertionError(f"measure: second serve pushed "
                             f"{q.pushed - pushed}, {eng.prefill_captures} "
                             "prefill captures")
    same = sum(a == b for o1, o2 in zip(first, again)
               for a, b in zip(o1, o2))
    worst = 0.0
    for prompt in prompts:
        tokens = torch.as_tensor(prompt[None], device=dev)
        got = eng.prefill_graph(0, tokens)[:, : cfg.vocab].clone()
        with plain_kernels():
            plain = prefill(params, cfg, {"tokens": tokens},
                            init_cache(cfg, 1, 256, dev))[0][:, : cfg.vocab]
        torch.cuda.synchronize()
        _, err = rel_err(got, plain)
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL):
            raise AssertionError(f"measure: {len(prompt)}-token graph "
                                 f"prefill logits vs plain rel err {err:.3e}")
        worst = max(worst, err)
    counts = read_launches()
    if not (counts["gemm"] and counts["gemm_reduce"]):
        raise AssertionError(f"measure path launches {counts}")
    rejected = MODEL_TOP_K * want - n_measured
    med = lambda v: f"{statistics.median(v):.2f} ms" if v else "none"
    phase("measure", f"{len(prompts)} requests of prompt lengths "
          f"{list(MODEL_PROMPTS)} x 16 tokens with measure=wallclock, "
          f"top-{MODEL_TOP_K}: calibration GEMM {calibration:.3f} TFLOP/s "
          f"(1 measurement); queue {st}; {n_measured} candidates measured "
          f"through the gate ({rejected} rejected); {in_serve} drains in the "
          f"serve's idle gaps, {len(drains) - in_serve} after it: "
          f"{med(drains)} median, {max(drains):.2f} ms max a drain (up to 2 "
          f"shapes); tick wall with a drain median {med(walls[True])} "
          f"({len(walls[True])} ticks), without {med(walls[False])} "
          f"({len(walls[False])} ticks); every drained shape resolves on "
          f"tier plan to its measured winner, before and after the "
          f"reinstall; second serve (the {len(MODEL_PROMPTS)} prefill graphs "
          f"and the tick captured again under the winners): {same} of "
          f"{sum(len(o) for o in first)} greedy tokens equal the first "
          f"serve's, each prompt's graph prefill logits vs plain rel err "
          f"<= {worst:.3e} (tolerance {LOGIT_TOL}); launches {counts} "
          f"[{label}]")
    return {"counts": counts, "stats": st, "sums": sums,
            "drain_ms": drains, "walls": walls}


DEGRADE_NEW = 8


def phase_degradation(cfg, params, store_path: Path, fp: str, label: str
                      ) -> dict:
    """Request deadlines and load shedding at full width, from the tuned
    store (2 slots, as the reference's scenarios): a backlog cap of 3 on 6
    requests sheds the 3 newest and serves the 3 oldest whole, healthy at
    the end; an expired deadline (0 s) rejects every request unserved; a
    deadline of an hour gives the tokens of no deadline."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, 32) for _ in range(6)]
    reset_launches()

    def serve(batch, **kw):
        eng = Engine(cfg, params, ServeConfig(
            max_len=256, slots=2, tunedb=str(store_path), tunedb_backend=fp,
            **kw))
        return eng, eng.generate(batch, max_new=DEGRADE_NEW)

    eng, outs = serve(prompts, shed_threshold=3)
    if not (eng.shed_requests == 3 and eng.deadline_retired == 0
            and [len(o) for o in outs] == [DEGRADE_NEW] * 3 + [0] * 3
            and not eng.shedding and eng._health() is True):
        raise AssertionError(f"degradation: shed {eng.shed_requests}, "
                             f"lengths {[len(o) for o in outs]}, health "
                             f"{eng._health()}")
    late, outs0 = serve(prompts[:3], request_deadline_s=0.0)
    if late.deadline_retired != 3 or any(outs0) or late.prefills:
        raise AssertionError(f"degradation: deadline 0 retired "
                             f"{late.deadline_retired}, outputs {outs0}")
    _, hour = serve(prompts[:3], request_deadline_s=3600.0)
    _, none = serve(prompts[:3])
    if hour != none:
        raise AssertionError("degradation: a deadline of an hour changed "
                             "the tokens")
    counts = read_launches()
    if not counts["gemm"]:
        raise AssertionError(f"degradation path launches {counts}")
    phase("degradation", f"shed_threshold=3, 6 requests x {DEGRADE_NEW} "
          f"tokens: 3 shed (the newest), the 3 oldest served whole, "
          f"_health() {eng._health()} at the end; request_deadline_s=0: "
          f"3 of 3 rejected unserved (0 prefills); request_deadline_s=3600: "
          f"the tokens of no deadline; launches {counts} [{label}]")
    return {"counts": counts}


ADMISSION_NEW = 8


def phase_admission(cfg, params, store_path: Path, fp: str, label: str
                    ) -> dict:
    """The models phase's 8 prompt lengths mixed with tuned 32-token
    prompts, served with FIFO admission and with store-aware admission
    (``admission="store"``, the H100's peaks): every request's greedy
    tokens must be the same under both; the admission orders and the
    bucket decisions at each length's projections are printed."""
    rng = np.random.default_rng(7)
    mixed = []
    for i, prompt in enumerate(model_prompts(cfg)):
        mixed.append(prompt)
        if i % 2:
            mixed.append(rng.integers(0, cfg.vocab, 32))
    runs = {}
    for policy in ("fifo", "store"):
        eng = Engine(cfg, params, ServeConfig(
            max_len=256, slots=4, tunedb=str(store_path), tunedb_backend=fp,
            admission=policy))
        reset_launches()
        outs = eng.generate(mixed, max_new=ADMISSION_NEW)
        torch.cuda.synchronize()
        runs[policy] = (outs, list(eng.admitted), read_launches(), eng)
    if runs["store"][0] != runs["fifo"][0]:
        raise AssertionError("admission: store-aware admission changed a "
                             "request's tokens")
    if not runs["store"][2]["gemm"]:
        raise AssertionError(f"admission launches {runs['store'][2]}")
    adm = runs["store"][3].admission
    decisions = {}
    for n in sorted(set(len(p) for p in mixed)):
        got = [adm.bucket("gemm", gemm_input(n, N, K, 16))
               for (N, K) in SLICE_NK]
        decisions[n] = sorted({d if d != "padded" else f"padded to M={x['M']}"
                               for x, d in got})
    phase("admission", f"{len(mixed)} requests ({len(MODEL_PROMPTS)} "
          f"lengths nobody tuned but the model serves, and "
          f"{len(mixed) - len(MODEL_PROMPTS)} more of the tuned 32) x "
          f"{ADMISSION_NEW} tokens: FIFO admitted lengths "
          f"{runs['fifo'][1]}, store-aware {runs['store'][1]}; every "
          f"request's greedy tokens equal; bucket decisions per length "
          f"{decisions} (hit {adm.hits}, padded {adm.padded}, exact "
          f"{adm.exact}); launches {runs['store'][2]} [{label}]")
    return {"counts": runs["store"][2], "order": runs["store"][1]}


# the trace phase: E18.1 / E18.2's sampling rate, gate and triplets
# (benchmarks/bench_trace.py's), the status routes scraped and how often
# each is timed, and the tunedb_* series the ported parts publish
TRACE_SAMPLE = 0.01
TRACE_OVERHEAD = 0.02              # median tick within 2% + 2x A/A noise
TRACE_TRIPLETS = 11
TRACE_ROUTES = ("/healthz", "/metrics", "/status", "/plan", "/trace")
TRACE_SCRAPES = 5
TRACE_SPANS = ("engine.admit", "engine.prefill", "engine.tick",
               "dispatch.resolve")
TRACE_METRICS = ("tunedb_serving_generation", "tunedb_store_lookups_total",
                 "tunedb_store_records", "tunedb_plan_lookups_total",
                 "tunedb_plan_entries", "tunedb_telemetry_calls_total",
                 "tunedb_telemetry_ticks_total", "tunedb_installs_total",
                 "tunedb_plan_built_entries")
TRACER_METHODS = ("root", "span", "begin", "end")


def scrape(url: str, timeout: float = 60.0) -> tuple:
    """(HTTP status, body, ms) of one GET; an HTTP error's code and its
    reason as the body."""
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body = r.read().decode()
            code = r.status
    except urllib.error.HTTPError as e:
        code, body = e.code, str(e.reason)
    return code, body, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def count_tracer_calls():
    """Count every call of a ``Tracer`` method inside the block (E18.1):
    the list's length is the count."""
    calls: list = []
    saved = {m: getattr(Tracer, m) for m in TRACER_METHODS}

    def counting(real):
        def wrapped(self, *a, **k):
            calls.append(1)
            return real(self, *a, **k)
        return wrapped

    for m, real in saved.items():
        setattr(Tracer, m, counting(real))
    try:
        yield calls
    finally:
        for m, real in saved.items():
            setattr(Tracer, m, real)


def time_tuned_cfg(shapes: list) -> float:
    """µs per ``dispatch._tuned_cfg`` call (the resolution with its tracing
    probe) over :data:`RESOLVE_CALLS` calls cycling through ``shapes``."""
    t0 = time.perf_counter()
    for i in range(RESOLVE_CALLS):
        space, x = shapes[i % len(shapes)]
        dispatch._tuned_cfg(space, x)
    return (time.perf_counter() - t0) / RESOLVE_CALLS * 1e6


def tick_split(spans: list) -> list:
    """Each ``engine.tick`` root split by the spans of its trace that lie
    inside it: ms in ``retune.epoch``, ``measure.*`` and
    ``dispatch.resolve`` spans (each counted once: a span nested in another
    counted span is not), and the remainder, with the root's ``tick``
    attribute and start, in tick order.  An async epoch's detached
    ``retune.epoch`` shares its submitting tick's trace but outlasts it,
    so it is not part of the tick's split."""
    by_trace = collections.defaultdict(list)
    for sp in spans:
        by_trace[sp.trace_id].append(sp)
    counted = ("retune.epoch", "measure.", "dispatch.resolve")

    def kind(sp):
        return next((k for k in counted if sp.name.startswith(k)), None)

    out = []
    for sp in spans:
        if sp.name != "engine.tick" or sp.parent_id:
            continue
        trace = by_trace[sp.trace_id]
        ids = {s.span_id: s for s in trace}
        parts = {"epoch": 0.0, "measure": 0.0, "resolve": 0.0}
        n_resolve = 0
        end = sp.t0 + sp.dur
        for s in trace:
            k = kind(s)
            if k is None or s.t0 < sp.t0 or s.t0 + s.dur > end:
                continue
            up, nested = ids.get(s.parent_id), False
            while up is not None:
                if kind(up) is not None:
                    nested = True
                    break
                up = ids.get(up.parent_id)
            if nested:
                continue
            key = {"retune.epoch": "epoch", "measure.": "measure",
                   "dispatch.resolve": "resolve"}[k]
            parts[key] += s.dur * 1e3
            n_resolve += key == "resolve"
        wall = sp.dur * 1e3
        out.append({"tick": sp.attrs["tick"], "t0": sp.t0, "wall": wall,
                    **parts,
                    "rest": wall - sum(parts.values()),
                    "resolves": n_resolve})
    return sorted(out, key=lambda r: r["tick"])


def split_medians(rows: list) -> str:
    if not rows:
        return "no ticks"
    med = {k: statistics.median(r[k] for r in rows)
           for k in ("wall", "epoch", "measure", "resolve", "rest")}
    return (f"wall {med['wall']:.3f} ms = retune.epoch {med['epoch']:.3f} + "
            f"measure.* {med['measure']:.3f} + dispatch.resolve "
            f"{med['resolve']:.3f} + the rest {med['rest']:.3f} "
            f"(medians over {len(rows)} ticks)")


def phase_trace(cfg, params, store_path: Path, fp: str, serve: dict,
                label: str) -> dict:
    """Tracing and the status endpoint at full width: SmolLM-135M from the
    tuned store, ``ServeConfig(slots=4, max_len=256, trace_sample=1.0,
    status_port=0)``, the serve phase's 8 x 32-token prompts x 16 tokens,
    every prefill and tick from its graph (the engine's first tick and
    first prefill capture them).  The tokens must be the serve phase's.
    From this process: every route scraped (``/healthz``, ``/metrics``,
    ``/status``, ``/plan``, ``/trace``; :data:`TRACE_SCRAPES` times each,
    the median ms printed); the Chrome trace parses with schema 1 and
    holds :data:`TRACE_SPANS`, every ``dispatch.resolve`` with a tier, one
    ``engine.tick`` root per tick, and resolutions only in the ticks that
    captured (a replay resolves nothing on the host); ``/metrics`` carries
    :data:`TRACE_METRICS`.  Then, with tracing off: E18.1 (a generate
    calls no ``Tracer`` method) and a plan hit's µs through
    ``dispatch._tuned_cfg`` over the captured tick's shapes; and E18.2:
    :data:`TRACE_TRIPLETS` quiet / traced at :data:`TRACE_SAMPLE` / quiet
    generates, the median of the traced median tick over the quiet pair's
    mean, against :data:`TRACE_OVERHEAD` plus twice the quiet pairs' A/A
    noise (printed, not held: a timing on a shared host)."""
    t_phase = time.perf_counter()
    reset_tracing()
    reset_launches()
    eng = Engine(cfg, params, ServeConfig(
        max_len=256, slots=4, tunedb=str(store_path), tunedb_backend=fp,
        record_tick_times=True, trace_sample=1.0, status_port=0))
    try:
        out = trace_checks(eng, cfg, serve, label)
        counts = read_launches()
        if not counts["gemm"]:
            raise AssertionError(f"trace path launches {counts}")
        out.update(trace_overhead(eng, serve, label))
    finally:
        eng.status_server.stop()
        reset_tracing()
    out["counts"] = counts
    out["wall_s"] = time.perf_counter() - t_phase
    phase("trace", f"launches on the trace path {counts}; the phase's wall "
          f"{out['wall_s']:.1f} s")
    return out


def trace_checks(eng, cfg, serve: dict, label: str) -> dict:
    """The traced serve, the scrapes and the trace's checks (see
    :func:`phase_trace`)."""
    prompts = serve["prompts"]
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if outs != serve["outs"]:
        raise AssertionError("trace: the traced serve's tokens differ from "
                             "the serve phase's")
    if (eng.captures, eng.prefill_captures) != (1, 1) or (
            eng.replays, eng.prefill_replays) != (eng.ticks, eng.prefills):
        raise AssertionError(f"trace: {eng.captures} tick and "
                             f"{eng.prefill_captures} prefill captures, "
                             f"{eng.replays} / {eng.prefill_replays} "
                             f"replays for {eng.ticks} ticks and "
                             f"{eng.prefills} prefills")
    url = eng.status_server.url
    bodies, ms = {}, {}
    for route in TRACE_ROUTES:
        got = [scrape(url + route) for _ in range(TRACE_SCRAPES)]
        bad = [(c, b[:200]) for c, b, _ in got if c != 200]
        if bad:
            raise AssertionError(f"trace: {route} answered {bad}")
        bodies[route] = got[-1][1]
        ms[route] = statistics.median(t for _, _, t in got)
    if bodies["/healthz"] != "ok\n":
        raise AssertionError(f"trace: /healthz said {bodies['/healthz']!r}")
    missing = [m for m in TRACE_METRICS
               if f"\n{m}" not in "\n" + bodies["/metrics"]]
    if missing:
        raise AssertionError(f"trace: /metrics lacks {missing}")
    status = json.loads(bodies["/status"])
    want_roots = eng.ticks + len(eng.admitted) + 1      # + dispatch.probe
    if (status["schema"] != 1 or status["trace"] is None
            or status["trace"]["sampled"] != want_roots
            or status["serving"]["generation"]
            != serving_state().generation):
        raise AssertionError(f"trace: /status schema {status['schema']}, "
                             f"trace {status['trace']}, want {want_roots} "
                             "sampled roots")
    plan = json.loads(bodies["/plan"])
    if plan["generation"] != serving_state().generation or not plan[
            "entries"]:
        raise AssertionError(f"trace: /plan generation {plan['generation']}"
                             f", {len(plan['entries'])} entries")
    doc = json.loads(bodies["/trace"])
    if doc.get("otherData", {}).get("schema") != 1:
        raise AssertionError(f"trace: /trace otherData {doc.get('otherData')}")
    with tempfile.NamedTemporaryFile("w", suffix=".json") as fh:
        fh.write(bodies["/trace"])
        fh.flush()
        spans = load_span_file(fh.name)
    if len(spans) != len(doc["traceEvents"]):
        raise AssertionError(f"trace: {len(doc['traceEvents'])} events, "
                             f"{len(spans)} spans read back")
    names = collections.Counter(sp.name for sp in spans)
    if not all(names[n] for n in TRACE_SPANS):
        raise AssertionError(f"trace: span names {dict(names)}")
    untiered = [sp for sp in spans if sp.name == "dispatch.resolve"
                and "tier" not in sp.attrs]
    if untiered:
        raise AssertionError(f"trace: {len(untiered)} dispatch.resolve spans "
                             "without a tier")
    roots = [sp for sp in spans if sp.name == "engine.tick"]
    if (len(roots) != eng.ticks or any(sp.parent_id for sp in roots)
            or len({sp.trace_id for sp in roots}) != eng.ticks
            or sorted(sp.attrs["tick"] for sp in roots)
            != list(range(eng.ticks))):
        raise AssertionError(f"trace: {len(roots)} engine.tick roots for "
                             f"{eng.ticks} ticks")
    split = tick_split(spans)
    resolving = [r["tick"] for r in split if r["resolves"]]
    if resolving != [0]:
        raise AssertionError(f"trace: ticks {resolving} resolved configs on "
                             "the host; only the capturing tick 0 should")
    by_id = {sp.span_id: sp for sp in spans}
    parents = collections.Counter(
        (by_id[sp.parent_id].name if sp.parent_id in by_id else "")
        for sp in spans if sp.name == "dispatch.resolve")
    tiers = collections.Counter(
        sp.attrs["tier"] for sp in spans if sp.name == "dispatch.resolve"
        and (by_id[sp.parent_id].name if sp.parent_id in by_id else "")
        != "dispatch.probe")
    if set(tiers) != {"plan"}:
        raise AssertionError(f"trace: the serve's resolution tiers "
                             f"{dict(tiers)}, want all plan")
    admits = [sp.dur * 1e3 for sp in spans if sp.name == "engine.admit"]
    phase("trace", f"{cfg.name} ({cfg.n_layers}L d={cfg.d_model} bf16) from "
          f"the tuned store, trace_sample=1.0, status_port=0: "
          f"{len(prompts)} x 32-token prompts x 16 tokens in "
          f"{wall * 1e3:.1f} ms, {eng.ticks} ticks ({eng.replays} replays), "
          f"{eng.prefills} prefills ({eng.prefill_replays} replays), the "
          f"serve phase's tokens; spans {dict(sorted(names.items()))}; "
          f"dispatch.resolve by parent {dict(parents)}, the serve's by tier "
          f"{dict(tiers)}, only in tick 0 (the capture and its warm-up) "
          f"and the 32-token prefill's capture; {len(roots)} engine.tick "
          f"roots, one a tick; /status trace sampled "
          f"{status['trace']['sampled']} dropped "
          f"{status['trace']['dropped']}; /plan {len(plan['entries'])} "
          f"entries [{label}]")
    phase("trace", "scrape ms (median of "
          f"{TRACE_SCRAPES}, this process, localhost): "
          + ", ".join(f"{r} {ms[r]:.3f} ({len(bodies[r])} B)"
                      for r in TRACE_ROUTES) + f" [{label}]")
    replayed = [r for r in split if not r["resolves"]]
    phase("trace", f"engine.tick split, replayed ticks: "
          f"{split_medians(replayed)}; the capturing tick 0: wall "
          f"{split[0]['wall']:.3f} ms, dispatch.resolve "
          f"{split[0]['resolve']:.3f} ms over {split[0]['resolves']} "
          f"resolutions; engine.admit median "
          f"{statistics.median(admits):.3f} ms [{label}]")
    return {"scrape_ms": ms, "spans": dict(names), "tick_ms": statistics.median(
        r["wall"] for r in replayed)}


def trace_overhead(eng, serve: dict, label: str) -> dict:
    """E18.1, a plan hit's µs and E18.2 on the trace phase's engine (see
    :func:`phase_trace`)."""
    prompts = serve["prompts"]
    reset_tracing()
    eng.tracer = None
    with count_tracer_calls() as calls:
        outs = eng.generate(prompts, max_new=16)
    torch.cuda.synchronize()
    if calls or outs != serve["outs"]:
        raise AssertionError(f"trace: E18.1: {len(calls)} Tracer calls "
                             "with tracing off (want 0), or other tokens")
    shapes = eng._decode_shapes
    hit_us = []
    for _ in range(RESOLVE_REPS):
        dispatch.reset_counts()
        hit_us.append(time_tuned_cfg(shapes))
        if set(t for _, t in dispatch.tier_counts) != {"plan"}:
            raise AssertionError(f"trace: tiers {dict(dispatch.tier_counts)}")
    hit_us = statistics.median(hit_us)

    def block(traced: bool) -> float:
        if traced:
            eng.tracer = enable_tracing(TRACE_SAMPLE)
        else:
            reset_tracing()
            eng.tracer = None
        eng.tick_times.clear()
        eng.generate(prompts, max_new=16)
        torch.cuda.synchronize()
        return statistics.median(w for _, w, _ in eng.tick_times)

    block(False)
    block(True)
    ratios, aa, quiet, traced = [], [], [], []
    for _ in range(TRACE_TRIPLETS):
        q1, s, q2 = block(False), block(True), block(False)
        ratios.append(2.0 * s / (q1 + q2))
        aa.append(abs(q2 / q1 - 1.0))
        quiet += [q1, q2]
        traced.append(s)
    reset_tracing()
    eng.tracer = None
    overhead = statistics.median(ratios) - 1.0
    noise = statistics.median(aa)
    budget = TRACE_OVERHEAD + 2.0 * noise
    phase("trace", f"E18.1: {len(calls)} Tracer calls over a generate with "
          f"tracing off (gate 0), the same tokens; a plan hit through "
          f"dispatch._tuned_cfg with tracing off {hit_us:.3f} us a call "
          f"(median of {RESOLVE_REPS} x {RESOLVE_CALLS} over the tick's "
          f"{len(shapes)} shapes); E18.2 at {TRACE_SAMPLE:.0%} sampling over "
          f"{TRACE_TRIPLETS} quiet/traced/quiet triplets: median tick quiet "
          f"{statistics.median(quiet) * 1e3:.3f} ms, traced "
          f"{statistics.median(traced) * 1e3:.3f} ms, overhead {overhead:+.2%} "
          f"against the budget {TRACE_OVERHEAD:.0%} + 2 x the "
          f"{noise:.2%} A/A noise = {budget:.2%}: "
          f"{'within' if overhead <= budget else 'OVER'} [{label}]")
    return {"tracer_calls_off": len(calls), "plan_hit_us": hit_us,
            "overhead": overhead, "noise": noise, "budget": budget}


PROFILE_REPS = 5                   # graph replays traced in one round
PROFILE_ROUNDS = 5                 # traced rounds before the phase fails


def demangle(names: list) -> list:
    """Kernel names as the profiler shows them: ``abi::__cxa_demangle``
    (libstdc++), which the profiler's CUPTI consumer applies to every
    ``_Z`` name; any other name stays as it is."""
    lib = ctypes.CDLL("libstdc++.so.6")
    fn = lib.__cxa_demangle
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    libc = ctypes.CDLL("libc.so.6")
    libc.free.argtypes = [ctypes.c_void_p]
    out = []
    for name in names:
        status = ctypes.c_int(-1)
        ptr = (fn(name.encode(), None, None, ctypes.byref(status))
               if name.startswith("_Z") else None)
        if ptr and status.value == 0:
            out.append(ctypes.string_at(ptr).decode())
            libc.free(ptr)
        else:
            out.append(name)
    return out


def kernel_kind(name: str) -> str:
    return ("gemm" if GEMM_KERNEL.search(name) else "gemm_reduce"
            if REDUCE_KERNEL.search(name) else "other")


def traced_round(graph, nodes: collections.Counter, reps: int,
                 max_lost: int = 0) -> tuple:
    """Trace ``reps`` replays of ``graph``: (held, what, kernel events).
    With ``max_lost`` 0 the round holds when it is whole: its kernel
    events, in start order, split into ``reps`` runs of len(nodes) events
    whose names are exactly the graph's kernel nodes' (the same multiset,
    replay by replay).  Otherwise it holds when no event is foreign to
    the graph's nodes and at most ``max_lost`` of them are missing.  One
    replay before the counted ones runs under the profiler's warm-up step,
    whose events are dropped: a round lost events of its first replay,
    from its first nodes on, while the tracer started."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=reps,
                                             repeat=1)) as prof:
        for _ in range(reps + 1):
            graph.replay()
            torch.cuda.synchronize()
            prof.step()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not ev.name.startswith(("Memcpy", "Memset"))),
                 key=lambda ev: ev.time_range.start)
    per = sum(nodes.values())
    got = collections.Counter(ev.name for ev in evs)
    want = collections.Counter({n: c * reps for n, c in nodes.items()})
    miss, extra = want - got, got - want
    lost = sum(miss.values())
    what = (f"{len(evs)} kernel events, want {reps} x {per} (missing "
            f"{list(miss.items())[:3]}, extra {list(extra.items())[:3]})")
    if max_lost:
        return not extra and lost <= max_lost, (
            what if lost else "whole"), evs
    if len(evs) != reps * per:
        return False, what, evs
    for r in range(reps):
        got = collections.Counter(ev.name for ev in
                                  evs[r * per:(r + 1) * per])
        if got != nodes:
            miss, extra = nodes - got, got - nodes
            return False, (f"replay {r}: names differ (missing "
                           f"{list(miss.items())[:3]}, extra "
                           f"{list(extra.items())[:3]})"), evs
    return True, "whole", evs


def traced_split(graph, nodes: collections.Counter, what: str,
                 max_lost: int = 0) -> tuple:
    """Trace rounds of :data:`PROFILE_REPS` replays of ``graph`` until one
    holds (:func:`traced_round`), at most :data:`PROFILE_ROUNDS`; the
    phase ``what`` fails if none does.  Returns (each round's verdict, the
    replay's kernels as (ms, count, name) in order of time, and the GEMM /
    reduction / other totals as kind -> [ms, count]), per replay: each
    name's mean event time times its count among the graph's nodes (in a
    whole round, its events' time over the replays)."""
    reps, tries = PROFILE_REPS, []
    for _ in range(PROFILE_ROUNDS):
        held, verdict, evs = traced_round(graph, nodes, reps, max_lost)
        tries.append(verdict)
        if held:
            break
    else:
        raise AssertionError(f"{what}: no traced round of {reps} replays "
                             f"held the captured tick's "
                             f"{sum(nodes.values())} kernel nodes in "
                             f"{PROFILE_ROUNDS} rounds: {tries}")
    by_name: dict = {}
    for ev in evs:
        t = by_name.setdefault(ev.name, [0.0, 0])
        t[0] += ev.time_range.elapsed_us() / 1e3
        t[1] += 1
    split = sorted(((ms / cnt * nodes[name], nodes[name], name)
                    for name, (ms, cnt) in by_name.items()), reverse=True)
    kinds = {"gemm": [0.0, 0], "gemm_reduce": [0.0, 0], "other": [0.0, 0]}
    for ms, cnt, name in split:
        kinds[kernel_kind(name)][0] += ms
        kinds[kernel_kind(name)][1] += cnt
    return tries, split, kinds


def init_cupti() -> None:
    """Start the profiler (CUPTI) once: a graph captured before CUPTI was
    initialised may replay untraced."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def phase_profile(eng, cfg, dev: torch.device, label: str) -> dict:
    """Where a decode tick's time goes: the eager tick's wall time
    (synchronised), the host time to enqueue it, the device time of the
    same tick replayed from a CUDA graph (no host in the way), and that
    replay's kernels by name.  The tick is captured with its
    ``cudaGraph_t`` kept, so its kernel nodes are known exactly
    (:func:`graph_kernel_names`); a traced round counts only when its
    kernel events are those nodes, replay by replay and name by name
    (:func:`traced_round`).  A round that is not whole is thrown away and
    traced again, up to :data:`PROFILE_ROUNDS` rounds; if none is whole
    the phase fails.  From the whole round: per kernel name, its ms and
    count a tick, in order of time, and the GEMM, reduction and other
    totals."""
    last = torch.zeros((4, 1), dtype=torch.long, device=dev)
    idx = torch.full((4,), 40, dtype=torch.long, device=dev)
    tick = lambda: decode_step(eng.params, cfg, last, eng.cache, idx)
    n = 10
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            tick()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        tick()
        enqueues.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    init_cupti()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        tick()
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    nodes = collections.Counter(demangle(graph_kernel_names(graph)))
    device_ms = replay_ms(graph, n)
    reps = PROFILE_REPS
    tries, split, kinds = traced_split(graph, nodes, "profile")
    out = {"wall_ms": 1e3 * statistics.median(walls),
           "enqueue_ms": 1e3 * statistics.median(enqueues),
           "device_ms": device_ms,
           "kernels_ms": {k: v[0] for k, v in kinds.items()},
           "kernels_per_tick": {k: v[1] for k, v in kinds.items()},
           "rounds": len(tries), "split": split}
    busy = sum(out["kernels_ms"].values())
    phase("profile", f"decode tick (4 slots, 30 layers): eager wall "
          f"{out['wall_ms']:.2f} ms, host enqueue {out['enqueue_ms']:.2f} "
          f"ms, device (CUDA graph replay) {out['device_ms']:.2f} ms, "
          f"device busy {100 * out['device_ms'] / out['wall_ms']:.1f}% of "
          f"the eager tick; the captured tick holds {sum(nodes.values())} "
          f"kernel nodes ({len(nodes)} names); traced rounds of {reps} "
          f"replays: {len(tries)} to a whole one ({tries}); in the replayed "
          f"tick: GEMM kernels {out['kernels_ms']['gemm']:.3f} ms "
          f"({out['kernels_per_tick']['gemm']} a tick), reduction "
          f"passes {out['kernels_ms']['gemm_reduce']:.3f} ms "
          f"({out['kernels_per_tick']['gemm_reduce']}), other kernels "
          f"{out['kernels_ms']['other']:.3f} ms "
          f"({out['kernels_per_tick']['other']}); kernels busy "
          f"{busy:.3f} ms, {100 * busy / out['device_ms']:.1f}% of the "
          f"replay [{label}]")
    for rank, (ms, cnt, name) in enumerate(split, 1):
        phase("profile", f"#{rank} {kernel_kind(name)}: {ms:.4f} ms, {cnt} "
              f"a tick, {name[:150]}")
    return out


def phase_model(cfg, params, dev: torch.device) -> float:
    rng = np.random.default_rng(2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32)),
                              device=dev)
    steps = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 4)), device=dev)

    def run(plain: bool) -> torch.Tensor:
        cache = init_cache(cfg, 4, 256, dev)
        kv = cache["pos0"]["attn"]
        out = []
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        with ctx:
            for s in range(4):
                one = {"pos0": {"attn": {"k": kv["k"][:, s:s + 1],
                                         "v": kv["v"][:, s:s + 1]}}}
                lg, _ = prefill(params, cfg, {"tokens": prompts[s:s + 1]},
                                one)
                out.append(lg)
            idx = torch.full((4,), 32, dtype=torch.long, device=dev)
            for t in range(4):
                lg, _ = decode_step(params, cfg, steps[:, t:t + 1], cache,
                                    idx + t)
                out.append(lg)
        return torch.cat(out)

    got, want = run(False), run(True)
    torch.cuda.synchronize()
    _, er = rel_err(got, want)
    if not (torch.isfinite(got).all() and er <= LOGIT_TOL):
        raise AssertionError(f"logits kernel vs plain rel err {er:.3e}")
    phase("model", f"prefill x4 + 4 decode steps: logits kernel vs plain "
          f"rel err {er:.3e} (tolerance {LOGIT_TOL}), shape "
          f"{tuple(got.shape)}")
    return er


# the Mamba phase: mamba2-1.3b's two projections a layer as (N, K), w_in
# (2048 -> 8512) and w_out (4096 -> 2048), tuned at the tick's M (4 slots)
# and the prompts' (32 tokens) from a dataset of MAMBA_TUNE_SAMPLES; the
# prefill parity lengths (falling: 300 spans two 256-step chunks, padded,
# and 1 takes the decode branch); the recurrence check's prefill length
# and decode steps (across the chunk boundary at 256) and its rtol / atol,
# those of the reference's tests/test_models.py
# test_smoke_decode_matches_forward, which runs in fp32.  The check holds
# the full-width weights in fp32: in bf16 the chunked and the recurrent
# forms round differently and the gap grows with depth through random
# layers, the GEMMs' plain versions alike (``tools/mamba_recurrence.py``
# measures it by depth), so bf16's is printed
# the retune phase: SmolLM-135M from an empty store (ServeConfig below);
# part A's traffic, part B's burst (requests, prompt, new tokens), part
# C's extra prompt length, and the lengths tried for part C's overlapping
# capture
RETUNE_SLOTS, RETUNE_MAX_LEN, RETUNE_INTERVAL = 4, 256, 8
RETUNE_PROMPTS, RETUNE_PROMPT, RETUNE_NEW = 8, 32, 48
RETUNE_BURST = (96, 100, 2)
RETUNE_ASYNC_PROMPT = 48
RETUNE_OVERLAP_LENGTHS = (40, 56, 72, 88, 120, 136)
RETUNE_COOLDOWN = 10_000           # part C: one epoch from the engine's polls
RETUNE_AFTER_NEW = 32              # part C: the serve after the epochs
# the device memory an inline epoch may leave allocated beyond what it
# found (its operand sets and gate cases are released when it ends)
RETUNE_MEM_SLACK = 8 << 20
RETUNE_SCRAPE_GAP_S = 0.01         # part C: the scraper's pause per round


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def operand_cache_bytes(backend) -> int:
    """Device bytes the timer keeps between measurements: the operand
    copies of the last shape it timed."""
    return storage_bytes(t for ops_ in backend.timer._operands[1]
                         for t in ops_)


class RetuneWatch:
    """The retune phase's view of one engine: every poll's decisions
    printed, every report with the tick that returned it, the memory
    before the poll that returned it (inline: before its epoch) and after
    it, the window of every capture, and the GEMM and reduction kernels
    each replay gives the device (each graph's nodes, read at its capture,
    times its replays; every captured graph must hold ``per_fwd`` GEMM
    nodes)."""

    def __init__(self, eng, what: str, per_fwd: int, label: str = "retune"):
        self.eng, self.what, self.per_fwd = eng, what, per_fwd
        self.reports: list = []
        self.device = {"gemm": 0, "reduce": 0}
        self.tiers_at_first: Optional[dict] = None
        self.captures: list = []            # (start, end) perf_counter
        self._alloc_before: Optional[int] = None
        self._nodes: dict = {}
        ctl = eng.controller
        real_check, real_poll = ctl.check, eng.maybe_retune
        real_captured = eng._captured
        real_tick, real_pre = eng.decode, eng.prefill

        def check():
            decisions = real_check()
            for sp, d in sorted(decisions.items()):
                phase(label, f"  {what} poll at tick {eng.ticks}: {sp} "
                      f"drift {d.drift:.3f}, untuned mass "
                      f"{d.untuned_mass:.3f}, {d.window_calls} window "
                      f"calls, novel {[shape_str(x) for x in d.novel_shapes]}"
                      f", reason {d.reason or '-'}")
            return decisions

        def poll():
            self._alloc_before = torch.cuda.memory_allocated()
            report = real_poll()
            if report is not None:
                self.note(report)
            self._alloc_before = None
            return report

        def captured(fn, pool=None, keep=()):
            t0 = time.perf_counter()
            graph, out, shapes = real_captured(fn, pool=pool, keep=keep)
            self.captures.append((t0, time.perf_counter()))
            n_gemm, n_reduce, _ = graph_counts(graph)
            if n_gemm != per_fwd:
                raise AssertionError(f"{what}: a captured graph holds "
                                     f"{n_gemm} GEMM nodes, want {per_fwd}")
            self._nodes[id(graph)] = (n_gemm, n_reduce)
            return graph, out, shapes

        def count(graph):
            n_gemm, n_reduce = self._nodes[id(graph)]
            self.device["gemm"] += n_gemm
            self.device["reduce"] += n_reduce

        def tick(last, idx):
            out = real_tick(last, idx)
            count(eng.graph)
            return out

        def pre(slot, tokens):
            out = real_pre(slot, tokens)
            count(eng.prefill_graphs[tokens.shape[1]])
            return out

        ctl.check, eng.maybe_retune, eng._captured = check, poll, captured
        eng.decode, eng.prefill = tick, pre

    def note(self, report) -> None:
        """Keep one report with the tick that returned it, the engine's
        captures and the memory at that moment."""
        eng = self.eng
        if self.tiers_at_first is None:
            self.tiers_at_first = dict(dispatch.tier_counts)
        self.reports.append({
            "report": report, "tick": eng.ticks,
            "tick_index": len(eng.tick_times), "captures": eng.captures,
            "alloc": torch.cuda.memory_allocated(),
            "alloc_before": self._alloc_before,
            "prefill_pool": eng.prefill_graph_bytes(),
            "operands": sum(operand_cache_bytes(b) for b in {
                id(t.backend): t.backend
                for t in eng.controller.tuners().values()}.values())})

    def tuned_reports(self) -> list:
        return [r for r in self.reports if r["report"].tuned]


class Scraper:
    """Scrapes ``/status`` and ``/metrics`` from a thread of its own, round
    after round until stopped, while the serving thread captures graphs
    and an async epoch times kernels: each scrape's start, end, route and
    whether an epoch was in flight, and every failure (a status other than
    200, a ``/status`` that does not parse, an exception)."""

    ROUTES = ("/status", "/metrics")

    def __init__(self, url: str, ctl):
        self.url, self.ctl = url, ctl
        self.rows: list = []
        self.failures: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chip-smoke-scraper")

    def start(self) -> "Scraper":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            for route in self.ROUTES:
                t0 = time.perf_counter()
                busy = self.ctl.async_active()
                try:
                    code, body, _ = scrape(self.url + route)
                    if code != 200:
                        self.failures.append((route, code, body[:200]))
                    elif route == "/status" and json.loads(body)[
                            "schema"] != 1:
                        self.failures.append((route, "schema", body[:200]))
                except Exception as e:  # noqa: BLE001 — stop() reports it
                    self.failures.append((route, type(e).__name__, str(e)))
                self.rows.append((t0, time.perf_counter(), route, busy))
            self._stop.wait(RETUNE_SCRAPE_GAP_S)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(60)
        if self._thread.is_alive():
            raise AssertionError("retune C: the scraper did not stop")


def epoch_memory(watch, what: str) -> list:
    """C12: after every epoch the timer holds no operand set; an inline
    epoch (run inside the poll) leaves the device memory allocated within
    :data:`RETUNE_MEM_SLACK` of its level before the poll.  Returns each
    inline epoch's after-minus-before bytes."""
    deltas = []
    for r in watch.reports:
        if r["operands"]:
            raise AssertionError(f"{what}: the timer holds {r['operands']} B "
                                 f"of operands after epoch "
                                 f"{r['report'].epoch}")
        if r["report"].mode == "inline" and r["alloc_before"] is not None:
            grow = r["alloc"] - r["alloc_before"]
            deltas.append(grow)
            if grow > RETUNE_MEM_SLACK:
                raise AssertionError(f"{what}: epoch {r['report'].epoch} "
                                     f"left {grow} B more allocated than "
                                     f"before it")
    return deltas


def shape_str(x: dict) -> str:
    keys = ("M", "N", "K") if "M" in x else ("B", "Hq", "Hkv", "Lq", "Lkv",
                                              "D")
    return "x".join(str(x[k]) for k in keys)


def retune_engine(cfg, params, dev: torch.device, tuners: dict,
                  **kw) -> Engine:
    """A fresh engine serving from an empty in-memory store (the engine
    installs it), the telemetry cleared, the loop on."""
    clear_telemetry()
    clear_models()
    install_serving(store=None, models=None, fingerprint=None)
    dispatch.reset_counts()
    return Engine(cfg, params, ServeConfig(
        slots=RETUNE_SLOTS, max_len=RETUNE_MAX_LEN, retune=True,
        retune_interval=RETUNE_INTERVAL, retune_min_calls=32,
        retune_top_k=4, retune_train=True, record_tick_times=True, **kw),
        device=dev, retune_tuners=tuners)


def end_async(ctl, watch, poll: bool = False,
              timeout_s: float = 300.0) -> None:
    """Wait for the background epoch in flight to end, then take its
    report: through a poll (which reaps it) or through ``wait_async`` (no
    detection, so no new epoch starts); ``watch`` keeps it."""
    deadline = time.perf_counter() + timeout_s
    while ctl.async_active() and time.perf_counter() < deadline:
        time.sleep(0.05)
    if ctl.async_active():
        raise AssertionError(f"retune: an async epoch did not end in "
                             f"{timeout_s:.0f} s")
    report = ctl.maybe_retune() if poll else ctl.wait_async()
    if report is not None:
        watch.note(report)


def graph_shapes_exact(eng, shapes, fp: str, what: str) -> int:
    """Every (space, shape) a graph dispatched that has a record resolves
    on a plan entry that is the record's config on tier exact (the plan
    current: the store has not moved past it); returns how many."""
    state = serving_state()
    store = eng.tunedb_store
    if state.plan is None or store.version != state.plan.store_version:
        raise AssertionError(f"{what}: no current plan")
    keyed = {(sp, shape_key(x)) for sp, x in shapes
             if store.contains(sp, x, backend=fp)}
    check_plan_exact(state.plan, store, fp, keyed, what)
    return len(keyed)


def tick_ms(eng, lo: int = 0, hi: Optional[int] = None) -> list:
    return [1e3 * w for _, w, _ in list(eng.tick_times)[lo:hi]]


def phase_retune(cfg, params, backend, fp: str, tuners: dict,
                 dev: torch.device, label: str,
                 serve_device_ms: Optional[float] = None) -> dict:
    """The retune loop on the card: SmolLM-135M at full width serving from
    an empty store notices its own untuned GEMMs and decode split-count
    shapes, tunes them on the card with the tune phase's GEMM and
    attention tuners (``CheckedBackend(CudaEventBackend)``), retrains the
    GEMM regressor and swaps in a new generation mid-serve.

    A (inline): 8 x 32-token prompts x 48 tokens.  An epoch tunes, its
    records are ``source="retune"`` under the card's fingerprint, the
    generation flips and the next tick captures the tick graph again;
    every GEMM and split-count shape of that graph with a record resolves
    on its record's config (tier exact); a replayed tick's logits are
    bitwise the eager tick's; the memory after each epoch grows by no more
    than the timer's operand cache and the prefill pool's growth.
    B (the same engine): 96 x 100-token prompts x 2 tokens; the drift or
    untuned mass trips an epoch that tunes the M = 100 shapes, and the
    100-token prefill graph, captured again under the new generation,
    resolves its 210 GEMMs on their records.
    C (a fresh engine and store, ``retune_async``, and a cooldown that
    leaves the engine's own polls one epoch): A's traffic and 4 x
    48-token prompts; a prefill capture of a new length starts and ends
    while the background epoch is in flight (its measurements and the
    capture hold ``DEVICE_LOCK``; novel traffic and a poll start one when
    none runs); no capture fails; the report surfaces on a later poll;
    every request is served whole; then 4 x 32 tokens are served with no
    epoch in flight.
    Prints the tier counts, the epoch's wall (session, retrain, install),
    the tripping tick, the median tick before and after the swap, the
    tick wall while an async epoch is in flight and after, and the async
    records' TFLOP/s over the inline ones'."""
    t_phase = time.perf_counter()
    per_fwd = GEMMS_PER_LAYER * cfg.n_layers
    rng = np.random.default_rng(5)
    vocab = cfg.vocab
    out = {"device_launches": 0, "device_reduce_launches": 0}

    # -- A: inline, the untuned start, traced ------------------------------
    eng = retune_engine(cfg, params, dev, tuners, trace_sample=1.0)
    gen0 = serving_state().generation
    watch = RetuneWatch(eng, "A", per_fwd)
    prompts = [rng.integers(0, vocab, RETUNE_PROMPT)
               for _ in range(RETUNE_PROMPTS)]
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=RETUNE_NEW)
    torch.cuda.synchronize()
    a_wall = time.perf_counter() - t0
    if [len(o) for o in outs] != [RETUNE_NEW] * len(prompts):
        raise AssertionError("retune A: a request was not served whole")
    tuned = watch.tuned_reports()
    if not tuned:
        raise AssertionError(f"retune A: no epoch tuned ({watch.reports})")
    store = eng.tunedb_store
    recs = store.records()
    if not recs or any(r.source != "retune" or r.backend != fp
                       for r in recs):
        raise AssertionError(f"retune A: records {[(r.source, r.backend) for r in recs]}")
    first = tuned[0]
    if first["report"].generation <= gen0:
        raise AssertionError("retune A: the generation did not flip")
    if eng.captures <= first["captures"]:
        raise AssertionError("retune A: no tick captured after the swap")
    tiers_before = {f"{sp}/{t}": c for (sp, t), c
                    in sorted(watch.tiers_at_first.items())}
    tiers_after = {f"{sp}/{t}": c - watch.tiers_at_first.get((sp, t), 0)
                   for (sp, t), c in sorted(dispatch.tier_counts.items())
                   if c - watch.tiers_at_first.get((sp, t), 0)}
    # the tick graph under the live generation: a tick replayed (captured
    # again if the last epoch ended on the last tick), then held
    last = torch.as_tensor(rng.integers(0, vocab, (RETUNE_SLOTS, 1)),
                           device=dev)
    idx = torch.full((RETUNE_SLOTS,), 40, dtype=torch.long, device=dev)
    eng.decode(last, idx)
    n_exact = graph_shapes_exact(eng, eng._decode_shapes, fp, "retune A tick")
    decode_gemm = {shape_key(x) for sp, x in eng._decode_shapes
                   if sp == "gemm"}
    if not any(store.contains("gemm", dict(k), backend=fp)
               for k in decode_gemm):
        raise AssertionError("retune A: no decode GEMM shape was tuned")
    want = eng.decode_eager(last, idx).clone()
    got = eng.decode_graph(last, idx).clone()
    torch.cuda.synchronize()
    # the part of a replayed tick's wall the spans leave unsplit that is
    # the device's: this generation's tick graph, replayed alone
    a_device_ms = replay_ms(eng.graph)
    if not torch.equal(got, want):
        raise AssertionError(f"retune A: replayed tick logits differ from "
                             f"the eager tick's (max abs "
                             f"{(got.float() - want.float()).abs().max():.3e})")
    ticks = tick_ms(eng)
    trip = first["tick_index"]
    before_ms = statistics.median(ticks[:trip]) if trip else float("nan")
    after = ticks[trip + 2:] or [float("nan")]
    rep = first["report"]
    split = tick_split(eng.tracer.spans())
    if [r["tick"] for r in split] != list(range(len(ticks))):
        raise AssertionError(f"retune A: {len(split)} engine.tick roots for "
                             f"{len(ticks)} ticks")
    out["split_A"] = {"before": split[:trip], "trip": split[trip],
                      "capture": split[trip + 1] if trip + 1 < len(split)
                      else None, "after": split[trip + 2:]}
    phase("retune", f"A: {cfg.name} ({cfg.n_layers}L bf16), "
          f"{len(prompts)} x {RETUNE_PROMPT}-token prompts x {RETUNE_NEW} "
          f"tokens from an empty store in {a_wall:.2f} s, {eng.ticks} ticks; "
          f"{len(watch.reports)} epoch(s), {len(tuned)} tuned: "
          + "; ".join(f"epoch {r['report'].epoch} at tick {r['tick']} "
                      f"({r['report'].mode}): {r['report'].tuned} tuned, "
                      f"retrained {r['report'].retrained}, generation "
                      f"{r['report'].generation}" for r in watch.reports))
    phase("retune", f"A: first epoch wall {rep.wall_s:.3f} s = session "
          f"{rep.session_s:.3f} s + retrain {rep.retrain_s:.3f} s + install "
          f"{rep.install_s:.3f} s (+ detection); the tripping tick "
          f"{ticks[trip]:.1f} ms, the next (captures the tick again) "
          f"{ticks[trip + 1] if trip + 1 < len(ticks) else float('nan'):.1f}"
          f" ms; median tick {before_ms:.2f} ms before the swap, "
          f"{statistics.median(after):.2f} ms after [{label}]")
    phase("retune", f"A: dispatch tiers up to the first epoch {tiers_before}, "
          f"after it {tiers_after}; {len(recs)} retune records under {fp}; "
          f"the tick graph of generation {serving_state().generation}: "
          f"{n_exact} of its {len({(sp, shape_key(x)) for sp, x in eng._decode_shapes})} "
          f"shapes have records, each planned exact on its config; a "
          f"replayed tick's logits bitwise the eager tick's")
    for r in sorted(recs, key=lambda r: (r.space, sorted(r.inputs.items()))):
        phase("retune", f"  A record {r.space} {shape_str(r.inputs)} -> "
              f"{r.config} {r.tflops:.3f} TFLOPS")
    mem = epoch_memory(watch, "retune A")
    phase("retune", f"A: memory_allocated after each epoch "
          f"{[round(r['alloc'] / 2**20, 1) for r in watch.reports]} MiB, "
          f"after minus before the epoch {mem} B (within "
          f"{RETUNE_MEM_SLACK >> 20} MiB), the timer's operand cache "
          f"{[r['operands'] for r in watch.reports]} B after each, the "
          f"prefill pool "
          f"{[round(r['prefill_pool'] / 2**20, 1) for r in watch.reports]} "
          f"MiB [{label}]")
    sa = out["split_A"]
    phase("retune", f"A: engine.tick split (trace_sample=1.0): before the "
          f"swap {split_medians(sa['before'])}; after it (from the second "
          f"tick on) {split_medians(sa['after'])}; the tripping tick wall "
          f"{sa['trip']['wall']:.1f} ms, dispatch.resolve "
          f"{sa['trip']['resolve']:.3f} ms, the rest "
          f"{sa['trip']['rest']:.1f} ms (the inline epoch opens no span: "
          f"its wall {rep.wall_s * 1e3:.1f} ms is in the rest); the "
          f"capturing tick wall "
          f"{sa['capture']['wall'] if sa['capture'] else float('nan'):.1f} "
          f"ms, dispatch.resolve "
          f"{sa['capture']['resolve'] if sa['capture'] else float('nan'):.1f}"
          f" ms over "
          f"{sa['capture']['resolves'] if sa['capture'] else 0} resolutions;"
          f" the tick graph of the last generation replays alone in "
          f"{a_device_ms:.3f} ms on the device (the serve phase's tick "
          f"graph: {serve_device_ms if serve_device_ms else float('nan'):.3f}"
          f" ms, profile phase) [{label}]")
    inline = {(r.space, shape_key(r.inputs)): r for r in recs}

    # -- B: the prefill burst on the same engine ----------------------------
    n_req, n_prompt, n_new = RETUNE_BURST
    b_from = len(watch.reports)
    burst = [rng.integers(0, vocab, n_prompt) for _ in range(n_req)]
    t0 = time.perf_counter()
    outs = eng.generate(burst, max_new=n_new)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    if [len(o) for o in outs] != [n_new] * n_req:
        raise AssertionError("retune B: a request was not served whole")
    b_tuned = [r for r in watch.reports[b_from:] if r["report"].tuned]
    prefill_m = {shape_key(x) for sp, x in eng._prefill_shapes[n_prompt]
                 if sp == "gemm"}
    if not b_tuned or not all(store.contains("gemm", dict(k), backend=fp)
                              for k in prefill_m):
        raise AssertionError(f"retune B: the M = {n_prompt} shapes were not "
                             f"tuned ({[r['report'].decisions for r in watch.reports[b_from:]]})")
    reasons = {d.reason for r in b_tuned
               for d in r["report"].decisions.values() if d.trigger}
    if not reasons <= {"drift", "untuned"}:
        raise AssertionError(f"retune B: triggers {reasons}")
    if eng._prefill_gen != serving_state().generation:
        eng.prefill(0, torch.as_tensor(burst[0][None], device=dev))
    n_pre = graph_shapes_exact(eng, eng._prefill_shapes[n_prompt], fp,
                               f"retune B {n_prompt}-token prefill")
    pre_gemm = sum(1 for sp, _ in eng._prefill_shapes[n_prompt]
                   if sp == "gemm")
    if pre_gemm != per_fwd or graph_counts(
            eng.prefill_graphs[n_prompt])[0] != per_fwd:
        raise AssertionError(f"retune B: the {n_prompt}-token prefill graph "
                             f"dispatched {pre_gemm} GEMMs")
    phase("retune", f"B: {n_req} x {n_prompt}-token prompts x {n_new} tokens "
          f"in {b_wall:.2f} s ({len(watch.reports) - b_from} epoch(s), "
          f"triggers {sorted(reasons)}, "
          + "; ".join(f"epoch {r['report'].epoch}: {r['report'].tuned} tuned "
                      f"in {r['report'].wall_s:.3f} s" for r in b_tuned)
          + f"); the {n_prompt}-token prefill graph of generation "
          f"{eng._prefill_gen} resolves its {pre_gemm} GEMMs on "
          f"{len(prefill_m)} tuned shapes, {n_pre} planned exact")
    b_mem = epoch_memory(watch, "retune B")[len(mem):]
    phase("retune", f"B: after minus before each epoch {b_mem} B, the "
          f"timer's operand cache "
          f"{[r['operands'] for r in watch.reports[b_from:]]} B after each")
    out["device_launches"] += watch.device["gemm"]
    out["device_reduce_launches"] += watch.device["reduce"]
    a_stats = eng.controller.stats()
    a_ticks = eng.ticks
    del eng, watch
    gc.collect()
    reset_tracing()                 # part C's spans start from none

    # -- C: async -----------------------------------------------------------
    # the cooldown keeps the engine's own polls from starting a second
    # epoch, so the short serve after the epochs runs none in flight; the
    # phase's own polls pass no tick, which the cooldown does not count
    eng = retune_engine(cfg, params, dev, tuners, retune_async=True,
                        retune_cooldown_ticks=RETUNE_COOLDOWN,
                        trace_sample=1.0, status_port=0)
    ctl = eng.controller
    watch = RetuneWatch(eng, "C", per_fwd)
    prompts = ([rng.integers(0, vocab, RETUNE_PROMPT)
                for _ in range(RETUNE_PROMPTS)]
               + [rng.integers(0, vocab, RETUNE_ASYNC_PROMPT)
                  for _ in range(4)])
    # while an epoch is in flight its timer captures graphs on another
    # thread: this thread synchronises its stream, never the whole device
    # (cudaDeviceSynchronize is refused during a capture)
    stream = torch.cuda.current_stream(dev)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=RETUNE_NEW)
    stream.synchronize()
    c_wall, c_ticks = time.perf_counter() - t0, eng.ticks
    if [len(o) for o in outs] != [RETUNE_NEW] * len(prompts):
        raise AssertionError("retune C: a request was not served whole")
    # a prefill capture of a new length inside an epoch in flight: start
    # one (novel traffic, then a poll) whenever none runs; /status and
    # /metrics are scraped from another thread all the while
    overlap, tries = None, []
    n_caps = len(watch.captures)
    scraper = Scraper(eng.status_server.url, ctl).start()
    for n in RETUNE_OVERLAP_LENGTHS:
        if not ctl.async_active():
            novel = torch.as_tensor(rng.integers(0, vocab, n + 4)[None],
                                    device=dev)
            for _ in range(4):
                eng.prefill(0, novel)
            while not ctl.async_active():
                report = ctl.maybe_retune()
                if report is not None:
                    watch.note(report)
                elif not ctl.async_active():
                    raise AssertionError("retune C: novel traffic did not "
                                         "trigger an epoch")
        tokens = torch.as_tensor(rng.integers(0, vocab, n)[None], device=dev)
        caps = eng.prefill_captures
        on_before = ctl.async_active()
        t0 = time.perf_counter()
        eng.prefill(0, tokens)
        stream.synchronize()
        cap_ms = 1e3 * (time.perf_counter() - t0)
        on_after = ctl.async_active()
        tries.append((n, on_before, on_after, round(cap_ms, 1)))
        if eng.prefill_captures != caps + 1:
            raise AssertionError(f"retune C: prefill of {n} tokens was not "
                                 "captured")
        if on_before and on_after:
            overlap = (n, cap_ms)
            break
    if overlap is None:
        raise AssertionError(f"retune C: no capture inside an epoch in "
                             f"flight: {tries}")
    end_async(ctl, watch, poll=True)          # a later poll reaps it
    scraper.stop()
    if scraper.failures:
        raise AssertionError(f"retune C: scrapes failed: "
                             f"{scraper.failures[:5]}")
    caps = watch.captures[n_caps:]
    busy_scrapes = sum(1 for *_, busy in scraper.rows if busy)
    in_capture = sum(1 for a, b, *_ in scraper.rows
                     if any(a < e and s < b for s, e in caps))
    if not busy_scrapes:
        raise AssertionError("retune C: no scrape while an epoch was in "
                             "flight")
    scrape_ms = {r: statistics.median(1e3 * (b - a) for a, b, rr, _
                                      in scraper.rows if rr == r)
                 for r in Scraper.ROUTES}
    async_reports = [r["report"] for r in watch.reports
                     if r["report"].mode == "async" and r["report"].tuned]
    if not async_reports:
        raise AssertionError(f"retune C: no async report surfaced "
                             f"({watch.reports})")
    # after the epochs: a fresh window, then a short serve (its first tick
    # captures the tick graph of the new generation, and is left out)
    ctl.reset_baseline()
    n_after = len(eng.tick_times)
    outs = eng.generate(prompts[:RETUNE_SLOTS], max_new=RETUNE_AFTER_NEW)
    if [len(o) for o in outs] != [RETUNE_AFTER_NEW] * RETUNE_SLOTS:
        raise AssertionError("retune C: a request was not served whole")
    end_async(ctl, watch)                 # an epoch the serve submitted
    ticks = list(eng.tick_times)
    windows = [tuple(w) for w in ctl.async_windows]
    in_flight = lambda t: any(a <= t <= b for a, b in windows)
    busy = [1e3 * w for t, w, _ in ticks[:n_after] if in_flight(t)]
    calm = [1e3 * w for t, w, _ in ticks[n_after + 1:] if not in_flight(t)]
    ratios = []
    for r in eng.tunedb_store.records():
        a = inline.get((r.space, shape_key(r.inputs)))
        if a is not None and r.space == "gemm":
            ratios.append(r.tflops / a.tflops)
    phase("retune", f"C: async, {len(prompts)} requests ({RETUNE_PROMPTS} x "
          f"{RETUNE_PROMPT} and 4 x {RETUNE_ASYNC_PROMPT} tokens) x "
          f"{RETUNE_NEW} tokens in {c_wall:.2f} s, {c_ticks} ticks, "
          f"{ctl.async_submits} epoch(s) submitted, "
          f"{len(async_reports)} async report(s) reaped by a later poll "
          f"(cooldown {RETUNE_COOLDOWN} ticks for the engine's polls; "
          + "; ".join(f"{r.tuned} tuned, wall {r.wall_s:.3f} s = session "
                      f"{r.session_s:.3f} + retrain {r.retrain_s:.3f} + "
                      f"install {r.install_s:.3f}" for r in async_reports)
          + f"; submit to swap "
          f"{[round(b - a, 3) for a, b in ctl.async_windows]} s); "
          f"tick wall while an epoch was in flight: median "
          f"{statistics.median(busy) if busy else float('nan'):.2f} ms, max "
          f"{max(busy) if busy else float('nan'):.2f} ms over {len(busy)} "
          f"ticks; after: median "
          f"{statistics.median(calm) if calm else float('nan'):.2f} ms, max "
          f"{max(calm) if calm else float('nan'):.2f} ms over {len(calm)} "
          f"ticks [{label}]")
    phase("retune", f"C: a {overlap[0]}-token prefill captured in "
          f"{overlap[1]:.1f} ms inside an epoch in flight (tries: length, "
          f"in flight before, after, ms: {tries}); no capture failed; async "
          f"records' GEMM TFLOP/s over part A's at the same shapes: median "
          f"{statistics.median(ratios) if ratios else float('nan'):.3f}, "
          f"min {min(ratios) if ratios else float('nan'):.3f}, max "
          f"{max(ratios) if ratios else float('nan'):.3f} over "
          f"{len(ratios)} shapes")
    epoch_memory(watch, "retune C")
    torch.cuda.synchronize()            # no epoch in flight now
    c_device_ms = replay_ms(eng.graph)
    spans = eng.tracer.spans()
    c_split = tick_split(spans)
    epochs = [sp for sp in spans if sp.name == "retune.epoch"]
    phase("retune", f"C: {len(scraper.rows)} scrapes of /status and "
          f"/metrics from another thread, none failed; {busy_scrapes} with "
          f"an epoch in flight, {in_capture} overlapping one of the "
          f"{len(caps)} captures meanwhile; median ms {scrape_ms}; "
          f"retune.epoch spans {[round(sp.dur, 3) for sp in epochs]} s "
          f"({[sp.attrs.get('outcome') for sp in epochs]}); engine.tick "
          f"split with an epoch in flight "
          f"{split_medians([r for r in c_split if in_flight(r['t0'])])}; "
          f"after the epochs (from the serve's second tick) "
          f"{split_medians([r for r in c_split[n_after + 1:] if not in_flight(r['t0'])])}"
          f"; the tick graph replays alone in {c_device_ms:.3f} ms on the "
          f"device [{label}]")
    out["device_launches"] += watch.device["gemm"]
    out["device_reduce_launches"] += watch.device["reduce"]
    out["stats"] = {"A+B": a_stats, "C": ctl.stats()}
    out["scrapes"] = {"n": len(scraper.rows), "busy": busy_scrapes,
                      "in_capture": in_capture, "ms": scrape_ms}
    out["wall_s"] = time.perf_counter() - t_phase
    phase("retune", f"controller stats A+B: {a_stats['retunes']} swaps over "
          f"{a_stats['checks']} polls in {a_ticks} ticks; C: "
          f"{ctl.stats()['retunes']} swaps over {ctl.stats()['checks']} "
          f"polls; GEMM kernels given to the device (graph nodes x replays) "
          f"{out['device_launches']}, reduction passes "
          f"{out['device_reduce_launches']}; the phase's wall "
          f"{out['wall_s']:.1f} s")
    eng.status_server.stop()
    reset_tracing()
    del eng, watch, ctl
    gc.collect()
    clear_store()
    clear_models()
    clear_telemetry()
    return out


MAMBA_NK = ((8512, 2048), (2048, 4096))
MAMBA_SLOTS, MAMBA_PROMPT = 4, 32
MAMBA_TUNE_SAMPLES = 96
MAMBA_PARITY = (300, 200, 32, 9, 1)
MAMBA_RECUR = (250, 12)
MAMBA_RTOL = MAMBA_ATOL = 5e-2


# -- the fleet phase ----------------------------------------------------------

FLEET_PROMPTS, FLEET_PROMPT, FLEET_NEW = 8, 32, 48   # part A's traffic
FLEET_SWAP_TIMEOUT_S = 120.0       # part A: rounds served until the swap
FLEET_LEASE_TIMEOUT_S = 5.0        # part B's leases
FLEET_B_SHAPES = ((32, 576, 576), (32, 1536, 576))   # part B's two jobs
FLEET_SENTRY = 0.10                # part B's merge gate
FLEET_FOLLOW_INTERVAL = 0.25       # part C's registry polls
FLEET_CHILD_TIMEOUT_S = 120.0      # a child's start, claim or exit


class Child:
    """One process of the fleet or dryrun phase: its command, its output lines as
    they arrive (kept in ``<log>``), its exit.  ``stop`` ends it; a child
    still running when the phase ends fails the phase."""

    ALL: list = []

    def __init__(self, name: str, cmd: list, log: Path):
        self.name, self.cmd = name, cmd
        self.lines: list = []
        self._fh = log.open("w")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONUNBUFFERED="1")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        Child.ALL.append(self)

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            self._fh.write(line)
            self._fh.flush()

    def wait_line(self, pred, what: str,
                  timeout: float = FLEET_CHILD_TIMEOUT_S) -> str:
        """The first output line ``pred`` accepts; fails the phase if the
        child exits or the timeout passes first."""
        deadline = time.perf_counter() + timeout
        seen = 0
        while time.perf_counter() < deadline:
            while seen < len(self.lines):
                if pred(self.lines[seen]):
                    return self.lines[seen]
                seen += 1
            if self.proc.poll() is not None and seen >= len(self.lines):
                time.sleep(0.2)         # the reader's last lines
                if seen >= len(self.lines):
                    break
            time.sleep(0.02)
        raise AssertionError(f"{self.name} gave no {what} "
                             f"(rc {self.proc.poll()}); its output ends "
                             f"{self.lines[-15:]}")

    def wait_exit(self, want_rc: int = 0,
                  timeout: float = FLEET_CHILD_TIMEOUT_S) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{self.name} did not exit in "
                                 f"{timeout:.0f} s")
        self._reader.join(10)
        if want_rc is not None and rc != want_rc:
            raise AssertionError(f"{self.name} exited {rc}; its "
                                 f"output ends {self.lines[-15:]}")
        return rc

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(30)
        self._reader.join(10)

    @classmethod
    def reap(cls) -> list:
        """Kill every child still running; their names."""
        left = [c for c in cls.ALL if c.proc.poll() is None]
        for c in left:
            c.kill()
        cls.ALL = []
        return [c.name for c in left]


def fleet_worker(fleet: Path, tuners: Path, name: str, log: Path,
                 *extra: str) -> Child:
    return Child(name, [sys.executable, "-m", "repro_torch.tunedb", "fleet",
                        "worker", "--fleet", str(fleet), "--load-tuner",
                        str(tuners), *extra], log)


def worker_report(child: Child) -> dict:
    """The worker's last line: claims, outcomes and kernel launches."""
    line = child.wait_line(lambda s: "kernel launches" in s, "report")
    m = re.search(r"worker (\S+): (\d+) claimed, (\d+) tuned, (\d+) failed, "
                  r"(\d+) lost in ([\d.]+)s; kernel launches (\{.*\})", line)
    if m is None:
        raise AssertionError(f"fleet: {child.name}'s report {line!r}")
    return {"worker_id": m.group(1), "claimed": int(m.group(2)),
            "tuned": int(m.group(3)), "failed": int(m.group(4)),
            "lost": int(m.group(5)), "wall_s": float(m.group(6)),
            "launches": json.loads(m.group(7))}


class LeaseWatch:
    """Polls a fleet's ``leases/`` from a thread: the first claim's time
    and, per lease, the longest stretch its mtime stood still (the gap
    between heartbeats, or from the last one to the lease's release)."""

    def __init__(self, fleet: Path, period_s: float = 0.02):
        self.dir = fleet / "leases"
        self.period_s = period_s
        self.first_claim: Optional[float] = None
        self.max_gap_s = 0.0
        self.beats = 0
        self._last: dict = {}           # name -> (mtime, time first seen)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            now = time.time()
            cur = {}
            try:
                for p in self.dir.glob("*.json"):
                    try:
                        cur[p.name] = p.stat().st_mtime
                    except FileNotFoundError:
                        continue
            except FileNotFoundError:
                pass
            if cur and self.first_claim is None:
                self.first_claim = now
            for name, mtime in cur.items():
                prev = self._last.get(name)
                if prev is not None and mtime != prev[0]:
                    self.beats += 1
                    self.max_gap_s = max(self.max_gap_s, mtime - prev[0])
                if prev is None or mtime != prev[0]:
                    self._last[name] = (mtime, now)
            for name in set(self._last) - set(cur):
                mtime, _ = self._last.pop(name)
                self.max_gap_s = max(self.max_gap_s, now - mtime)
            self._stop.wait(self.period_s)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(10)


def fleet_tokens(path: Path) -> list:
    if not path.exists():
        return []
    rows = []
    for line in path.read_text().splitlines():
        try:
            rows.append(json.loads(line))
        except ValueError:
            continue                    # a round being written
    return rows


def phase_fleet(cfg, fp: str, tuners: dict, tune_store: RecordStore,
                dev: torch.device, tmp: Path, label: str) -> dict:
    """The fleet on the card: SmolLM-135M at full width (random weights
    from seed 0, as ``launch.serve`` makes them) serving from an empty
    disk-backed store, its retune epochs tuned by a worker process.

    A: ``fleet worker`` as a process (the tune phase's GEMM and attention
    tuners loaded from disk); the engine serves 8 x 32-token prompts x 48
    tokens, round after round, with ``retune_fleet``, ``retune_publish``,
    telemetry export, the affinity router, tracing and the status
    endpoint, until an epoch's records are merged (merge gate passed),
    swapped in and published, then one round more.  The merged records
    are the worker's, under the engine's fingerprint; the tick graph
    re-captured after the swap plans each tuned shape exact;
    ``collect_fleet_spans`` joins the worker's ``fleet.job`` spans to the
    engine's epoch; ``/status`` has its fleet and router sections and
    ``/metrics`` the fleet and router counters.
    B: two GEMM jobs (``lease_timeout_s=5``) on a second bus whose store
    holds the tune phase's records of the two shapes; the first worker
    process is killed (SIGKILL) once it claims; its lease expires, the
    job is requeued and a second worker tunes both; the merge (the sentry
    gate at 10%) holds one fleet record a shape, none from the killed
    worker.
    C: ``launch.serve --follow R`` in its own process from an empty store,
    started with the phase: it adopts the generation A publishes while it
    serves, its tick graph is captured again, and a round served wholly
    after the adoption gives A's post-swap tokens; its ``/metrics`` has
    ``tunedb_follower_*``.  Then ``fleet route`` over two replica
    registries from ``publish_replica_plans``: the 32-token prefill's
    shapes land on the replica whose plan covers them."""
    from repro_torch.tunedb import fleet as tfleet
    from repro_torch.tunedb.__main__ import main as tunedb_main
    from repro_torch.tunedb.obs import collect_fleet_spans

    t_phase = time.perf_counter()
    root = tmp / "fleet-phase"
    root.mkdir()
    tuner_dir = root / "tuners"
    for t in tuners.values():
        t.save(str(tuner_dir))
    store_path, fleet, reg = root / "a.jsonl", root / "fleet", root / "reg"
    store_path.touch()
    tokens_out = root / "follower.jsonl"
    out = {}
    try:
        # -- C's replica and A's worker start first (their imports and
        # CUDA contexts overlap A's engine) --------------------------------
        follower = Child("follower", [
            sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "smollm-135m", "--follow", str(reg), "--follow-interval",
            str(FLEET_FOLLOW_INTERVAL), "--status-port", "0",
            "--requests", str(FLEET_PROMPTS), "--prompt-len",
            str(FLEET_PROMPT), "--max-new", str(FLEET_NEW), "--slots", "4",
            "--max-len", "256", "--rounds", "0", "--tokens-out",
            str(tokens_out)], root / "follower.log")
        worker_a = fleet_worker(fleet, tuner_dir, "worker A",
                                root / "worker_a.log", "--trace-sample",
                                "1.0")
        victim = fleet_worker(root / "fleet_b", tuner_dir, "worker B1",
                              root / "worker_b1.log", "--worker-id", "b1")
        # -- A -------------------------------------------------------------
        clear_telemetry()
        clear_models()
        install_serving(store=None, models=None, fingerprint=None)
        dispatch.reset_counts()
        reset_launches()
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        params = init_params(cfg, gen)
        eng = Engine(cfg, params, ServeConfig(
            slots=4, max_len=256, tunedb=str(store_path), tunedb_backend=fp,
            retune=True, retune_interval=RETUNE_INTERVAL,
            retune_cooldown_ticks=RETUNE_COOLDOWN, retune_fleet=str(fleet),
            retune_publish=str(reg), telemetry_export_s=0.5,
            router="affinity", trace_sample=1.0, status_port=0,
            record_tick_times=True), device=dev)
        ctl = eng.controller
        per_fwd = GEMMS_PER_LAYER * cfg.n_layers
        watch = RetuneWatch(eng, "fleet A", per_fwd, label="fleet")
        stamps = {}
        real_wait = tfleet.Coordinator.wait
        real_publish = tfleet.Coordinator.publish

        def publish(self, jobs, **kw):
            stamps.setdefault("publish0", time.perf_counter())
            stamps.setdefault("publish0_wall", time.time())
            n = real_publish(self, jobs, **kw)
            stamps.setdefault("publish1", time.perf_counter())
            return n

        def wait(self, **kw):
            stamps.setdefault("wait0", time.perf_counter())
            ok = real_wait(self, **kw)
            stamps.setdefault("wait1", time.perf_counter())
            return ok
        tfleet.Coordinator.publish, tfleet.Coordinator.wait = publish, wait
        lease_watch = LeaseWatch(fleet)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, FLEET_PROMPT)
                   for _ in range(FLEET_PROMPTS)]
        # the follower serves before anything is published: its adoption
        # lands mid-serve
        deadline = time.perf_counter() + FLEET_CHILD_TIMEOUT_S
        while not fleet_tokens(tokens_out):
            if follower.proc.poll() is not None \
                    or time.perf_counter() > deadline:
                raise AssertionError(f"fleet C: the follower served no round "
                                     f"(rc {follower.proc.poll()}): "
                                     f"{follower.lines[-10:]}")
            time.sleep(0.05)
        rounds = []
        deadline = time.perf_counter() + FLEET_SWAP_TIMEOUT_S
        try:
            while True:
                for child in (worker_a, follower, victim):
                    if child.proc.poll() is not None:
                        raise AssertionError(
                            f"fleet: {child.name} exited unasked (rc "
                            f"{child.proc.poll()}): {child.lines[-10:]}")
                t0 = time.perf_counter()
                gen_before = serving_state().generation
                outs = eng.generate(prompts, max_new=FLEET_NEW)
                torch.cuda.current_stream(dev).synchronize()
                rounds.append({"t0": t0, "t1": time.perf_counter(),
                               "gen0": gen_before, "tokens": outs,
                               "gen1": serving_state().generation,
                               "ticks": eng.ticks})
                if [len(o) for o in outs] != [FLEET_NEW] * FLEET_PROMPTS:
                    raise AssertionError("fleet A: a request was not served "
                                         "whole")
                if rounds[-1]["gen0"] == rounds[-1]["gen1"] and any(
                        r["gen1"] > r["gen0"] for r in rounds[:-1]) \
                        and ctl.published_plans:
                    break               # a whole round after the swap
                if time.perf_counter() > deadline:
                    raise AssertionError(
                        f"fleet A: no swap after {len(rounds)} rounds "
                        f"({FLEET_SWAP_TIMEOUT_S:.0f} s); controller "
                        f"{ctl.stats()['async']}, worker output "
                        f"{worker_a.lines[-10:]}")
        finally:
            tfleet.Coordinator.publish = real_publish
            tfleet.Coordinator.wait = real_wait
            lease_watch.stop()
        launches_a = read_launches()
        tuned = watch.tuned_reports()
        if not tuned:
            raise AssertionError(f"fleet A: no epoch tuned ({watch.reports})")
        rep = tuned[0]["report"]
        if rep.mode != "fleet":
            raise AssertionError(f"fleet A: epoch mode {rep.mode}")
        store = eng.tunedb_store
        recs = store.records()
        worker_id = worker_a.wait_line(lambda s: "claiming from" in s,
                                       "start line").split()[2]
        if not recs or any(r.merged_from != worker_id or r.backend != fp
                           or r.source != "retune" for r in recs):
            raise AssertionError(f"fleet A: records "
                                 f"{[(r.merged_from, r.backend, r.source) for r in recs]}")
        report_json = json.loads((fleet / "report.json").read_text())
        done = tfleet.FleetDir(fleet).done_meta()
        # the tick graph of the live generation: replayed, and every shape
        # of it with a record planned exact on its record's config
        last = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 1)),
                               device=dev)
        idx = torch.full((4,), 40, dtype=torch.long, device=dev)
        eng.decode(last, idx)
        n_exact = graph_shapes_exact(eng, eng._decode_shapes, fp,
                                     "fleet A tick")
        # the status endpoint
        code, body, _ = scrape(eng.status_server.url + "/status")
        status = json.loads(body) if code == 200 else {}
        mcode, metrics, _ = scrape(eng.status_server.url + "/metrics")
        if code != 200 or mcode != 200 or status.get("fleet") is None \
                or status.get("router") is None:
            raise AssertionError(f"fleet A: /status {code} (fleet "
                                 f"{status.get('fleet') is not None}, router "
                                 f"{status.get('router') is not None}), "
                                 f"/metrics {mcode}")
        for fam in ("tunedb_fleet_jobs", "tunedb_fleet_merged_records",
                    "tunedb_router_decisions_total",
                    "tunedb_telemetry_dumps_total"):
            if fam not in metrics:
                raise AssertionError(f"fleet A: /metrics lacks {fam}")
        # the worker drains, exports its spans, reports
        tfleet.FleetDir(fleet).request_drain()
        wrep = worker_report(worker_a)
        worker_a.wait_exit()
        if wrep["failed"] or wrep["lost"] or wrep["tuned"] != len(done):
            raise AssertionError(f"fleet A: worker report {wrep}, "
                                 f"{len(done)} done markers")
        spans = eng.tracer.spans()
        epochs = {sp.trace_id for sp in spans if sp.name == "retune.epoch"}
        merges = [sp for sp in spans if sp.name == "fleet.merge"]
        jobs = [sp for sp in collect_fleet_spans(fleet)
                if sp.name == "fleet.job"]
        if not jobs or any(sp.trace_id not in epochs for sp in jobs) \
                or not merges:
            raise AssertionError(f"fleet A: {len(jobs)} fleet.job spans, "
                                 f"their trace ids "
                                 f"{sorted({s.trace_id for s in jobs})}, the "
                                 f"epochs' {sorted(epochs)}, {len(merges)} "
                                 "fleet.merge spans")
        trip = next(i for i, r in enumerate(rounds) if r["gen1"] > r["gen0"])
        ticks = list(eng.tick_times)
        wait0, wait1 = stamps["wait0"], stamps["wait1"]
        waiting = [1e3 * w for t, w, _ in ticks if wait0 <= t < wait1]
        after = [1e3 * w for t, w, _ in ticks if t >= rounds[-1]["t0"]]
        ratio = {}
        for r in recs:
            ref = tune_store.get(r.space, r.inputs, backend=fp)
            if ref is not None:
                ratio[shape_str(r.inputs)] = r.tflops / ref.tflops
        phase("fleet", f"A: {cfg.name} ({cfg.n_layers}L bf16) from an empty "
              f"store, {len(rounds)} rounds of {FLEET_PROMPTS} x "
              f"{FLEET_PROMPT}-token prompts x {FLEET_NEW} tokens; the swap "
              f"in round {trip + 1} (generation {rounds[trip]['gen0']} -> "
              f"{rounds[trip]['gen1']}); jobs published "
              f"{report_json['published']}, claimed {wrep['claimed']}, "
              f"tuned {wrep['tuned']}, failed {wrep['failed']}, lost "
              f"{wrep['lost']}; the worker's wall a job "
              f"{[round(m['wall_s'], 3) for m in done]} s [{label}]")
        rel = lambda key: stamps[key] - stamps["publish0"]
        merge_ms = 1e3 * merges[0].dur
        first_claim = (lease_watch.first_claim - stamps["publish0_wall"]
                       if lease_watch.first_claim else float("nan"))
        phase("fleet", f"A: the epoch: publish {1e3 * rel('publish1'):.1f} "
              f"ms, the first claim {first_claim:.3f} s after it, the wait "
              f"{stamps['wait1'] - stamps['wait0']:.3f} s, fleet.merge "
              f"{merge_ms:.1f} ms, retrain {rep.retrain_s:.3f} s, install "
              f"{rep.install_s:.3f} s, plan publish {1e3 * rep.publish_s:.1f}"
              f" ms; epoch wall {rep.wall_s:.3f} s; {rep.tuned} tuned, "
              f"retrained {rep.retrained}")
        phase("fleet", f"A: ticks during the wait: median "
              f"{statistics.median(waiting) if waiting else float('nan'):.2f}"
              f" ms, max {max(waiting, default=float('nan')):.2f} ms over "
              f"{len(waiting)}; after the swap: median "
              f"{statistics.median(after) if after else float('nan'):.2f} "
              f"ms, max {max(after, default=float('nan')):.2f} ms over "
              f"{len(after)} (the worker, and the follower replica of C, "
              f"share the card) [{label}]")
        phase("fleet", f"A: merged records' TFLOP/s over the tune phase's "
              f"for the same shape {ratio}; refusals: merge gate "
              f"{report_json['sentry_blocked']}, install gate "
              f"{ctl.sentry_blocked}; fingerprints: engine pin {fp}, "
              f"worker records {sorted({r.backend for r in recs})}; the "
              f"longest lease stretch without a heartbeat "
              f"{lease_watch.max_gap_s:.3f} s ({lease_watch.beats} "
              f"heartbeats seen); the worker's kernel launches "
              f"{wrep['launches']}")
        phase("fleet", f"A: the tick graph of generation "
              f"{serving_state().generation}: {n_exact} shapes with records, "
              f"each planned exact; {len(jobs)} fleet.job spans joined to "
              f"the epoch's trace; /status fleet counts "
              f"{status['fleet']['counts']}, router outcomes "
              f"{status['router']['outcomes']}; engine launches "
              f"{launches_a}, GEMM kernels given to the device "
              f"{watch.device}")
        for r in sorted(recs, key=lambda r: (r.space, sorted(r.inputs.items()))):
            phase("fleet", f"  A record {r.space} {shape_str(r.inputs)} -> "
                  f"{r.config} {r.tflops:.3f} TFLOPS (merged from "
                  f"{r.merged_from})")
        out["a"] = {"launches": launches_a, "worker_launches":
                    wrep["launches"], "device": dict(watch.device)}
        a_tokens = rounds[-1]["tokens"]
        # -- C: the follower adopted A's generation --------------------------
        published = json.loads((reg / "CURRENT.json").read_text())
        url = follower.wait_line(lambda s: s.startswith("status endpoint"),
                                 "status endpoint").split()[2]
        deadline = time.perf_counter() + FLEET_CHILD_TIMEOUT_S
        adopted = None
        while adopted is None:
            rows = fleet_tokens(tokens_out)
            adopted = next((r for r in rows if r["follower_generation"]
                            == published["generation"]
                            and r["generation_before"]
                            == r["generation_after"]
                            and any(p["follower_generation"] !=
                                    published["generation"]
                                    for p in rows[:rows.index(r)])), None)
            if adopted is None:
                if follower.proc.poll() is not None \
                        or time.perf_counter() > deadline:
                    raise AssertionError(f"fleet C: the follower never "
                                         f"served a round under generation "
                                         f"{published['generation']} "
                                         f"({len(rows)} rounds; rc "
                                         f"{follower.proc.poll()})")
                time.sleep(0.1)
        fcode, fstatus, _ = scrape(url + "/status")
        fmcode, fmetrics, _ = scrape(url + "/metrics")
        fol = json.loads(fstatus)["follower"] if fcode == 200 else None
        if fol is None or "tunedb_follower_installs_total" not in fmetrics:
            raise AssertionError(f"fleet C: /status {fcode} follower {fol}, "
                                 f"/metrics {fmcode}")
        follower.proc.send_signal(signal.SIGINT)
        follower.wait_exit()
        first_adopted = next(r for r in rows if r["follower_generation"]
                             == published["generation"])
        same = adopted["tokens"] == a_tokens
        phase("fleet", f"C: the follower (its own process, an empty store) "
              f"served {len(rows)} rounds; it adopted generation "
              f"{published['generation']} {fol['lag_s']:.3f} s after its "
              f"publish ({fol['installs']} install(s), refused digest "
              f"{fol['refused_digest']} stale {fol['refused_stale']} sentry "
              f"{fol['refused_sentry']}), in round {first_adopted['round']}; "
              f"its tick graph captured again at tick "
              f"{first_adopted['last_capture_tick']}; round "
              f"{adopted['round']} (wholly after) gives A's post-swap "
              f"tokens: {same}")
        if not same:
            diff = [i for i, (x, y) in enumerate(zip(adopted["tokens"],
                                                      a_tokens)) if x != y]
            raise AssertionError(f"fleet C: the follower's tokens differ "
                                 f"from A's in requests {diff}")
        # fleet route over two replica registries
        coord = tfleet.Coordinator(fleet)
        summary = coord.publish_replica_plans(root / "replicas", 2,
                                              fingerprint=fp)
        pre = eng._prefill_shapes[FLEET_PROMPT]
        gemm_pre = sorted({shape_str(x): x for sp, x in pre
                           if sp == "gemm"}.values(),
                          key=lambda x: sorted(x.items()))
        args = ["fleet", "route", "--registry-root", str(root / "replicas"),
                "--space", "gemm"]
        for x in gemm_pre:
            args += ["--shape", f"M={x['M']},N={x['N']},K={x['K']}"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if tunedb_main(args) != 0:
                raise AssertionError("fleet route failed")
        routed = json.loads(buf.getvalue())
        cover = routed["coverage"]
        if cover[routed["replica"]] != max(cover.values()) \
                or cover[routed["replica"]] <= 0:
            raise AssertionError(f"fleet route: {routed}")
        phase("fleet", f"C: replica plans {[(s['replica'], s['entries']) for s in summary]}; "
              f"fleet route of the {FLEET_PROMPT}-token prefill's "
              f"{len(gemm_pre)} GEMM shapes -> {routed['replica']} "
              f"({routed['outcome']}, coverage {cover})")
        eng.exporter.stop()
        eng.status_server.stop()
        # -- B: a worker killed mid-job ---------------------------------------
        store_b = RecordStore.open(root / "b.jsonl")
        jobs_b = [gemm_input(M, N, K, 16) for M, N, K in FLEET_B_SHAPES]
        for x in jobs_b:
            ref = tune_store.get("gemm", x, backend=fp)
            store_b.add(dataclasses.replace(ref, merged_from=None))
        coord_b = tfleet.Coordinator(root / "fleet_b", store_b,
                                     lease_timeout_s=FLEET_LEASE_TIMEOUT_S,
                                     sentry_margin=FLEET_SENTRY)
        coord_b.publish([tfleet.FleetJob(space="gemm", inputs=x,
                                         count=len(jobs_b) - i)
                         for i, x in enumerate(jobs_b)])
        leases = root / "fleet_b" / "leases"
        deadline = time.perf_counter() + FLEET_CHILD_TIMEOUT_S
        while not list(leases.glob("*.json")):
            if victim.proc.poll() is not None \
                    or time.perf_counter() > deadline:
                raise AssertionError(f"fleet B: worker B1 never claimed "
                                     f"({victim.lines[-10:]})")
            time.sleep(0.01)
        victim.proc.send_signal(signal.SIGKILL)
        t_kill = time.time()
        victim.wait_exit(want_rc=-signal.SIGKILL)
        lease = next(leases.glob("*.json"))
        killed_job = lease.stem
        t_claim = lease.stat().st_mtime
        survivor = fleet_worker(root / "fleet_b", tuner_dir, "worker B2",
                                root / "worker_b2.log", "--worker-id", "b2")
        t_requeue = None
        deadline = time.perf_counter() + FLEET_CHILD_TIMEOUT_S
        while True:
            st = coord_b.poll()
            if st["reclaimed"] and t_requeue is None:
                t_requeue = time.time()
            if coord_b.outstanding() == 0:
                break
            if survivor.proc.poll() is not None \
                    or time.perf_counter() > deadline:
                raise AssertionError(f"fleet B: {coord_b.outstanding()} "
                                     f"jobs outstanding "
                                     f"({survivor.lines[-10:]})")
            time.sleep(0.05)
        coord_b.fleet.request_drain()
        srep = worker_report(survivor)
        survivor.wait_exit()
        coord_b.poll()
        rep_b = coord_b.report()
        shard_lines = {}
        for p in coord_b.fleet.shard_dir().glob("*.jsonl"):
            shard_lines[p.stem] = [TuneRecord.from_json(line) for line in
                                   p.read_text().splitlines() if line]
        served_b = [r for r in shard_lines.get("b2", [])
                    if r.source != "sample"]
        if (t_requeue is None or rep_b.done != 2 or rep_b.failed
                or rep_b.requeued != 1 or shard_lines.get("b1")
                or srep["tuned"] != 2 or srep["failed"]
                or sorted(shape_str(r.inputs) for r in served_b)
                != sorted(shape_str(x) for x in jobs_b)):
            raise AssertionError(f"fleet B: report {rep_b}, survivor "
                                 f"{srep}, shards "
                                 f"{ {k: len(v) for k, v in shard_lines.items()} }")
        fleet_recs = [r for r in RecordStore.open(root / "b.jsonl")
                      .training_records() if r.merged_from is not None
                      and r.source != "sample"]
        if len(fleet_recs) > len(jobs_b):
            raise AssertionError(f"fleet B: {len(fleet_recs)} fleet records "
                                 "merged for 2 jobs")
        phase("fleet", f"B: worker B1 killed (SIGKILL) {t_kill - t_claim:.3f}"
              f" s after it claimed {killed_job}; requeued "
              f"{t_requeue - t_claim:.3f} s after the claim (lease timeout "
              f"{FLEET_LEASE_TIMEOUT_S:.0f} s); worker B2 tuned both "
              f"({srep['claimed']} claims, kernel launches "
              f"{srep['launches']}); the merge gate ({FLEET_SENTRY:.0%}) "
              f"refused {rep_b.sentry_blocked} of the 2 against the tune "
              f"phase's records, merged {rep_b.merged_records} (+ "
              f"{rep_b.merged_samples} samples); B1's shard holds nothing; "
              + "; ".join(f"{shape_str(r.inputs)}: {r.tflops:.3f} TFLOPS vs "
                          f"the tune phase's "
                          f"{tune_store.get('gemm', r.inputs, backend=fp).tflops:.3f}"
                          for r in served_b) + f" [{label}]")
        out["b"] = {"worker_launches": srep["launches"]}
        out["device_launches"] = watch.device["gemm"]
        out["device_reduce_launches"] = watch.device["reduce"]
    finally:
        left = Child.reap()
        install_serving(store=None, models=None, fingerprint=None)
        reset_tracing()
    if left:
        raise AssertionError(f"fleet: processes left running: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    phase("fleet", f"the phase's wall {out['wall_s']:.1f} s")
    return out


# -- the chaos phase ----------------------------------------------------------

CHAOS_SEED = 11
CHAOS_WORKERS = 3
CHAOS_LEASE_TIMEOUT_S = 5.0        # well above a job (0.7-2.4 s on an H100)
CHAOS_MAX_ATTEMPTS = 10            # as the reference test's recovery
CHAOS_HEARTBEAT_S = 0.5
CHAOS_RECOVER_S = 90.0             # part A's recovery deadline
CHAOS_PROMPTS, CHAOS_PROMPT, CHAOS_NEW = 8, 32, 16
CHAOS_SHIM = ("probe", "read_text", "read_bytes", "write_text",
              "write_bytes", "file_write", "replace", "rename", "fsync",
              "utime", "unlink")


def chaos_tuners(tuner_dir: Path, dev: torch.device) -> dict:
    """One worker's own tuners, loaded from disk as ``fleet worker
    --load-tuner`` loads them, each with a gated timing backend of its
    own: no two workers share a tuner or a backend."""
    from repro_torch.core.space import SPACES
    return {name: InputAwareTuner.load(
        str(tuner_dir), SPACES[name],
        backend=CheckedBackend(CudaEventBackend(device=dev)))
        for name in ("gemm", "attention")}


def retries_by_site() -> dict:
    """``tunedb_io_retries_total`` summed by call site."""
    out: dict = {}
    for s in get_registry().counter("tunedb_io_retries_total").samples():
        site = dict(s.labels)["site"]
        out[site] = out.get(site, 0) + int(s.value)
    return out


def fsck(*args: str) -> tuple:
    """``tunedb fsck`` in this process: (exit code, its output lines)."""
    from repro_torch.tunedb.__main__ import main as tunedb_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the repair's reload warns
        rc = tunedb_main(["fsck", *args])
    return rc, buf.getvalue().splitlines()


def phase_chaos(cfg, params, fp: str, tuners: dict, dev: torch.device,
                tmp: Path, serve_tick_ms: float, label: str) -> dict:
    """Crash safety on the card: the fleet tunes SmolLM-135M's shapes under
    a seeded fault plan, a merge dies mid-append and is repaired, and the
    engine serves from the repaired store.

    A: a ``Coordinator`` over an empty disk store (``lease_timeout_s=5``)
    publishes the 8 projection GEMM shapes (M = 4 and 32) and the decode
    attention shape; 3 in-process ``Worker`` threads, each with its own
    copies of the tune phase's tuners loaded from disk, tune them on the
    card under ``FaultPlan(seed=11)`` with the reference test's rules
    (``worker.*`` kill p 0.15 max 2, ``lease.*`` EIO p 0.10 max 6,
    ``store.append`` torn write p 0.05 max 1); a thread whose worker dies
    starts a new one (a new id), still armed, until one ends idle.
    Disarmed, expired leases are requeued and sweep workers run until the
    queue and the leases are empty: every job done or failed exactly
    once, every done job's record merged.  No shim site runs inside a capture: the workers' timings
    capture under ``DEVICE_LOCK`` and no engine exists yet.
    B: two GEMM jobs on a fresh bus, tuned; one ``poll`` with a torn
    ``store.append`` (p 1, max 1) dies with ``KillPoint``; the store
    reopened warns, keeps every complete line and quarantines the
    fragment; ``fsck --fleet`` reports (1), repairs (0) and then passes
    clean (0); a restarted coordinator merges the shard again from its
    unmoved cursor.
    C: ``Engine(ServeConfig(slots=4, max_len=256, tunedb=<repaired
    store>))`` serves 8 x 32-token prompts x 16 tokens from its graphs:
    every resolution a plan hit on an entry compiled from its exact
    record, graphed tokens equal to eager, and 0 shim calls in the graph
    round with every ``FaultyIO`` method a counting trap."""
    from repro_torch.tunedb import chaos
    from repro_torch.tunedb import fleet as tfleet
    from repro_torch.tunedb.chaos import FaultPlan, FaultRule, KillPoint

    t_phase = time.perf_counter()
    root = tmp / "chaos-phase"
    root.mkdir()
    tuner_dir = root / "tuners"
    for t in tuners.values():
        t.save(str(tuner_dir))
    store_path = root / "chaos.jsonl"
    out: dict = {}
    # -- A: the lease protocol under faults --------------------------------
    coord = tfleet.Coordinator(root / "fleet_a", RecordStore(store_path),
                               lease_timeout_s=CHAOS_LEASE_TIMEOUT_S,
                               max_attempts=CHAOS_MAX_ATTEMPTS)
    shapes = [("gemm", gemm_input(M, N, K, 16)) for M in SLICE_M
              for (N, K) in SLICE_NK] + [("attention", ATTN_TARGETS[0][1])]
    jobs = [tfleet.FleetJob(space=sp, inputs=x) for sp, x in shapes]
    if coord.publish(jobs) != len(jobs):
        raise AssertionError("chaos A: publish")
    own = [chaos_tuners(tuner_dir, dev) for _ in range(CHAOS_WORKERS)]
    retries0 = retries_by_site()
    reset_launches()
    died: dict = {}
    reports: dict = {}

    def run_slot(slot: int, wtuners: dict) -> None:
        """One worker slot: a worker that dies is replaced (a new id, as a
        supervisor starts a new process), still armed, until one ends
        idle: the queue is empty and the dead workers' leases wait for
        expiry."""
        for n in itertools.count():
            wid = f"w{slot}.{n}"
            w = tfleet.Worker(root / "fleet_a", worker_id=wid,
                              tuners=wtuners, poll_s=0.01,
                              heartbeat_s=CHAOS_HEARTBEAT_S)
            try:
                reports[wid] = w.run(idle_timeout_s=1.0)
                return
            except KillPoint as e:
                died[wid] = f"killed at {e.site}"
            except OSError as e:        # a lease write past its retries
                died[wid] = f"{type(e).__name__} errno {e.errno}"

    plan = FaultPlan(seed=CHAOS_SEED, rules=[
        FaultRule(site="worker.*", kind="kill", p=0.15, max_count=2),
        FaultRule(site="lease.*", kind="errno", p=0.10, errno=errno.EIO,
                  max_count=6),
        FaultRule(site="store.append", kind="torn_write", p=0.05,
                  max_count=1)])
    t0 = time.perf_counter()
    with chaos.armed(plan) as shim:
        threads = [threading.Thread(target=run_slot, args=(i, t))
                   for i, t in enumerate(own)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("chaos A: a worker thread did not end")
    t_armed = time.perf_counter() - t0
    report = shim.report()
    if shim.calls <= 0:
        raise AssertionError("chaos A: the plan saw no shim call")
    # faults off: requeue expired leases, sweep until nothing is left
    requeued, sweeps = [], 0
    deadline = time.perf_counter() + CHAOS_RECOVER_S
    while True:
        requeued += coord.fleet.reclaim_expired(
            lease_timeout_s=CHAOS_LEASE_TIMEOUT_S,
            max_attempts=CHAOS_MAX_ATTEMPTS)
        c = coord.fleet.counts()
        if c["queue"] == 0 and c["leases"] == 0:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"chaos A: not recovered: {c}")
        if c["queue"]:
            sweeps += 1
            tfleet.Worker(root / "fleet_a", worker_id=f"sweep{sweeps}",
                          tuners=own[0], poll_s=0.01,
                          heartbeat_s=CHAOS_HEARTBEAT_S).run(
                idle_timeout_s=0.2)
        else:
            time.sleep(0.25)            # a dead worker's lease expiring
    t_recover = time.perf_counter() - t0 - t_armed
    done = {p.stem for p in coord.fleet.done.glob("*.json")}
    failed = {p.stem for p in coord.fleet.failed.glob("*.json")}
    if done | failed != {j.job_id for j in jobs} or done & failed:
        raise AssertionError(f"chaos A: done {sorted(done)}, failed "
                             f"{sorted(failed)}")
    coord.poll()
    store = coord.store
    for j in jobs:
        rec = store.get(j.space, j.inputs, backend=fp)
        if j.job_id in done and (rec is None or not rec.merged_from
                                 or rec.source != "fleet"):
            raise AssertionError(f"chaos A: no merged record for "
                                 f"{j.space} {shape_str(j.inputs)}: {rec}")
    retries = {k: v - retries0.get(k, 0) for k, v in retries_by_site().items()
               if v - retries0.get(k, 0)}
    finished = sorted(reports.items())
    phase("chaos", f"A: {len(jobs)} jobs (8 GEMM, the decode attention "
          f"shape), {CHAOS_WORKERS} worker threads under FaultPlan(seed="
          f"{CHAOS_SEED}) for {t_armed:.2f} s: {report['calls']} shim "
          f"calls, injected {report['by_kind']}, by site {report['by_site']};"
          f" workers died {died or 'none'}, finished "
          f"{ {w: (r.claimed, r.tuned, r.failed) for w, r in finished} }"
          f" (claimed, tuned, failed); retried by site {retries}; recovery "
          f"{t_recover:.2f} s: {len(requeued)} leases requeued on expiry, "
          f"{sweeps} sweep workers; jobs done {len(done)}, failed "
          f"{len(failed)}, each exactly once; the merge holds a fleet "
          f"record for every done job [{label}]")
    out["a"] = {"report": report, "retries": retries, "died": died,
                "done": len(done), "failed": len(failed),
                "requeued": len(requeued), "armed_s": t_armed,
                "recover_s": t_recover}
    # -- B: a crash in the middle of a merge -------------------------------
    t0 = time.perf_counter()
    fleet_b = root / "fleet_b"
    coord_b = tfleet.Coordinator(fleet_b, RecordStore.open(store_path),
                                 lease_timeout_s=CHAOS_LEASE_TIMEOUT_S,
                                 max_attempts=CHAOS_MAX_ATTEMPTS)
    jobs_b = [tfleet.FleetJob(space="gemm", inputs=gemm_input(M, N, K, 16))
              for M, N, K in FLEET_B_SHAPES]
    coord_b.publish(jobs_b)
    rep_b = tfleet.Worker(fleet_b, worker_id="b", tuners=own[1],
                          poll_s=0.01).run(idle_timeout_s=0.0)
    if rep_b.tuned != len(jobs_b):
        raise AssertionError(f"chaos B: worker {rep_b}")
    lines_before = store_path.read_text().count("\n")
    torn = FaultPlan(seed=CHAOS_SEED, rules=[
        FaultRule(site="store.append", kind="torn_write", p=1.0,
                  max_count=1)])
    with chaos.armed(torn):
        try:
            coord_b.poll()
        except KillPoint as e:
            killed_at = e.site
        else:
            raise AssertionError("chaos B: the torn merge did not raise")
    raw = store_path.read_text()
    fragment = raw[raw.rfind("\n") + 1:]
    if raw.count("\n") != lines_before or not fragment.strip():
        raise AssertionError(f"chaos B: {raw.count(chr(10))} lines after "
                             f"the torn merge ({lines_before} before), "
                             f"fragment {len(fragment)} chars")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reopened = RecordStore.open(store_path)
    qfiles = sorted(reopened.quarantine_dir().glob("*-load.jsonl"))
    if not (any("quarantined" in str(w.message) for w in caught)
            and reopened.n_lines == lines_before
            and reopened.n_skipped == 1 and len(qfiles) == 1
            and qfiles[0].read_text() == fragment.strip() + "\n"):
        raise AssertionError(f"chaos B: reopened {reopened.n_lines} lines "
                             f"({lines_before} complete), "
                             f"{reopened.n_skipped} skipped, quarantine "
                             f"{[p.name for p in qfiles]}, warnings "
                             f"{[str(w.message) for w in caught]}")
    args = [str(store_path), "--fleet", str(fleet_b)]
    rcs, found = [], []
    for extra in ([], ["--repair"], []):
        rc, lines = fsck(*args, *extra)
        rcs.append(rc)
        found.append([ln.replace(f"{root}/", "") for ln in lines
                      if "verdict" in ln or "bad (" in ln
                      or "orphan(s)," in ln])
    if rcs != [1, 0, 0]:
        raise AssertionError(f"chaos B: fsck exit codes {rcs}: {found}")
    again = tfleet.Coordinator(fleet_b)     # a restarted coordinator
    merged = again.poll()["merged_now"]
    final = RecordStore.open(store_path)
    for j in jobs_b:
        rec = final.get("gemm", j.inputs, backend=fp)
        if rec is None or rec.merged_from != "b":
            raise AssertionError(f"chaos B: {shape_str(j.inputs)} after the "
                                 f"second merge: {rec}")
    t_b = time.perf_counter() - t0
    phase("chaos", f"B: 2 GEMM jobs tuned on a fresh bus; a poll with a "
          f"torn store.append died at {killed_at} leaving a "
          f"{len(fragment)}-char fragment after {lines_before} complete "
          f"lines; reopened: warned, {reopened.n_lines} lines kept, the "
          f"fragment quarantined ({qfiles[0].name}); fsck --fleet exit "
          f"codes {rcs} (plain, --repair, plain): "
          + " | ".join("; ".join(f) for f in found)
          + f"; a restarted coordinator merged {merged} records again from "
          f"the unmoved cursor, both shapes served from worker b's; "
          f"{t_b:.2f} s")
    worker_launches = read_launches()
    if not (worker_launches["gemm"] and worker_launches["gemm_reduce"]
            and worker_launches["attention"]):
        raise AssertionError(f"chaos workers' launches {worker_launches}")
    del own
    # -- C: serving from the repaired store --------------------------------
    clear_telemetry()
    clear_models()
    install_serving(store=None, models=None, fingerprint=None)
    dispatch.reset_counts()
    reset_launches()
    eng = Engine(cfg, params, ServeConfig(
        slots=4, max_len=256, tunedb=str(store_path), tunedb_backend=fp,
        record_tick_times=True), device=dev)
    plan_c = serving_state().plan
    per_fwd = GEMMS_PER_LAYER * cfg.n_layers
    st = eng.tunedb_store
    red = {M: cfg.n_layers * sum(n * splits(st, fp, M, N, K)
                                 for (N, K), n in SLICE_NK.items())
           for M in SLICE_M}
    run = functools.partial(serve_run, eng, per_fwd=per_fwd,
                            red_pre=red[32], red_tick=red[4],
                            attn_per_tick=cfg.n_layers)
    rng = np.random.default_rng(11)
    warm = [rng.integers(0, cfg.vocab, CHAOS_PROMPT) for _ in range(2)]
    prompts = [rng.integers(0, cfg.vocab, CHAOS_PROMPT)
               for _ in range(CHAOS_PROMPTS)]
    w = run("chaos C warm-up", warm, 2)
    if (w["captures"], w["prefill_captures"]) != (1, 1):
        raise AssertionError(f"chaos C: warm-up captured {w['captures']} "
                             f"ticks, {w['prefill_captures']} prefills")
    shim_calls = collections.Counter()
    saved = {m: getattr(chaos.FaultyIO, m) for m in CHAOS_SHIM}

    def trap(name):
        def counted(self, *a, **kw):
            shim_calls[name] += 1
            return saved[name](self, *a, **kw)
        return counted

    for m in CHAOS_SHIM:
        setattr(chaos.FaultyIO, m, trap(m))
    try:
        if chaos._IO is not None:
            raise AssertionError("chaos C: the shim is armed")
        g = run("chaos C graph", prompts, CHAOS_NEW)
    finally:
        for m, fn in saved.items():
            setattr(chaos.FaultyIO, m, fn)
    if sum(shim_calls.values()):
        raise AssertionError(f"chaos C: {dict(shim_calls)} shim calls "
                             "while disarmed")
    if g["captures"] or g["prefill_captures"] or g["launches"]:
        raise AssertionError(f"chaos C: the graph run captured or launched "
                             f"from the host ({g['launches']})")
    tick_gemm, tick_reduce, _ = graph_counts(eng.graph)
    pre_gemm, pre_reduce, _ = graph_counts(eng.prefill_graphs[CHAOS_PROMPT])
    g["device_launches"] = tick_gemm * g["replays"] + pre_gemm * g["prefills"]
    g["device_reduce_launches"] = (tick_reduce * g["replays"]
                                   + pre_reduce * g["prefills"])
    if g["device_launches"] != per_fwd * (g["prefills"] + g["replays"]):
        raise AssertionError(f"chaos C: {g['device_launches']} GEMM kernels "
                             f"given to the device")
    counts = read_launches()
    eng.prefill, eng.decode = eng.prefill_eager, eng.decode_eager
    try:
        e = run("chaos C eager", prompts, CHAOS_NEW)
    finally:
        eng.prefill, eng.decode = eng.prefill_graph, eng.decode_graph
    if e["outs"] != g["outs"]:
        raise AssertionError("chaos C: graphed tokens differ from eager")
    check_plan_exact(plan_c, st, fp, g["shapes"], "chaos C")
    unserved = {(sp, shape_key(x)) for sp, x in shapes} - set(g["shapes"])
    if unserved:
        raise AssertionError(f"chaos C: tuned shapes not served {unserved}")
    if not (counts["gemm"] and counts["gemm_reduce"]):
        raise AssertionError(f"chaos C: engine launches {counts}")
    phase("chaos", f"C: {cfg.name} ({cfg.n_layers}L d={cfg.d_model} bf16) "
          f"from the repaired store ({len(st)} served records): "
          f"{CHAOS_PROMPTS} x {CHAOS_PROMPT}-token prompts x {CHAOS_NEW} "
          f"tokens from the graphs, every resolution a plan hit on an "
          f"exact record ({len(g['shapes'])} shapes), "
          f"{g['device_launches']} GEMM kernels and "
          f"{g['device_reduce_launches']} reduction passes given to the "
          f"device, graphed tokens = eager tokens; 0 shim calls over the "
          f"graph round (every FaultyIO method a counting trap, disarmed); "
          f"median tick {g['tick_ms']:.2f} ms (the serve phase's "
          f"{serve_tick_ms:.2f} ms), {g['tok_s']:.1f} tok/s; launches: the "
          f"workers {worker_launches}, the engine {counts} [{label}]")
    install_serving(store=None, models=None, fingerprint=None)
    out.update(counts=counts, worker_launches=worker_launches,
               device_launches=g["device_launches"],
               device_reduce_launches=g["device_reduce_launches"],
               tick_ms=g["tick_ms"], tok_s=g["tok_s"])
    out["wall_s"] = time.perf_counter() - t_phase
    phase("chaos", f"the phase's wall {out['wall_s']:.1f} s")
    return out


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_mamba(backend, store: RecordStore, store_path: Path, fp: str,
                dev: torch.device, peaks: dict, label: str) -> dict:
    """mamba2-1.3b at full width (48 layers, bf16, random weights from seed
    0) served through ``Engine.generate``, its recurrent cache through the
    engine's CUDA graphs.

    Its 4 projection GEMMs are tuned into the store first, so every serve
    resolution is a plan hit on its exact record.  A warm-up run captures
    the tick and the 32-token prefill; the graph run (every prefill and
    tick replayed) must launch no GEMM from the host and give the device
    96 x (prefills + replays) GEMM kernels, read from each graph's kernel
    nodes times its replays, and one reduction pass per projection whose
    tuned config splits K; the telemetry counts the same GEMM calls and no
    split-count lookup (no attention); the eager run of the same requests
    gives the same greedy tokens.  Then: graph against eager prefill at
    :data:`MAMBA_PARITY` (logits bitwise, the slot's conv and SSM state
    the single-slot cache's and the eager prefill's); prefill of n + k
    tokens against prefill of n and k decode steps (:data:`MAMBA_RECUR`);
    the SSD kernel under the mamba2 target's tuned record against
    ``ssd_chunked`` on layer 0's scan inputs of the 300-token prompt (not
    on the path: the reference's mixer calls ``ssd_chunked``); the
    replayed tick's device time against its byte bound."""
    t_phase = time.perf_counter()
    cfg = get_config("mamba2-1.3b")
    bf16, vocab = torch.bfloat16, cfg.vocab
    targets = [gemm_input(M, N, K, 16) for M in (MAMBA_SLOTS, MAMBA_PROMPT)
               for N, K in MAMBA_NK]
    t0 = time.perf_counter()
    tune_space(GEMM_SPACE, targets, ("M",), backend, store,
               samples=MAMBA_TUNE_SAMPLES)
    tune_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    eng = Engine(cfg, params, ServeConfig(
        max_len=256, slots=MAMBA_SLOTS, tunedb=str(store_path),
        tunedb_backend=fp, tunedb_models="", record_tick_times=True))
    plan = serving_state().plan
    per_fwd = len(MAMBA_NK) * cfg.n_layers           # 96 GEMMs a forward
    red = {M: cfg.n_layers * sum(splits(store, fp, M, N, K)
                                 for N, K in MAMBA_NK)
           for M in (MAMBA_SLOTS, MAMBA_PROMPT)}
    run = functools.partial(serve_run, eng, per_fwd=per_fwd,
                            red_pre=red[MAMBA_PROMPT],
                            red_tick=red[MAMBA_SLOTS], attn_per_tick=0)
    rng = np.random.default_rng(0)
    warm = [rng.integers(0, vocab, MAMBA_PROMPT) for _ in range(2)]
    prompts = [rng.integers(0, vocab, MAMBA_PROMPT) for _ in range(8)]

    reset_launches()
    w = run("mamba warm-up", warm, 2)
    if (w["captures"], w["prefill_captures"]) != (1, 1):
        raise AssertionError(f"mamba warm-up: {w['captures']} tick and "
                             f"{w['prefill_captures']} prefill captures")
    g = run("mamba graph", prompts, 16)
    if g["captures"] or g["prefill_captures"] or g["launches"]:
        raise AssertionError(f"mamba graph run: {g['captures']} tick and "
                             f"{g['prefill_captures']} prefill captures, "
                             f"{g['launches']} GEMM launches from the host")
    # the main path's wrapper launches: the warm-up's captures and their
    # warm-ups (the graph run replays)
    counts = read_launches()
    if not counts["gemm"]:
        raise AssertionError(f"mamba serve path launches {counts}")
    tick_gemm, tick_reduce, tick_nodes = graph_counts(eng.graph)
    if sorted(eng.prefill_graphs) != [MAMBA_PROMPT]:
        raise AssertionError(f"mamba prefill graphs of lengths "
                             f"{sorted(eng.prefill_graphs)}")
    pre_gemm, pre_reduce, pre_nodes = graph_counts(
        eng.prefill_graphs[MAMBA_PROMPT])
    if ((tick_gemm, tick_reduce) != (per_fwd, red[MAMBA_SLOTS])
            or (pre_gemm, pre_reduce) != (per_fwd, red[MAMBA_PROMPT])):
        raise AssertionError(f"mamba tick graph: {tick_gemm} GEMM and "
                             f"{tick_reduce} reduction nodes of {tick_nodes}; "
                             f"prefill graph {pre_gemm} and {pre_reduce} of "
                             f"{pre_nodes}; want {per_fwd} and "
                             f"{red[MAMBA_SLOTS]}, {per_fwd} and "
                             f"{red[MAMBA_PROMPT]}")
    device = tick_gemm * g["replays"] + pre_gemm * g["prefills"]
    device_reduce = tick_reduce * g["replays"] + pre_reduce * g["prefills"]
    if (device != per_fwd * (g["prefills"] + g["replays"])
            or g["telemetry"]["gemm"] != device):
        raise AssertionError(f"mamba graph run: {device} GEMM kernels given "
                             f"to the device, telemetry "
                             f"{g['telemetry']['gemm']}, want {per_fwd} x "
                             f"({g['prefills']} + {g['replays']})")
    check_plan_exact(plan, eng.tunedb_store, fp, g["shapes"], "mamba serve")
    reset_launches()
    eng.prefill, eng.decode = eng.prefill_eager, eng.decode_eager
    try:
        e = run("mamba eager", prompts, 16)
    finally:
        eng.prefill, eng.decode = eng.prefill_graph, eng.decode_graph
    eager_counts = read_launches()
    if e["outs"] != g["outs"] or e["shapes"] != g["shapes"]:
        raise AssertionError("mamba: the graphs' greedy tokens or per-shape "
                             "telemetry differ from the eager run's")
    phase("mamba", f"{cfg.name} ({cfg.n_layers}L d={cfg.d_model} bf16): GEMM "
          f"tune of {len(targets)} shapes ({MAMBA_TUNE_SAMPLES} samples) "
          f"{tune_s:.1f} s; {len(prompts)} requests x 16 tokens, "
          f"ServeConfig(max_len=256, slots={MAMBA_SLOTS}); warm-up "
          f"{w['launches']} GEMM launches from the host (captures and "
          f"their warm-ups, all plan hits); graph run: {g['prefills']} "
          f"prefills + {g['replays']} tick replays, {g['launches']} GEMM "
          f"launches from the host, {device} GEMM kernels and "
          f"{device_reduce} reduction passes given to the device ({per_fwd} "
          f"x (prefills + replays); tick graph {tick_gemm} GEMM + "
          f"{tick_reduce} reduction of {tick_nodes} kernel nodes, prefill "
          f"graph {pre_gemm} + {pre_reduce} of {pre_nodes}), telemetry "
          f"{g['telemetry']}; every served shape its tuned record (tier "
          f"exact); graph {g['tok_s']:.1f} tok/s, median tick "
          f"{g['tick_ms']:.2f} ms; eager {e['tok_s']:.1f} tok/s, median "
          f"tick {e['tick_ms']:.2f} ms ({e['launches']} GEMM launches); "
          f"greedy tokens equal; launches {counts}, eager {eager_counts} "
          f"[{label}]")

    # the 32-token prefill, graph replay (with the merge) against eager
    tokens = torch.as_tensor(prompts[0][None], device=dev)
    pre_ms = {what: median_ms(lambda: fn(1, tokens), 5)
              for what, fn in (("graph", eng.prefill_graph),
                               ("eager", eng.prefill_eager))}

    state = eng.cache["pos0"]["mamba"]
    for n in MAMBA_PARITY:
        tokens = torch.as_tensor(rng.integers(0, vocab, n)[None], device=dev)
        graph = eng.prefill_graph(0, tokens)[:, :vocab].clone()
        slot = {k: v[:, 0].clone() for k, v in state.items()}
        single = eng._single["pos0"]["mamba"]
        to_single = all(torch.equal(slot[k], single[k][:, 0]) for k in slot)
        eager = eng.prefill_eager(0, tokens)[:, :vocab]
        to_eager = all(torch.equal(slot[k], state[k][:, 0]) for k in slot)
        torch.cuda.synchronize()
        tok = (int(graph.argmax()), int(eager.argmax()))
        if not (torch.equal(graph, eager) and tok[0] == tok[1] and to_single
                and to_eager and torch.isfinite(graph).all()):
            raise AssertionError(
                f"mamba prefill parity at n={n}: logits max abs diff "
                f"{float((graph - eager).abs().max()):.3e}, tokens {tok}, "
                f"slot state = single-slot cache {to_single}, = eager "
                f"{to_eager}")
    phase("mamba", f"prefill parity at {list(MAMBA_PARITY)}: graph vs eager "
          f"logits bitwise equal, the same greedy token, the slot's conv "
          f"and SSM state equal to the single-slot cache's and the eager "
          f"prefill's; 32-token prefill {pre_ms['graph']:.3f} ms as a "
          f"graph replay with the merge, {pre_ms['eager']:.3f} ms eager "
          f"(median of 5) [{label}]")

    n, k = MAMBA_RECUR
    toks = torch.as_tensor(rng.integers(0, vocab, (1, n + k)), device=dev)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), params)   # the same weights
    recur = {}
    for c, p in ((cfg32, params32), (cfg, params)):
        full = prefill(p, c, {"tokens": toks},
                       init_cache(c, 1, 1, dev))[0][:, :vocab]
        cache = init_cache(c, 1, 1, dev)
        prefill(p, c, {"tokens": toks[:, :n]}, cache)
        for j in range(k):
            step = decode_step(p, c, toks[:, n + j:n + j + 1], cache,
                               n + j)[0][:, :vocab]
        err = (step - full).abs()
        recur[c.dtype] = {
            "max": float(err.max()), "tokens": (int(step.argmax()),
                                                int(full.argmax())),
            "excess": float((err - MAMBA_ATOL
                             - MAMBA_RTOL * full.abs()).max()),
            "finite": bool(torch.isfinite(step).all())}
    del params32
    r32, r16 = recur[torch.float32], recur[bf16]
    if r32["excess"] > 0 or not (r32["finite"] and r16["finite"]):
        raise AssertionError(f"mamba recurrence: prefill {n} + {k} decode "
                             f"steps vs prefill {n + k}: {recur}")
    phase("mamba", f"prefill {n} + {k} decode steps vs prefill {n + k} "
          f"(across the chunk boundary at {cfg.ssd_chunk}), the full-width "
          f"weights in fp32: last logits max abs diff {r32['max']:.3e}, "
          f"within rtol = atol = {MAMBA_RTOL}, greedy tokens "
          f"{r32['tokens']}; in bf16 (printed, not held: the two forms' "
          f"bf16 roundings part with depth) {r16['max']:.3e}, tokens "
          f"{r16['tokens']}")

    # the SSD kernel against the path's ssd_chunked on layer 0's inputs
    n = MAMBA_PARITY[0]
    toks = torch.as_tensor(rng.integers(0, vocab, (1, n)), device=dev)
    layer = params["layers"]["pos0"]
    h = rms_norm(params["embed"][toks], layer["norm1"][0], cfg.norm_eps)
    _, xh, dt, a, bm, cm, _ = mssm.mamba_inputs(
        {k: v[0] for k, v in layer["mamba"].items()}, h,
        state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
    # contiguous, and dt in the kernel's IO dtype, for both
    args = (xh.contiguous(), dt.to(bf16), a, bm.contiguous(),
            cm.contiguous())
    rec = store.get("ssd", SSD_TARGETS[0][1], backend=fp).config
    got = ops.ssd_scan(*args, rec)
    want = mssm.ssd_chunked(*args, chunk=cfg.ssd_chunk)
    torch.cuda.synchronize()
    ea, er = rel_err(got, want)
    if not (er <= TOL[bf16] and torch.isfinite(got).all()):
        raise AssertionError(f"mamba: ops.ssd_scan under {rec} vs "
                             f"ssd_chunked at L={n}: rel err {er:.3e}")
    ssd_ms = time_ms(lambda i: ops.ssd_scan(*args, rec), 10)
    chunked_ms = time_ms(
        lambda i: mssm.ssd_chunked(*args, chunk=cfg.ssd_chunk), 10)
    phase("mamba", f"ops.ssd_scan (the SSD kernel under the {SSD_TARGETS[0][0]} "
          f"record {rec}) vs models/ssm.py ssd_chunked at (B=1, L={n}, "
          f"H={xh.shape[2]}, P={xh.shape[3]}, S={bm.shape[2]}) on layer "
          f"0's inputs: max abs err {ea:.3e}, rel err {er:.3e} (tolerance "
          f"{TOL[bf16]}); {ssd_ms:.4f} ms against {chunked_ms:.4f} ms "
          f"[{label}]")

    # the replayed tick's device time against its bound: every parameter
    # read once (the head reads the whole embedding), the cache read and
    # written once
    tick_dev = replay_ms(eng.graph)
    gemm_elems = sum(v.numel() for v in (
        layer["mamba"]["w_in"], layer["mamba"]["w_out"], params["embed"]))
    tb = bound(nbytes(tree_leaves(params))
               + 2 * nbytes(tree_leaves(eng.cache)),
               2.0 * MAMBA_SLOTS * gemm_elems, bf16, peaks)
    wall = time.perf_counter() - t_phase
    phase("mamba", f"replayed tick ({MAMBA_SLOTS} slots, {cfg.n_layers} "
          f"layers): device {tick_dev:.3f} ms (median of 20), bound "
          f"{tb['bound_ms']:.3f} ms ({tb['bound_by']}: parameters "
          f"{nbytes(tree_leaves(params)) / 1e9:.3f} GB read, cache "
          f"{nbytes(tree_leaves(eng.cache)) / 1e9:.3f} GB read and "
          f"written), {tb['bound_ms'] / tick_dev:.1%} of the bound; "
          f"the tick graph holds {tick_nodes} kernel nodes ({tick_gemm} "
          f"GEMM, {tick_reduce} reduction); phase wall {wall:.1f} s "
          f"[{label}]")
    return {"counts": counts, "device_launches": device,
            "device_reduce_launches": device_reduce, "tok_s": g["tok_s"],
            "tick_ms": g["tick_ms"], "tick_device_ms": tick_dev,
            "tick_bound_ms": tb["bound_ms"], "wall_s": wall}


# the MoE phase: dbrx-132b at its full width with its depth cut to
# MOE_LAYERS of 40 (40 layers need about 265 GB in bf16, 8 about 53.4 GB);
# its attention projections as (N, K), q and o (6144 -> 6144) and k and v
# (6144 -> 1024), two of each a layer, tuned at the tick's M (4 slots) and
# the prompts' (32 tokens), and its decode attention shape (the split-count
# lookup); the prefill parity lengths (falling; 1 takes the decode path);
# the two MoE paths' tolerance, fp32, the reference's tests/test_moe.py's,
# at a capacity factor that drops nothing
MOE_LAYERS = 8
MOE_NK = ((6144, 6144), (1024, 6144))
MOE_SLOTS, MOE_PROMPT, MOE_MAX_LEN = 4, 32, 256
MOE_TUNE_SAMPLES = 96
MOE_ATTN_SAMPLES = 48
MOE_PARITY = (100, 32, 9, 1)
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5
MOE_NO_DROP_CF = 8.0
MOE_TOP_NAMES = 8                  # the tick's kernels printed by name
# kernel events a traced round of the MoE tick may lose: the profiler
# drops events of a round's first replay, from its first nodes on, on a
# graph of plain PyTorch ops too (tools/profiler_loss.py, PERF.md §7)
MOE_LOST_EVENTS = 5



def phase_moe(backend, store: RecordStore, store_path: Path, fp: str,
              dev: torch.device, peaks: dict, label: str) -> dict:
    """dbrx-132b at full width (d_model 6144, 16 experts top-4, bf16,
    random weights from seed 0), its depth cut to :data:`MOE_LAYERS`,
    served through ``Engine.generate`` from the engine's CUDA graphs: the
    capacity dispatch in every prefill, the dense-over-experts decode path
    in every tick.

    Its 4 attention-projection GEMM targets and its decode attention shape
    are tuned into the store first, so every serve resolution is a plan
    hit on its exact record.  A warm-up run captures the tick and the
    32-token prefill; the graph run must launch no GEMM from the host and
    give the device 32 x (prefills + replays) GEMM kernels, read from each
    graph's kernel nodes times its replays, and one reduction pass per
    projection whose tuned config splits K; the telemetry counts the same
    GEMM calls; the eager run of the same requests gives the same greedy
    tokens.  Then: graph against eager prefill at :data:`MOE_PARITY`
    (logits and the slot's K/V rows bitwise); the capacity path at a
    factor that drops nothing against the decode path on layer 0's MoE
    input of a 32-token prompt, in fp32 (the weights widened), and the
    pairs dropped at the config's factor; the replayed tick's device time
    against its byte bound, split into GEMM, reduction and other kernels
    from a traced round held to the graph's kernel nodes."""
    t_phase = time.perf_counter()
    gc.collect()                  # the earlier phases' engines and graphs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    init_cupti()
    full = get_config("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    bf16, vocab = torch.bfloat16, cfg.vocab
    targets = [gemm_input(M, N, K, 16) for M in (MOE_SLOTS, MOE_PROMPT)
               for N, K in MOE_NK]
    attn = attention_input(MOE_SLOTS, cfg.n_heads, cfg.n_kv, 1, MOE_MAX_LEN,
                           cfg.hd)
    t0 = time.perf_counter()
    tune_space(GEMM_SPACE, targets, ("M",), backend, store,
               samples=MOE_TUNE_SAMPLES)
    tune_space(ATTENTION_SPACE, [attn], attention_dims, backend, store,
               samples=MOE_ATTN_SAMPLES)
    tune_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p_bytes = nbytes(tree_leaves(params))
    layer_bytes = nbytes(tree_leaves(params["layers"])) / cfg.n_layers
    full_gb = (p_bytes + (full.n_layers - cfg.n_layers) * layer_bytes) / 1e9
    phase("moe", f"{cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}, vocab {cfg.vocab}, decode_kv_splits "
          f"{cfg.decode_kv_splits}, bf16; the one cut: {cfg.n_layers} of "
          f"{full.n_layers} layers, {p_bytes / 1e9:.3f} GB of parameters "
          f"(all {full.n_layers} would need {full_gb:.1f} GB, one card "
          f"holds 80 GB); built in {init_s:.1f} s; "
          f"{before / 1e9:.3f} GB allocated before the build")
    eng = Engine(cfg, params, ServeConfig(
        max_len=MOE_MAX_LEN, slots=MOE_SLOTS, tunedb=str(store_path),
        tunedb_backend=fp, tunedb_models="", record_tick_times=True))
    plan = serving_state().plan
    per_fwd = 2 * len(MOE_NK) * cfg.n_layers          # 32 GEMMs a forward
    red = {M: 2 * cfg.n_layers * sum(splits(store, fp, M, N, K)
                                     for N, K in MOE_NK)
           for M in (MOE_SLOTS, MOE_PROMPT)}
    run = functools.partial(serve_run, eng, per_fwd=per_fwd,
                            red_pre=red[MOE_PROMPT],
                            red_tick=red[MOE_SLOTS],
                            attn_per_tick=cfg.n_layers)
    rng = np.random.default_rng(0)
    warm = [rng.integers(0, vocab, MOE_PROMPT) for _ in range(2)]
    prompts = [rng.integers(0, vocab, MOE_PROMPT) for _ in range(8)]

    reset_launches()
    w = run("moe warm-up", warm, 2)
    if (w["captures"], w["prefill_captures"]) != (1, 1):
        raise AssertionError(f"moe warm-up: {w['captures']} tick and "
                             f"{w['prefill_captures']} prefill captures")
    g = run("moe graph", prompts, 16)
    if g["captures"] or g["prefill_captures"] or g["launches"]:
        raise AssertionError(f"moe graph run: {g['captures']} tick and "
                             f"{g['prefill_captures']} prefill captures, "
                             f"{g['launches']} GEMM launches from the host")
    # the main path's wrapper launches: the warm-up's captures and their
    # warm-ups (the graph run replays)
    counts = read_launches()
    if not counts["gemm"]:
        raise AssertionError(f"moe serve path launches {counts}")
    tick_gemm, tick_reduce, tick_nodes = graph_counts(eng.graph)
    if sorted(eng.prefill_graphs) != [MOE_PROMPT]:
        raise AssertionError(f"moe prefill graphs of lengths "
                             f"{sorted(eng.prefill_graphs)}")
    pre_gemm, pre_reduce, pre_nodes = graph_counts(
        eng.prefill_graphs[MOE_PROMPT])
    if ((tick_gemm, tick_reduce) != (per_fwd, red[MOE_SLOTS])
            or (pre_gemm, pre_reduce) != (per_fwd, red[MOE_PROMPT])):
        raise AssertionError(f"moe tick graph: {tick_gemm} GEMM and "
                             f"{tick_reduce} reduction nodes of {tick_nodes}; "
                             f"prefill graph {pre_gemm} and {pre_reduce} of "
                             f"{pre_nodes}; want {per_fwd} and "
                             f"{red[MOE_SLOTS]}, {per_fwd} and "
                             f"{red[MOE_PROMPT]}")
    device = tick_gemm * g["replays"] + pre_gemm * g["prefills"]
    device_reduce = tick_reduce * g["replays"] + pre_reduce * g["prefills"]
    if (device != per_fwd * (g["prefills"] + g["replays"])
            or g["telemetry"]["gemm"] != device):
        raise AssertionError(f"moe graph run: {device} GEMM kernels given "
                             f"to the device, telemetry "
                             f"{g['telemetry']['gemm']}, want {per_fwd} x "
                             f"({g['prefills']} + {g['replays']})")
    check_plan_exact(plan, eng.tunedb_store, fp, g["shapes"], "moe serve")
    reset_launches()
    eng.prefill, eng.decode = eng.prefill_eager, eng.decode_eager
    try:
        e = run("moe eager", prompts, 16)
    finally:
        eng.prefill, eng.decode = eng.prefill_graph, eng.decode_graph
    eager_counts = read_launches()
    if e["outs"] != g["outs"] or e["shapes"] != g["shapes"]:
        raise AssertionError("moe: the graphs' greedy tokens or per-shape "
                             "telemetry differ from the eager run's")
    phase("moe", f"{cfg.name} ({cfg.n_layers}L d={cfg.d_model} "
          f"E={cfg.n_experts} top-{cfg.top_k} bf16): tune of "
          f"{len(targets)} GEMM shapes ({MOE_TUNE_SAMPLES} samples) and the "
          f"decode attention shape ({MOE_ATTN_SAMPLES}) {tune_s:.1f} s; "
          f"{len(prompts)} requests x 16 tokens, ServeConfig(max_len="
          f"{MOE_MAX_LEN}, slots={MOE_SLOTS}); warm-up {w['launches']} "
          f"GEMM launches from the host (captures and their warm-ups, all "
          f"plan hits); graph "
          f"run: {g['prefills']} prefills + {g['replays']} tick replays, "
          f"{g['launches']} GEMM launches from the host, {device} GEMM "
          f"kernels and {device_reduce} reduction passes given to the "
          f"device ({per_fwd} x (prefills + replays); tick graph "
          f"{tick_gemm} GEMM + {tick_reduce} reduction of {tick_nodes} "
          f"kernel nodes, prefill graph {pre_gemm} + {pre_reduce} of "
          f"{pre_nodes}), telemetry {g['telemetry']}; every served shape "
          f"its tuned record (tier exact); graph {g['tok_s']:.1f} tok/s, "
          f"median tick {g['tick_ms']:.2f} ms; eager {e['tok_s']:.1f} "
          f"tok/s, median tick {e['tick_ms']:.2f} ms ({e['launches']} GEMM "
          f"launches); greedy tokens equal; launches {counts}, eager "
          f"{eager_counts} [{label}]")

    # the 32-token prefill, graph replay (with the merge) against eager
    tokens = torch.as_tensor(prompts[0][None], device=dev)
    pre_ms = {what: median_ms(lambda: fn(1, tokens), 5)
              for what, fn in (("graph", eng.prefill_graph),
                               ("eager", eng.prefill_eager))}
    C = mmoe._capacity(MOE_PROMPT, cfg.top_k, cfg.n_experts,
                       cfg.capacity_factor)
    phase("moe", f"{MOE_PROMPT}-token prefill (the capacity path, C = "
          f"{C}): {pre_ms['graph']:.3f} ms as a graph replay with the merge, "
          f"{pre_ms['eager']:.3f} ms eager (median of 5) [{label}]")
    phase_prefill_parity(eng, cfg, dev, label, lengths=MOE_PARITY,
                         name="moe")

    # the capacity path (nothing dropped) against the decode path on layer
    # 0's MoE input, in fp32 with the weights widened
    toks = torch.as_tensor(prompts[0][None], device=dev)
    layer = tree_map(lambda t: t[0], params["layers"]["pos0"])
    x = params["embed"][toks]
    h = rms_norm(x, layer["norm1"], cfg.norm_eps)
    out, _ = attention(
        layer["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, positions=torch.arange(MOE_PROMPT, device=dev),
        causal=True, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps, attn_chunk=cfg.attn_chunk)
    h = rms_norm(x + out, layer["norm2"], cfg.norm_eps)
    wide = {k: v.float() for k, v in layer["moe"].items()}
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k)
    cap, _ = mmoe.moe(wide, h.float(), capacity_factor=MOE_NO_DROP_CF, **kw)
    dense = mmoe.moe_decode(wide, h.float(), **kw)
    torch.cuda.synchronize()
    excess = float(((cap - dense).abs() - MOE_ATOL
                    - MOE_RTOL * dense.abs()).max())
    paths_err = float((cap - dense).abs().max())
    del wide
    if excess > 0 or not torch.isfinite(cap).all():
        raise AssertionError(f"moe: the capacity path at factor "
                             f"{MOE_NO_DROP_CF} vs the decode path on layer "
                             f"0: max abs diff {paths_err:.3e}, beyond rtol "
                             f"{MOE_RTOL} atol {MOE_ATOL} by {excess:.3e}")
    # the pairs the config's capacity factor drops on the same input
    _, idx = mmoe._route(torch.matmul(h.float(), layer["moe"]["router"])
                         .reshape(-1, cfg.n_experts), cfg.top_k)
    per_expert = torch.zeros(cfg.n_experts, dtype=torch.long, device=dev
                             ).scatter_add_(0, idx.reshape(-1),
                                            torch.ones_like(idx.reshape(-1)))
    dropped = int((per_expert - C).clamp(min=0).sum())
    phase("moe", f"layer 0's MoE input, the {MOE_PROMPT}-token prompt, "
          f"fp32 (the weights widened): the capacity path at factor "
          f"{MOE_NO_DROP_CF} (C = "
          f"{mmoe._capacity(MOE_PROMPT, cfg.top_k, cfg.n_experts, MOE_NO_DROP_CF)}"
          f", nothing dropped) vs the decode path (every expert on every "
          f"token): max abs diff {paths_err:.3e} (max |out| "
          f"{float(dense.abs().max()):.3e}), within rtol {MOE_RTOL} atol "
          f"{MOE_ATOL} (tests/test_moe.py's); at the config's factor "
          f"{cfg.capacity_factor} (C = {C} slots an expert) "
          f"{dropped} of {MOE_PROMPT * cfg.top_k} (token, expert) pairs "
          f"drop; pairs an expert {per_expert.tolist()} [{label}]")

    # the replayed tick's device time against its bound (every parameter
    # read once: the decode path reads every expert, the head the whole
    # embedding; the cache read and written once), and its kernels by kind
    tick_dev = replay_ms(eng.graph)
    matrices = sum(t.numel() for t in tree_leaves(params) if t.dim() >= 2)
    tb = bound(p_bytes + 2 * nbytes(tree_leaves(eng.cache)),
               2.0 * MOE_SLOTS * matrices, bf16, peaks)
    nodes = collections.Counter(demangle(graph_kernel_names(eng.graph)))
    tries, split, kinds = traced_split(eng.graph, nodes, "moe",
                                       max_lost=MOE_LOST_EVENTS)
    busy = sum(v[0] for v in kinds.values())
    wall = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated()
    phase("moe", f"replayed tick ({MOE_SLOTS} slots, {cfg.n_layers} "
          f"layers): device {tick_dev:.3f} ms (median of 20), bound "
          f"{tb['bound_ms']:.3f} ms ({tb['bound_by']}: parameters "
          f"{p_bytes / 1e9:.3f} GB read, cache "
          f"{nbytes(tree_leaves(eng.cache)) / 1e9:.4f} GB read and "
          f"written), {tb['bound_ms'] / tick_dev:.1%} of the bound; the "
          f"tick graph holds {tick_nodes} kernel nodes; traced rounds of "
          f"{PROFILE_REPS} replays: {len(tries)} to one that held "
          f"({tries[-1]}; each name's time is its mean event time times "
          f"its node count); GEMM "
          f"kernels {kinds['gemm'][0]:.3f} ms ({kinds['gemm'][1]} a tick), "
          f"reduction passes {kinds['gemm_reduce'][0]:.3f} ms "
          f"({kinds['gemm_reduce'][1]}), other kernels "
          f"{kinds['other'][0]:.3f} ms ({kinds['other'][1]}); kernels busy "
          f"{busy:.3f} ms, {busy / tick_dev:.1%} of the replay; peak "
          f"allocated {peak / 1e9:.3f} GB ({before / 1e9:.3f} GB before the "
          f"phase); phase wall {wall:.1f} s [{label}]")
    for rank, (ms, cnt, name) in enumerate(split[:MOE_TOP_NAMES], 1):
        phase("moe", f"tick #{rank} {kernel_kind(name)}: {ms:.4f} ms, {cnt} "
              f"a tick, {name[:150]}")
    del eng, params, layer
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "device_launches": device,
            "device_reduce_launches": device_reduce, "tok_s": g["tok_s"],
            "tick_ms": g["tick_ms"], "tick_device_ms": tick_dev,
            "tick_bound_ms": tb["bound_ms"], "wall_s": wall}


# whisper-base (the encoder-decoder): its 3 projection (N, K) at the
# decode tick's 4 slots, the 4 x 32-token prefill's 128 rows and the 4 x
# 1500 encoder frames' 6000 (the encoder's projections and the
# cross-attention's K/V of the memory); its decode attention shape (the
# split-count lookup); 16 greedy ticks
ENCDEC_NK = ((512, 512), (2048, 512), (512, 2048))
ENCDEC_SLOTS, ENCDEC_PROMPT, ENCDEC_MAX_LEN, ENCDEC_NEW = 4, 32, 256, 16
ENCDEC_M = (ENCDEC_SLOTS, ENCDEC_SLOTS * ENCDEC_PROMPT, 6000)
ENCDEC_TUNE_SAMPLES = 96
ENCDEC_REPS = 10


def phase_encdec(backend, store: RecordStore, fp: str, dev: torch.device,
                 peaks: dict, label: str) -> dict:
    """whisper-base at full width, nothing cut (6 + 6 layers, d_model
    512, bf16, random weights from seed 0), through the model's entry
    points, as the reference serves an encoder-decoder (its engine serves
    tokens only): ``encode``, ``prefill`` with ``encoder_embeds`` (4
    requests of 1500 frame embeddings from seed 1 and 32-token prompts)
    and 16 greedy ``decode_step(memory=)`` ticks, eager, then again from
    one CUDA graph of the tick.

    Its 9 GEMM shapes and its decode attention shape are tuned into the
    store first and the store installed with no plan, so every resolution
    is an exact record (``dispatch.tier_counts``).  The replays' logits
    must be bitwise the eager ticks' at every step and their greedy tokens
    the eager's; the tick graph's GEMM kernel nodes 6 x (4 self + 2
    cross-K/V + 2 cross-q/o + 3 MLP) = 66 and its reduction nodes one per
    projection whose tuned config splits K.  Then encode, prefill and the
    eager tick timed, and the replayed tick's device time against its
    byte bound."""
    t_phase = time.perf_counter()
    cfg = get_config("whisper-base")
    B, T, bf16 = ENCDEC_SLOTS, ENCDEC_PROMPT, torch.bfloat16
    targets = [gemm_input(M, N, K, 16) for M in ENCDEC_M
               for N, K in ENCDEC_NK]
    attn = attention_input(B, cfg.n_heads, cfg.n_kv, 1, ENCDEC_MAX_LEN,
                           cfg.hd)
    t0 = time.perf_counter()
    tune_space(GEMM_SPACE, targets, ("M",), backend, store,
               samples=ENCDEC_TUNE_SAMPLES)
    tune_space(ATTENTION_SPACE, [attn], attention_dims, backend, store,
               samples=ENCDEC_TUNE_SAMPLES)
    tune_s = time.perf_counter() - t0
    install_serving(store=store, models=None, fingerprint=fp,
                    build_plan=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    gen.manual_seed(1)
    frames = torch.randn((B, cfg.encoder_len, cfg.d_model), generator=gen,
                         device=dev)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)), device=dev)
    cache = init_cache(cfg, B, ENCDEC_MAX_LEN, dev)
    batch = {"tokens": tokens, "encoder_embeds": frames}
    idx = torch.full((B,), T, dtype=torch.long, device=dev)
    last = torch.zeros((B, 1), dtype=torch.long, device=dev)

    # the main path: encode, prefill (its own encode), the eager greedy
    # ticks, the tick's capture and its replays
    reset_launches()
    dispatch.reset_counts()
    memory = encode(cfg, params, frames)
    logits, _ = prefill(params, cfg, batch, cache)
    first = logits[:, : cfg.vocab].argmax(-1)

    def greedy(step) -> tuple:
        last.copy_(first[:, None])
        toks, outs = [], []
        for i in range(ENCDEC_NEW):
            idx.fill_(T + i)
            out = step()[:, : cfg.vocab]
            outs.append(out.clone())
            last.copy_(out.argmax(-1)[:, None])
            toks.append(last[:, 0].tolist())
        return toks, outs

    tick = lambda: decode_step(params, cfg, last, cache, idx,
                               memory=memory)[0]
    eager_toks, eager_logits = greedy(tick)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tick()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    gc.disable()                  # a collection mid-capture (ROADMAP C10)
    try:
        with torch.cuda.graph(graph):
            static = tick()
    finally:
        gc.enable()
    graph.instantiate()

    def replay() -> torch.Tensor:
        graph.replay()
        return static

    graph_toks, graph_logits = greedy(replay)
    torch.cuda.synchronize()
    counts = read_launches()
    tiers = {f"{sp}/{t}": c for (sp, t), c in dispatch.tier_counts.items()}
    if not counts["gemm"] or any(not t.endswith("/exact") for t in tiers):
        raise AssertionError(f"encdec path: launches {counts}, resolutions "
                             f"{tiers} (want each an exact record)")
    same = all(torch.equal(g, e) for g, e in zip(graph_logits, eager_logits))
    if not same or graph_toks != eager_toks or not all(
            torch.isfinite(e).all() for e in eager_logits):
        raise AssertionError(f"encdec: the replayed ticks' logits bitwise "
                             f"the eager ticks' {same}, tokens "
                             f"{graph_toks} vs {eager_toks}")
    L, Le = cfg.n_layers, B * cfg.encoder_len
    want_gemm = L * (4 + 2 + 2 + 3)
    want_red = L * (6 * splits(store, fp, B, 512, 512)
                    + 2 * splits(store, fp, Le, 512, 512)
                    + 2 * splits(store, fp, B, 2048, 512)
                    + splits(store, fp, B, 512, 2048))
    n_gemm, n_red, n_nodes = graph_counts(graph)
    if (n_gemm, n_red) != (want_gemm, want_red):
        raise AssertionError(f"encdec tick graph: {n_gemm} GEMM and {n_red} "
                             f"reduction nodes of {n_nodes}, want "
                             f"{want_gemm} and {want_red}")
    device = n_gemm * ENCDEC_NEW
    phase("encdec", f"{cfg.name}, nothing cut: {cfg.encoder_layers} "
          f"encoder + {cfg.n_layers} decoder layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv} heads of {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.encoder_len} frames, "
          f"decode_kv_splits {cfg.decode_kv_splits}, bf16, "
          f"{cfg.param_count / 1e6:.2f} M parameters; tune of "
          f"{len(targets)} GEMM shapes and the decode attention shape "
          f"({ENCDEC_TUNE_SAMPLES} samples each) {tune_s:.1f} s; {B} "
          f"requests of {cfg.encoder_len} frames and {T}-token prompts, "
          f"{ENCDEC_NEW} greedy decode_step(memory=) ticks eager, then "
          f"replayed from one CUDA graph: logits bitwise the eager ticks' "
          f"at every step, greedy tokens equal ({graph_toks[-1]} at the "
          f"last); tick graph {n_gemm} GEMM + {n_red} reduction of "
          f"{n_nodes} kernel nodes ({L} x (4 self + 2 cross-K/V + 2 "
          f"cross-q/o + 3 MLP) GEMMs), {device} GEMM kernels given to the "
          f"device by the {ENCDEC_NEW} replays; dispatch.tier_counts "
          f"{tiers}; launches {counts} [{label}]")

    enc_ms = median_ms(lambda: encode(cfg, params, frames), ENCDEC_REPS)
    pre_ms = median_ms(lambda: prefill(params, cfg, batch, cache),
                       ENCDEC_REPS)
    tick_ms = median_ms(tick, ENCDEC_REPS)
    tick_dev = replay_ms(graph)
    # the tick's bound: the decoder's parameters and the tied head read
    # once, the cache read and written once, and the memory read by each
    # of the 12 cross-attention K/V projections, whose outputs are written
    # and read back once; operations: each projection's 2 x M x N x K
    # (M = 4 slots, or 6000 frames for the cross K/V) and the head's
    dec = tree_leaves(params["layers"])
    kv_elems = sum(params["layers"]["pos0"]["cross"][k].numel()
                   for k in ("wk", "wv"))
    kv_out = 2 * L * Le * cfg.n_kv * cfg.hd * 2
    tb = bound(nbytes(dec) + nbytes([params["embed"]])
               + 2 * nbytes(tree_leaves(cache)) + 2 * L * nbytes([memory])
               + 2 * kv_out,
               2.0 * B * (sum(t.numel() for t in dec if t.dim() >= 3)
                          - kv_elems + params["embed"].numel())
               + 2.0 * Le * kv_elems, bf16, peaks)
    wall = time.perf_counter() - t_phase
    phase("encdec", f"encode {enc_ms:.3f} ms, prefill (its own encode "
          f"included) {pre_ms:.3f} ms, eager tick {tick_ms:.3f} ms (host "
          f"wall, median of {ENCDEC_REPS}); replayed tick: device "
          f"{tick_dev:.4f} ms (median of 20), bound {tb['bound_ms']:.4f} ms "
          f"({tb['bound_by']}: bytes {1e3 * tb['t_bytes']:.4f} ms, "
          f"operations {1e3 * tb['t_ops']:.4f} ms), "
          f"{tb['bound_ms'] / tick_dev:.1%} of the bound; phase wall "
          f"{wall:.1f} s [{label}]")
    del graph, params, cache, memory
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "device_launches": device,
            "device_reduce_launches": n_red * ENCDEC_NEW, "wall_s": wall,
            "tick_device_ms": tick_dev, "tick_bound_ms": tb["bound_ms"]}


# internvl2-76b (the vision frontend): depth cut to 32 of 80 layers (all
# 80 need 139 GB); its 4 projection (N, K), with their count a layer, at
# the tick's 4 slots and the 32-token prefill; the decode attention shape
# at the max_len that holds 256 patches, 32 tokens and 16 more
FRONTEND_LAYERS = 32
FRONTEND_NK = {(8192, 8192): 2, (1024, 8192): 2, (28672, 8192): 2,
               (8192, 28672): 1}
FRONTEND_SLOTS, FRONTEND_PROMPT, FRONTEND_NEW = 4, 32, 16
FRONTEND_MAX_LEN = 320
FRONTEND_TUNE_SAMPLES = 96
FRONTEND_ATTN_SAMPLES = 48
FRONTEND_PEAK_GB = 75


def phase_frontend(backend, store: RecordStore, store_path: Path, fp: str,
                   dev: torch.device, peaks: dict, label: str) -> dict:
    """internvl2-76b at full width (d_model 8192, 64 / 8 heads of 128,
    d_ff 28672, vocab 128256, bf16, random weights from seed 0), its
    depth cut to :data:`FRONTEND_LAYERS` of 80, built after the earlier
    phases' memory is freed.

    Its 4 projection GEMMs at M = 4 and 32 and its decode attention shape
    are tuned into the store; then ``Engine.generate`` serves 8 requests
    of 32-token prompts x 16 tokens on tokens only (as the reference's
    engine serves it) from its CUDA graphs: no GEMM launched from the
    host, 224 x (prefills + replays) GEMM kernels from the graphs' nodes,
    every served shape its tuned record; the eager run gives the same
    tokens.  Then the model-level frontend prefill: 256 patch embeddings
    (seed 1) and 32 tokens for 4 requests (M = 1152, untuned: the tier
    each of its shapes resolved to printed) and 16 greedy
    ``decode_step``s from index 288.  The replayed tick's device time
    against its byte bound; the peak allocated held under
    :data:`FRONTEND_PEAK_GB` GB."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(full, n_layers=FRONTEND_LAYERS)
    B, T, Np = FRONTEND_SLOTS, FRONTEND_PROMPT, cfg.n_frontend_tokens
    targets = [gemm_input(M, N, K, 16) for M in (B, T)
               for N, K in FRONTEND_NK]
    attn = attention_input(B, cfg.n_heads, cfg.n_kv, 1, FRONTEND_MAX_LEN,
                           cfg.hd)
    t0 = time.perf_counter()
    tune_space(GEMM_SPACE, targets, ("M",), backend, store,
               samples=FRONTEND_TUNE_SAMPLES)
    tune_space(ATTENTION_SPACE, [attn], attention_dims, backend, store,
               samples=FRONTEND_ATTN_SAMPLES)
    tune_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p_bytes = nbytes(tree_leaves(params))
    layer_bytes = nbytes(tree_leaves(params["layers"])) / cfg.n_layers
    full_gb = (p_bytes + (full.n_layers - cfg.n_layers) * layer_bytes) / 1e9
    phase("frontend", f"{cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {Np} patch embeddings, decode_kv_splits "
          f"{cfg.decode_kv_splits}, bf16; the one cut: {cfg.n_layers} of "
          f"{full.n_layers} layers, {cfg.param_count / 1e9:.2f} B "
          f"parameters, {p_bytes / 1e9:.3f} GB (all {full.n_layers} would "
          f"need {full_gb:.1f} GB, one card holds 80 GB); built in "
          f"{init_s:.1f} s (peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
          f"{before / 1e9:.3f} GB before the phase); tune of "
          f"{len(targets)} GEMM shapes ({FRONTEND_TUNE_SAMPLES} samples) "
          f"and the decode attention shape ({FRONTEND_ATTN_SAMPLES}) "
          f"{tune_s:.1f} s")

    eng = Engine(cfg, params, ServeConfig(
        max_len=FRONTEND_MAX_LEN, slots=B, tunedb=str(store_path),
        tunedb_backend=fp, tunedb_models="", record_tick_times=True))
    plan = serving_state().plan
    per_fwd = sum(FRONTEND_NK.values()) * cfg.n_layers
    red = {M: cfg.n_layers * sum(c * splits(store, fp, M, N, K)
                                 for (N, K), c in FRONTEND_NK.items())
           for M in (B, T)}
    run = functools.partial(serve_run, eng, per_fwd=per_fwd,
                            red_pre=red[T], red_tick=red[B],
                            attn_per_tick=cfg.n_layers)
    rng = np.random.default_rng(0)
    warm = [rng.integers(0, cfg.vocab, T) for _ in range(2)]
    prompts = [rng.integers(0, cfg.vocab, T) for _ in range(8)]
    reset_launches()
    w = run("frontend warm-up", warm, 2)
    g = run("frontend graph", prompts, FRONTEND_NEW)
    if (w["captures"], w["prefill_captures"]) != (1, 1) or (
            g["captures"] or g["prefill_captures"] or g["launches"]):
        raise AssertionError(f"frontend: warm-up {w['captures']} tick and "
                             f"{w['prefill_captures']} prefill captures; "
                             f"graph run {g['captures']} and "
                             f"{g['prefill_captures']}, {g['launches']} GEMM "
                             "launches from the host")
    counts = read_launches()
    if not counts["gemm"]:
        raise AssertionError(f"frontend serve path launches {counts}")
    tick_gemm, tick_red, tick_nodes = graph_counts(eng.graph)
    pre_gemm, pre_red, pre_nodes = graph_counts(eng.prefill_graphs[T])
    if ((tick_gemm, tick_red) != (per_fwd, red[B])
            or (pre_gemm, pre_red) != (per_fwd, red[T])):
        raise AssertionError(f"frontend tick graph: {tick_gemm} GEMM and "
                             f"{tick_red} reduction nodes of {tick_nodes}; "
                             f"prefill graph {pre_gemm} and {pre_red} of "
                             f"{pre_nodes}; want {per_fwd} and {red[B]}, "
                             f"{per_fwd} and {red[T]}")
    device = tick_gemm * g["replays"] + pre_gemm * g["prefills"]
    device_red = tick_red * g["replays"] + pre_red * g["prefills"]
    if g["telemetry"]["gemm"] != device:
        raise AssertionError(f"frontend graph run: {device} GEMM kernels "
                             f"given to the device, telemetry "
                             f"{g['telemetry']['gemm']}")
    check_plan_exact(plan, eng.tunedb_store, fp, g["shapes"], "frontend")
    eng.prefill, eng.decode = eng.prefill_eager, eng.decode_eager
    try:
        e = run("frontend eager", prompts, FRONTEND_NEW)
    finally:
        eng.prefill, eng.decode = eng.prefill_graph, eng.decode_graph
    if e["outs"] != g["outs"]:
        raise AssertionError("frontend: the graphs' greedy tokens differ "
                             "from the eager run's")
    phase("frontend", f"Engine.generate on tokens, {len(prompts)} requests "
          f"x {FRONTEND_NEW} tokens, ServeConfig(max_len="
          f"{FRONTEND_MAX_LEN}, slots={B}): graph run {g['tok_s']:.1f} "
          f"tok/s, median tick {g['tick_ms']:.2f} ms, {g['prefills']} "
          f"prefills + {g['replays']} tick replays, {g['launches']} GEMM "
          f"launches from the host, {device} GEMM kernels and {device_red} "
          f"reduction passes given to the device ({per_fwd} x (prefills + "
          f"replays); tick graph {tick_gemm} GEMM + {tick_red} reduction "
          f"of {tick_nodes} kernel nodes, prefill graph {pre_gemm} + "
          f"{pre_red} of {pre_nodes}), every served shape its tuned record "
          f"(tier exact); eager {e['tok_s']:.1f} tok/s, median tick "
          f"{e['tick_ms']:.2f} ms; greedy tokens equal; launches {counts} "
          f"[{label}]")

    # the model-level frontend prefill: 256 patch embeddings and 32 tokens
    # a request (M = 1152, untuned), then 16 greedy ticks from index 288
    gen.manual_seed(1)
    patches = torch.randn((B, Np, cfg.d_model), generator=gen, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)), device=dev)
    batch = {"tokens": toks, "patch_embeds": patches}
    cache = init_cache(cfg, B, FRONTEND_MAX_LEN, dev)
    n = Np + T
    dispatch.reset_counts()
    first_ms = median_ms(lambda: prefill(params, cfg, batch, cache), 1)
    first_tiers = {f"{sp}/{t}": c
                   for (sp, t), c in dispatch.tier_counts.items()}
    # a slow-path answer is promoted into the plan with its tier; the
    # vendor heuristics' (degraded) is not
    m_tiers = {f"{N}x{K}": (plan.lookup("gemm", shape_key(gemm_input(
        B * n, N, K, 16))) or (None, "degraded"))[1] for N, K in FRONTEND_NK}
    pre_ms = median_ms(lambda: prefill(params, cfg, batch, cache), 3)
    logits, _ = prefill(params, cfg, batch, cache)
    last = logits[:, : cfg.vocab].argmax(-1, keepdim=True)
    toks_out = []
    t0 = time.perf_counter()
    for i in range(FRONTEND_NEW):
        logits, _ = decode_step(params, cfg, last, cache, n + i)
        last = logits[:, : cfg.vocab].argmax(-1, keepdim=True)
        toks_out.append(last[:, 0])
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / FRONTEND_NEW
    toks_out = torch.stack(toks_out, 1)
    k_rows = cache["pos0"]["attn"]["k"]
    if not (torch.isfinite(logits).all()
            and logits.shape == (B, cfg.padded_vocab)
            and bool((toks_out < cfg.vocab).all())
            and k_rows[:, :, n + FRONTEND_NEW - 1].any()
            and not k_rows[:, :, n + FRONTEND_NEW:].any()):
        raise AssertionError("frontend: the patch prefill and its ticks gave "
                             "non-finite logits or a cache written outside "
                             f"0..{n + FRONTEND_NEW - 1}")
    tick_dev = replay_ms(eng.graph)
    tb = bound(p_bytes + 2 * nbytes(tree_leaves(eng.cache)),
               2.0 * B * sum(t.numel() for t in tree_leaves(params)
                             if t.dim() >= 2), torch.bfloat16, peaks)
    wall = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated()
    phase("frontend", f"model-level prefill of {Np} patch embeddings + {T} "
          f"tokens x {B} requests (M = {B * n}, untuned): first "
          f"{first_ms:.3f} ms, then {pre_ms:.3f} ms (median of 3); the "
          f"first's resolutions {first_tiers}, the M = {B * n} shapes "
          f"resolved on tier {m_tiers}; then {FRONTEND_NEW} greedy "
          f"decode_steps from index {n}: {dec_ms:.2f} ms a step (eager), "
          f"finite logits, request 0's tokens {toks_out[0].tolist()}; "
          f"replayed engine tick ({B} slots, {cfg.n_layers} layers): "
          f"device {tick_dev:.3f} ms (median of 20), bound "
          f"{tb['bound_ms']:.3f} ms ({tb['bound_by']}: {p_bytes / 1e9:.3f} "
          f"GB of parameters read, the cache read and written), "
          f"{tb['bound_ms'] / tick_dev:.1%} of the bound; peak allocated "
          f"{peak / 1e9:.3f} GB (held under {FRONTEND_PEAK_GB}); phase wall "
          f"{wall:.1f} s [{label}]")
    if peak > FRONTEND_PEAK_GB * 1e9:
        raise AssertionError(f"frontend: peak allocated {peak / 1e9:.1f} GB "
                             f"at {cfg.n_layers} layers")
    del eng, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "device_launches": device,
            "device_reduce_launches": device_red, "tok_s": g["tok_s"],
            "tick_ms": g["tick_ms"], "tick_device_ms": tick_dev,
            "tick_bound_ms": tb["bound_ms"], "wall_s": wall}


# SmolLM-135M's training step at the launcher's defaults: 4,096 tokens
TRAIN_SEQ, TRAIN_BATCH = 512, 8
TRAIN_STEPS_A, TRAIN_STEPS_B = 20, 10
TRAIN_SHAPES = 9
TRAIN_RESUME = (6, 3, 8)           # part E: steps, checkpoint_every, then to
# part E: the resumed run's losses and final state (parameters, AdamW m
# and v, error feedback) against the uninterrupted run's, in relative
# (norm) difference; the step has read deterministic on the card (the
# resumed losses equal to the uninterrupted ones)
TRAIN_RESUME_RTOL = 1e-6
# threads of the retune loop, the fleet and the follower (C11); a fleet
# worker's heartbeat and a coordinator's workers are unnamed: "(beat)",
# "(run)"
BACKGROUND_THREADS = ("tunedb-retune", "telemetry-export", "follower-")
TRAIN_SMOKE_ARCHS = ("mamba2-1.3b", "dbrx-132b", "jamba-v0.1-52b",
                     "whisper-base", "internvl2-76b")


@contextlib.contextmanager
def no_plain_gemm():
    """Fail any call of the GEMM's or the reduction's plain version: on the
    card the wrappers launch their kernels, and nothing else may stand in
    for them."""
    saved = kmatmul.matmul_plain, kmatmul.splitk_reduce_plain

    def boom(*a, **k):
        raise AssertionError("a plain GEMM version was called on the card")
    kmatmul.matmul_plain = kmatmul.splitk_reduce_plain = boom
    try:
        yield
    finally:
        kmatmul.matmul_plain, kmatmul.splitk_reduce_plain = saved


def train_flops(cfg, B: int, S: int) -> dict:
    """Model FLOPs of one training step (the remat recompute excluded):
    3 x (the projections' 2·M·N·K at M = B·S, the tied head's
    2·B·(S-1)·D·V and the causal attention's 2·B·H·S²·hd a layer): the
    forward once, the backward's two products twice."""
    M, d = B * S, cfg.d_model
    proj = cfg.n_layers * sum(2.0 * M * n * k * c
                              for (n, k), c in SLICE_NK.items())
    head = 2.0 * B * (S - 1) * d * cfg.padded_vocab
    attn = cfg.n_layers * 2.0 * B * cfg.n_heads * S * S * cfg.hd
    return {"proj": 3 * proj, "head": 3 * head, "attn": 3 * attn,
            "total": 3 * (proj + head + attn)}


def train_step_shapes(cfg, M: int) -> dict:
    """Calls per step of each GEMM shape (M, N, K) of a training step, and
    of each transposed-operand copy (rows, cols) the backward makes: the
    forward and its recompute (M, N, K) twice, dA = dC·Bᵀ (M, K, N) with
    the weight's (N, K) copy, dB = Aᵀ·dC (K, N, M) with the activation's
    (K, M) copy, for each projection (K -> N) of each layer."""
    calls, copies = collections.Counter(), collections.Counter()
    for (n, k), c in SLICE_NK.items():
        c *= cfg.n_layers
        calls[(M, n, k)] += 2 * c
        calls[(M, k, n)] += c
        calls[(k, n, M)] += c
        copies[(n, k)] += c
        copies[(k, M)] += c
    return {"calls": calls, "copies": copies}


def train_run(step_fn, state, batch_of, steps: range, per_step: int,
              what: str) -> tuple:
    """Run ``steps`` train steps; per step the host wall (to the loss read
    on the host), the loss, the GEMM and reduction launches and the
    telemetry's GEMM calls by shape.  Each step's GEMM launches must equal
    its dispatch calls, ``per_step``, and its reduction launches the calls
    whose resolved config splits K."""
    tel = get_telemetry()
    rows = []
    for step in steps:
        batch = batch_of(step)
        torch.cuda.synchronize()
        l0, r0 = kmatmul.launches, kmatmul.reduce_launches
        prev = tel.snapshot()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        win = tel.diff(prev).get("gemm")
        shapes = {shape_key(x): (x, c) for x, c in win.window_shapes}
        launches = kmatmul.launches - l0
        reduces = kmatmul.reduce_launches - r0
        want_red = 0
        for x, c in shapes.values():
            cfg, _ = dispatch._resolve_cfg("gemm", x)
            run = ops.shrink_gemm_cfg(cfg or {}, x["M"], x["N"], x["K"])
            want_red += c * (run["k_split"] > 1)
        if not (launches == win.window_calls == per_step
                and reduces == want_red and math.isfinite(loss)):
            raise AssertionError(f"{what} step {step}: {launches} GEMM "
                                 f"launches, {win.window_calls} dispatch "
                                 f"calls (want {per_step}), "
                                 f"{reduces} reduction launches (want "
                                 f"{want_red}), loss {loss}")
        rows.append({"step": step, "wall_ms": 1e3 * wall, "loss": loss,
                     "shapes": shapes, "launches": launches,
                     "reduces": reduces,
                     "grad_norm": float(m["grad_norm"])})
    return state, rows


def device_split(fn) -> dict:
    """Run ``fn()`` once under the profiler: its kernels' device time by
    kind (the hand-written GEMM, its reduction pass, cuBLAS, the rest),
    the busy time (the union of the kernel intervals), the wall (traced:
    the host's tracing adds to it), the host ops called and the ones with
    the most self CPU time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and not ev.name.startswith(("Memcpy", "Memset"))]
    kinds = {"gemm": [0.0, 0], "gemm_reduce": [0.0, 0], "cublas": [0.0, 0],
             "other": [0.0, 0]}
    for ev in evs:
        kind = kernel_kind(ev.name)
        if kind == "other" and CUBLAS_KERNEL.search(ev.name):
            kind = "cublas"
        kinds[kind][0] += ev.time_range.elapsed_us() / 1e3
        kinds[kind][1] += 1
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in evs)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]
    return {"kinds": kinds, "busy_ms": busy / 1e3, "wall_ms": wall,
            "events": len(evs), "host_ops": sum(e.count for e in host),
            "host_top": [(e.key, e.count,
                          round(e.self_cpu_time_total / 1e3, 1))
                         for e in top]}


def phase_train(fp: str, tuners: dict, dev: torch.device, peaks: dict,
                tmp: Path, label: str) -> dict:
    """SmolLM-135M training at full width (30 layers, d_model 576, vocab
    49,152, bf16, params from seed 0) on the card, ``DataConfig(seq_len=
    512, global_batch=8)`` as the launcher's defaults, microbatches 1,
    ``AdamWConfig(lr=3e-4, warmup_steps=1)``, from an empty store.

    A: 20 steps from the heuristic tier: the median step wall after step
    0, tokens/s, the loss at steps 0 and 19 (finite, falling), the peak
    allocated, the model TFLOP/s (``train_flops``) and its share of the
    peak; each step 840 GEMM launches, each a dispatch call, the split-K
    reduction launches those of the resolved configs, no plain version.
    B: the tune phase's GEMM tuner over A's telemetry (9 shapes) in a
    ``TuningSession``; installed, 10 more steps, every resolution a plan
    hit.  The train path's launches are A's and B's steps' (30 x 840
    GEMMs), not the session's timings.  C: at the 9 shapes ``ops.matmul`` under the tuned and the
    heuristic's config, the kernel alone, the reduction pass alone,
    ``torch.matmul`` and the bound, times the calls a step; the
    transposed-operand copies; one eager step traced and its device time
    split by kernel kind.  D: at the 9 shapes the Function's output, dA
    and dB held to the plain version on the card; one full-width step's
    loss and gradient norm held to the same step through the plain
    version.  E: 6 steps with checkpoint_every=3, async saves, int8
    compression and stochastic rounding, a new ``Trainer`` resumes at 6
    and runs 6 and 7 only; its losses and final state (parameters, m, v,
    error feedback, AdamW step, key) against an uninterrupted 8-step
    run's.  F: 4 steps at microbatches=2 with int8
    compression (``ef_norm``); one step each of the other families at
    SMOKE.  G: ``python -m repro_torch.launch.train --arch smollm-135m
    --steps 3`` in a process of its own, no ``--device``."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(BACKGROUND_THREADS)
             or t.name.endswith(("(beat)", "(run)"))]
    if alive:
        raise AssertionError(f"train: background threads alive (C11): "
                             f"{alive}")
    cfg = get_config("smollm-135m")
    B, S = TRAIN_BATCH, TRAIN_SEQ
    M = B * S
    opt = AdamWConfig(lr=3e-4, warmup_steps=1,
                      total_steps=TRAIN_STEPS_A + TRAIN_STEPS_B)
    tc = TrainConfig(steps=TRAIN_STEPS_A + TRAIN_STEPS_B)
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    trainer = Trainer(cfg, opt, tc, data, device=dev)
    train_store = RecordStore()
    install_serving(store=train_store, models=None, fingerprint=fp)
    clear_telemetry()
    dispatch.reset_counts()
    flops = train_flops(cfg, B, S)
    shapes = train_step_shapes(cfg, M)
    per_step = 4 * GEMMS_PER_LAYER * cfg.n_layers  # fwd, recompute, dA, dB
    if (sum(shapes["calls"].values()) != per_step
            or len(shapes["calls"]) != TRAIN_SHAPES):
        raise AssertionError(f"train: {dict(shapes['calls'])}")

    # A: from the heuristic tier
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, opt, tc, dev)
    reset_launches()
    with no_plain_gemm():
        state, rows_a = train_run(trainer.step_fn, state, trainer.batch,
                                  range(TRAIN_STEPS_A), per_step, "train A")
    counts_a = read_launches()
    peak = torch.cuda.max_memory_allocated()
    tiers_a = {t: c for (sp, t), c in dispatch.tier_counts.items()
               if sp == "gemm"}
    seen = {k: x for r in rows_a for k, (x, _) in r["shapes"].items()}
    want = {shape_key(gemm_input(m, n, k, 16)) for m, n, k in shapes["calls"]}
    if set(seen) != want:
        raise AssertionError(f"train A: shapes {sorted(seen)}, want "
                             f"{sorted(want)}")
    wall_a = statistics.median(r["wall_ms"] for r in rows_a[1:])
    loss0, loss_n = rows_a[0]["loss"], rows_a[-1]["loss"]
    if not loss_n < loss0:
        raise AssertionError(f"train A: loss {loss0} -> {loss_n}")
    tflops_a = flops["total"] / (wall_a * 1e-3) / 1e12
    phase("train", f"A: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, bf16), {B} x {S} "
          f"tokens a step, from an empty store (tiers {tiers_a}): "
          f"{TRAIN_STEPS_A} steps, median step wall {wall_a:.2f} ms after "
          f"step 0 (step 0 {rows_a[0]['wall_ms']:.1f} ms), "
          f"{M / (wall_a * 1e-3):.0f} tokens/s, loss {loss0:.4f} at step 0 "
          f"-> {loss_n:.4f} at step {TRAIN_STEPS_A - 1}; peak allocated "
          f"{peak / 1e9:.3f} GB; model {flops['total'] / 1e12:.3f} TFLOP a "
          f"step (projections {flops['proj'] / 1e12:.3f}, head "
          f"{flops['head'] / 1e12:.3f}, attention {flops['attn'] / 1e12:.3f}"
          f"; recompute excluded): {tflops_a:.1f} TFLOP/s, "
          f"{tflops_a / (peaks[torch.bfloat16] / 1e12):.1%} of the "
          f"{peaks[torch.bfloat16] / 1e12:.0f} TFLOP/s peak; "
          f"{rows_a[-1]['launches']} GEMM launches a step (each a dispatch "
          f"call), {rows_a[-1]['reduces']} reduction launches a step (the "
          f"resolved configs' split-K calls), no plain version [{label}]")

    # B: tune the step's shapes, then train on from A's state
    heur = {k: dispatch._heuristic_cfg("gemm", x) for k, x in seen.items()}
    t0 = time.perf_counter()
    report = TuningSession(tuners["gemm"], train_store, get_telemetry(),
                           top_k_shapes=16, workers=4).run()
    session_s = time.perf_counter() - t0
    if report.failed or report.tuned != TRAIN_SHAPES:
        raise AssertionError(f"train B: {report.tuned}/{TRAIN_SHAPES} tuned, "
                             f"{report.failed} failed: {report.errors}")
    install_store(train_store, fingerprint=fp)
    plan = serving_state().plan
    tiers_b = {}
    for k, x in seen.items():
        rec = train_store.get("gemm", x, backend=fp)
        tiers_b[k] = plan.lookup("gemm", k)
        if tiers_b[k] != (rec.config, "exact"):
            raise AssertionError(f"train B: plan entry of {k} {tiers_b[k]}, "
                                 f"want the exact record's {rec.config}")
    dispatch.reset_counts()
    reset_launches()
    with no_plain_gemm():
        state, rows_b = train_run(
            trainer.step_fn, state, trainer.batch,
            range(TRAIN_STEPS_A, TRAIN_STEPS_A + TRAIN_STEPS_B), per_step,
            "train B")
    counts_b = read_launches()
    tiers_after = {t: c for (sp, t), c in dispatch.tier_counts.items()
                   if sp == "gemm"}
    if set(tiers_after) != {"plan"}:
        raise AssertionError(f"train B: tiers {tiers_after}")
    # the train path's launches: A's and B's steps only, not B's tuning
    counts = {k: counts_a[k] + counts_b[k] for k in counts_a}
    reduces = sum(r["reduces"] for r in rows_a + rows_b)
    want = {"gemm": per_step * (TRAIN_STEPS_A + TRAIN_STEPS_B),
            "gemm_reduce": reduces, "conv": 0, "attention": 0, "ssd": 0}
    if counts != want:
        raise AssertionError(f"train: launches in A's and B's steps "
                             f"{counts}, want {want}")
    wall_b = statistics.median(r["wall_ms"] for r in rows_b)
    phase("train", f"B: TuningSession over A's telemetry with the tune "
          f"phase's GEMM tuner: {report.tuned} shapes tuned in "
          f"{session_s:.1f} s, all planned exact; {TRAIN_STEPS_B} more "
          f"steps (tiers {tiers_after}): median step wall {wall_b:.2f} ms "
          f"(A: {wall_a:.2f} ms), loss {rows_b[-1]['loss']:.4f} at step "
          f"{rows_b[-1]['step']} [{label}]")
    for k, x in sorted(seen.items()):
        rec = train_store.get("gemm", x, backend=fp)
        phase("train", f"  M={x['M']} N={x['N']} K={x['K']}: tuned "
              f"{rec.config} {rec.tflops:.1f} TFLOP/s; heuristic "
              f"{heur[k]}")

    # C: where the step's GEMM time goes
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows_c, sums = [], collections.Counter()
    for (m, n, k), calls in sorted(shapes["calls"].items()):
        x = gemm_input(m, n, k, 16)
        cfg_t = train_store.get("gemm", x, backend=fp).config
        cfg_h = heur[shape_key(x)]
        run = ops.shrink_gemm_cfg(cfg_t, m, n, k)
        a, bs = gemm_weights(m, n, k, gen, dev)
        nc = len(bs)
        t = {"tuned": time_ms(lambda i: ops.matmul(a, bs[i], cfg_t), nc),
             "heuristic": time_ms(lambda i: ops.matmul(a, bs[i], cfg_h), nc),
             "kernel": time_ms(lambda i: kmatmul.gemm(a, bs[i], run), nc),
             "library": time_ms(lambda i: torch.matmul(a, bs[i]), nc)}
        with plain_kernels():
            t["plain"] = time_ms(lambda i: ops.matmul(a, bs[i], cfg_t), nc)
        t["reduce"] = 0.0
        if run["k_split"] > 1:
            parts = kmatmul.gemm(a, bs[0], run)
            t["reduce"] = time_ms(lambda i: kmatmul.splitk_reduce(parts), nc)
        b = gemm_bound(m, n, k, torch.bfloat16, peaks)
        del a, bs
        rows_c.append({"M": m, "N": n, "K": k, "calls": calls,
                       "k_split": run["k_split"], "cfg": cfg_t,
                       "heuristic_cfg": cfg_h,
                       **{f"{key}_ms": v for key, v in t.items()},
                       "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]})
        for key, v in t.items():
            sums[key] += calls * v
        sums["bound"] += calls * b["bound_ms"]
        phase("train", f"C: M={m} N={n} K={k} x {calls} a step: tuned "
              f"{t['tuned'] * 1e3:.1f} us (k_split {run['k_split']}; kernel "
              f"alone {t['kernel'] * 1e3:.1f} us, reduction "
              f"{t['reduce'] * 1e3:.1f} us), heuristic "
              f"{t['heuristic'] * 1e3:.1f} us, plain {t['plain'] * 1e3:.1f} "
              f"us, torch.matmul {t['library'] * 1e3:.1f} us, bound "
              f"{b['bound_ms'] * 1e3:.1f} us ({b['bound_by']}) [{label}]")
    copy_ms = 0.0
    for (r, c), calls in sorted(shapes["copies"].items()):
        src = [torch.randn((c, r), generator=gen, device=dev).bfloat16()
               for _ in range(max(2, math.ceil(2.5 * L2_BYTES / (2 * r * c))))]
        copy_ms += calls * time_ms(lambda i: src[i].t().contiguous(),
                                   len(src))
        del src
    batch = trainer.batch(TRAIN_STEPS_A + TRAIN_STEPS_B)
    split = device_split(lambda: trainer.step_fn(state, batch))
    kinds = {k: round(v[0], 3) for k, v in split["kinds"].items()}
    phase("train", f"C: the step's {per_step} GEMMs: tuned "
          f"{sums['tuned']:.2f} ms (kernel alone {sums['kernel']:.2f} ms, "
          f"reduction passes {sums['reduce']:.2f} ms), heuristic "
          f"{sums['heuristic']:.2f} ms, plain {sums['plain']:.2f} ms, "
          f"torch.matmul {sums['library']:.2f} ms, bound "
          f"{sums['bound']:.2f} ms; transposed-operand copies "
          f"{copy_ms:.2f} ms; step wall {wall_b:.2f} ms (tuned); one eager "
          f"step traced: wall {split['wall_ms']:.1f} ms, device busy "
          f"{split['busy_ms']:.2f} ms ({1 - split['busy_ms'] / split['wall_ms']:.1%} "
          f"idle), {split['events']} kernels, device ms by kind {kinds}; "
          f"{split['host_ops']} host ops, the most self CPU time (name, "
          f"calls, ms): {split['host_top']} [{label}]")

    # D: gradients on the card against the plain version
    worst = 0.0
    for (m, n, k) in sorted(shapes["calls"]):
        a = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        b = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
             ).bfloat16()
        dc = torch.randn((m, n), generator=gen, device=dev).bfloat16()
        outs = []
        for plain in (False, True):
            ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(
                True)
            with plain_kernels() if plain else contextlib.nullcontext():
                out = dispatch.matmul(ta, tb)
                da, db = torch.autograd.grad(out, (ta, tb), dc)
            if not plain and not isinstance(
                    out.grad_fn, dispatch._TunedGemm._backward_cls):
                raise AssertionError("train D: the output is not the "
                                     "Function's")
            outs.append((out.detach(), da, db))
        for got, want in zip(*outs):
            er = rel_err(got, want)[1]
            worst = max(worst, er)
            if er > TOL[torch.bfloat16] or not torch.isfinite(got).all():
                raise AssertionError(f"train D: M={m} N={n} K={k}: rel err "
                                     f"{er:.3e} against the plain version")
    full = {}
    for plain in (False, True):
        with plain_kernels() if plain else contextlib.nullcontext():
            loss, _ = loss_fn(state["params"], cfg, batch)
            grads = torch.autograd.grad(loss, tree_leaves(state["params"]))
        full[plain] = (float(loss.detach()), float(global_norm(dict(enumerate(
            grads)))))
        del grads
    er_loss = abs(full[False][0] - full[True][0]) / abs(full[True][0])
    er_norm = abs(full[False][1] - full[True][1]) / full[True][1]
    if max(er_loss, er_norm) > TOL[torch.bfloat16]:
        raise AssertionError(f"train D: full step kernel {full[False]} vs "
                             f"plain {full[True]}")
    phase("train", f"D: the Function's output, dA and dB at the "
          f"{TRAIN_SHAPES} shapes within {worst:.3e} of the plain version "
          f"(tolerance {TOL[torch.bfloat16]}); one full-width step: loss "
          f"{full[False][0]:.5f} vs plain {full[True][0]:.5f} (rel "
          f"{er_loss:.2e}), gradient norm {full[False][1]:.5f} vs "
          f"{full[True][1]:.5f} (rel {er_norm:.2e}) [{label}]")
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # E: checkpoint and resume
    n1, every, n2 = TRAIN_RESUME
    opt_e = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=n2)
    ck = tmp / "train_ckpt"
    # compression and stochastic rounding on, so that the error feedback
    # and the key are state the resume must carry
    mk = lambda steps, d: Trainer(cfg, opt_e, TrainConfig(
        steps=steps, checkpoint_every=every, checkpoint_dir=d,
        compress_grads=True, stochastic_rounding=True,
        log_every=1000), data, device=dev)
    with no_plain_gemm():
        first = mk(n1, str(ck)).run(verbose=False)
        steps_on_disk = sorted(int(p.name.split("-")[1])
                               for p in ck.glob("step-*"))
        second = mk(n2, str(ck)).run(verbose=False)
        whole = mk(n2, None).run(verbose=False)
    resumed = [h["step"] for h in second["history"]]
    if resumed != list(range(n1, n2)) or steps_on_disk != [every, n1]:
        raise AssertionError(f"train E: checkpoints {steps_on_disk}, resumed "
                             f"steps {resumed}")
    diffs = [abs(h["loss"] - w["loss"]) / abs(w["loss"])
             for h, w in zip(second["history"], whole["history"][n1:])]
    s2, sw = second["state"], whole["state"]
    state_diffs = {
        what: rel_norm_diff(tree_leaves(got), tree_leaves(want))
        for what, got, want in (
            ("params", s2["params"], sw["params"]),
            ("m", s2["opt"].m, sw["opt"].m), ("v", s2["opt"].v, sw["opt"].v),
            ("ef", s2["ef"], sw["ef"]))}
    steps_e = (s2["opt"].step, sw["opt"].step)
    if (max(diffs) > TRAIN_RESUME_RTOL
            or max(state_diffs.values()) > TRAIN_RESUME_RTOL
            or steps_e != (n2, n2)
            or not np.array_equal(s2["rng"], sw["rng"])):
        raise AssertionError(f"train E: resumed losses differ by {diffs}, "
                             f"the final state by {state_diffs}; AdamW "
                             f"steps {steps_e}; keys {s2['rng']} "
                             f"{sw['rng']}")
    phase("train", f"E: {n1} steps with checkpoint_every={every}, int8 "
          f"compression and stochastic rounding (async; on disk "
          f"{steps_on_disk}), a new Trainer resumed at {resumed[0]} and ran "
          f"steps {resumed}: losses "
          f"{[round(h['loss'], 5) for h in second['history']]} vs "
          f"uninterrupted {[round(w['loss'], 5) for w in whole['history'][n1:]]} "
          f"(rel diff {max(diffs):.2e}); the final state's rel norm diff "
          f"{ {k: f'{v:.2e}' for k, v in state_diffs.items()} }, AdamW step "
          f"{steps_e[0]} in both, the same key; all held to "
          f"{TRAIN_RESUME_RTOL}")
    del first, second, whole
    gc.collect()
    torch.cuda.empty_cache()

    # F: the example's settings, then the other families at SMOKE
    tc_f = TrainConfig(steps=4, microbatches=2, compress_grads=True)
    tr = Trainer(cfg, opt, tc_f, data, device=dev)
    with no_plain_gemm():
        st = init_train_state(cfg, opt, tc_f, dev)
        ef_norms = []
        for step in range(4):
            st, m = tr.step_fn(st, tr.batch(step))
            ef_norms.append(float(m["ef_norm"]))
            if not (math.isfinite(float(m["loss"])) and math.isfinite(
                    float(m["grad_norm"])) and math.isfinite(ef_norms[-1])):
                raise AssertionError(f"train F: step {step} metrics {m}")
    del st, tr
    smoke = {}
    for arch in TRAIN_SMOKE_ARCHS:
        scfg = smoke_config(arch)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = init_params(scfg, g)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        rng = np.random.default_rng(0)
        sb = {"tokens": torch.as_tensor(rng.integers(0, scfg.vocab, (2, 32)),
                                        device=dev)}
        if scfg.frontend == "vision":
            sb["patch_embeds"] = torch.randn(
                (2, scfg.n_frontend_tokens, scfg.d_model), generator=g,
                device=dev)
        if scfg.is_encdec:
            sb["encoder_embeds"] = torch.randn(
                (2, scfg.encoder_len, scfg.d_model), generator=g, device=dev)
        l0 = kmatmul.launches
        with no_plain_gemm():
            loss, _ = loss_fn(params, scfg, sb)
            grads = torch.autograd.grad(loss, tree_leaves(params),
                                        allow_unused=True,
                                        materialize_grads=True)
        n = kmatmul.launches - l0
        loss = float(loss.detach())
        ok = math.isfinite(loss) and all(
            bool(torch.isfinite(gr).all()) for gr in grads)
        if not (ok and n):
            raise AssertionError(f"train F: {arch} loss {loss}, "
                                 f"{n} GEMM launches, finite grads {ok}")
        smoke[arch] = (round(loss, 4), n)
    phase("train", f"F: 4 full-width steps at microbatches=2 with int8 "
          f"compression: ef_norm {[round(e, 4) for e in ef_norms]}, all "
          f"finite; one step of each family at SMOKE (fp32, the SIMT GEMM), "
          f"(loss, GEMM launches): {smoke}")

    # G: the launcher in a process of its own, on the card by default
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "smollm-135m", "--steps", "3"],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env={**os.environ,
                                      "PYTHONPATH": str(ROOT / "src")})
    if r.returncode != 0 or "final loss" not in r.stdout:
        raise AssertionError(f"train G: launcher exit {r.returncode}: "
                             f"{r.stdout[-500:]} {r.stderr[-2000:]}")
    last = r.stdout.strip().splitlines()[-1]
    wall = time.perf_counter() - t_phase
    phase("train", f"G: python -m repro_torch.launch.train --arch "
          f"smollm-135m --steps 3 exited 0 in {time.perf_counter() - t0:.1f} "
          f"s: {last!r}; phase wall {wall:.1f} s")
    clear_store()
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "reduces": reduces, "wall_a_ms": wall_a,
            "wall_b_ms": wall_b, "rows_c": rows_c, "sums": dict(sums),
            "copy_ms": copy_ms, "split": split, "tflops": tflops_a,
            "wall_s": wall}


PARALLEL_LAYERS = 2                # dbrx-132b's depth in the parallel phase
PARALLEL_B, PARALLEL_S = 4, 32     # its prompts
PARALLEL_REPS = 3                  # timed calls of each path
PARALLEL_GRAD_TOL = 1e-2           # loss_fn grads, relative norm
PIPE_MICRO, PIPE_MB, PIPE_S = 4, 2, 64   # the pipeline's microbatches
PLACED_B, PLACED_S = 8, 512        # SmolLM-135M's placed training step
DECODE_STEPS = {"smollm": 16, "mamba": 8, "dbrx": 8}   # placed decode steps
DECODE_TOL = 1e-3                  # decode logits, relative to their max
MAMBA_TRAIN_LAYERS = 8             # mamba2-1.3b's depth in its placed step


def check_bytes(ops: list, want: dict, what: str) -> dict:
    got = collective_bytes(ops)
    if got != want:
        raise AssertionError(f"parallel: {what}: collective bytes {got}, "
                             f"the formula {want}")
    return got


def phase_parallel(dev: torch.device, tmp: Path, label: str) -> dict:
    """The multi-device path on one card: a 1-rank NCCL process group
    (rendezvous through a file under the run's temp directory, no
    fallback to another backend or device) and ``make_host_mesh(model=1)``
    on the card, so every collective runs through NCCL over a group of
    one.

    dbrx-132b at full width (d_model 6144, 16 experts top-4, bf16, random
    weights from seed 0), cut to :data:`PARALLEL_LAYERS` layers: a 4 x
    32-token ``prefill`` under ``use_rules(mesh)`` through ``moe_ep``
    (``moe_a2a=False``) and ``moe_ep_a2a`` (``True``), each bitwise equal
    to the no-mesh prefill in logits and K/V rows, its GEMM launches > 0
    and its recorded collective bytes the formula's
    (``analysis.comm.moe_bytes`` a layer); one ``loss_fn`` forward and
    backward through ``moe_ep``, its gradients within
    :data:`PARALLEL_GRAD_TOL` relative norm of the no-mesh step's.  Then
    ``pipeline_apply`` over one stage whose ``stage_fn`` is SmolLM-135M's
    30 layers through the model's layer walk, on 4 microbatches of hidden
    states: bitwise the plain walk, GEMM launches > 0, its bytes the
    formula's.  Then the FSDP/TP placements (``use_rules(mesh,
    placed=True)`` on ``shard_params`` / ``shard_batch``): dbrx's
    ``loss_fn`` step through ``moe_ep`` on the batch shard and
    SmolLM-135M's at full width, all 30 layers, on 8 x 512 tokens, each
    within :data:`PARALLEL_GRAD_TOL` of the no-mesh step with equal GEMM
    launches (SmolLM's collective bytes ``analysis.comm.placed_bytes``'s),
    and SmolLM's 4 x 32 prefill bitwise the no-mesh one
    (:func:`placed_train`, :func:`placed_prefill`).  The ms of each path,
    median of :data:`PARALLEL_REPS` calls between synchronisations."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv-nccl",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh(model=1, device=dev)
        if (tuple(mesh.shape), tuple(mesh.mesh_dim_names)) != (
                (1, 1), ("data", "model")) or mesh.device_type != "cuda":
            raise AssertionError(f"parallel: host mesh {mesh}")
        return parallel_checks(dev, mesh, label, t_phase)
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def parallel_checks(dev: torch.device, mesh, label: str,
                    t_phase: float) -> dict:
    full = get_config("dbrx-132b")
    B, S = PARALLEL_B, PARALLEL_S
    ms, counts, nbytes_by_path = {}, {}, {}
    base = dataclasses.replace(full, n_layers=PARALLEL_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(base, gen)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, base.vocab, (B, S))).to(dev)

    def run_prefill(cfg):
        cache = init_cache(cfg, B, S, dev)
        with torch.no_grad():
            logits, cache = prefill(params, cfg, {"tokens": tokens}, cache)
        return logits, cache

    def kv(cache):
        return [t for pos in cache.values() for t in pos["attn"].values()]

    want_logits, want_cache = run_prefill(base)
    ms["prefill_no_mesh"] = median_ms(lambda: run_prefill(base),
                                      PARALLEL_REPS)
    for a2a, path in ((False, "moe_ep"), (True, "moe_ep_a2a")):
        cfg = dataclasses.replace(base, moe_a2a=a2a)
        reset_launches()
        with shd.use_rules(mesh), comm.record() as ops:
            logits, cache = run_prefill(cfg)
        counts[path] = read_launches()
        one = comm.moe_bytes(path, B=B, S=S, D=cfg.d_model,
                             n_experts=cfg.n_experts, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor, tp=1,
                             itemsize=logits.new_empty((), dtype=cfg.dtype
                                                       ).element_size())
        nbytes_by_path[path] = check_bytes(
            ops, {k: cfg.n_layers * v for k, v in one.items()}, path)
        kinds = sorted({op.kind for op in ops})
        if not torch.equal(logits, want_logits) or not all(
                torch.equal(g, w) for g, w in zip(kv(cache), kv(want_cache),
                                                  strict=True)):
            raise AssertionError(f"parallel: {path} prefill differs from the "
                                 f"no-mesh prefill")
        if not counts[path]["gemm"]:
            raise AssertionError(f"parallel: {path} launched no GEMM")
        with shd.use_rules(mesh):
            ms[path] = median_ms(lambda: run_prefill(cfg), PARALLEL_REPS)
        phase("parallel", f"{base.name} ({cfg.n_layers} of {full.n_layers} "
              f"layers, d_model {cfg.d_model}, {cfg.n_experts} experts "
              f"top-{cfg.top_k}, {str(cfg.dtype)[6:]}) {B} x {S}-token "
              f"prefill through "
              f"{path} on the 1-rank NCCL mesh: logits and K/V rows "
              f"bitwise the no-mesh prefill's; launches {counts[path]}; "
              f"collectives {kinds}, bytes {nbytes_by_path[path]} = "
              f"{cfg.n_layers} x the formula; {ms[path]:.2f} ms vs "
              f"{ms['prefill_no_mesh']:.2f} ms with no mesh ({label})")
    del want_cache

    # one training step's gradients through moe_ep against the no-mesh ones
    batch = {"tokens": tokens}
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)

    def grads():
        for t in leaves:
            t.grad = None
        loss, _ = loss_fn(params, base, batch)
        loss.backward()
        return float(loss.detach()), [t.grad for t in leaves]

    loss0, want = grads()
    want = [g.clone() for g in want]
    reset_launches()
    with shd.use_rules(mesh), comm.record() as ops:
        loss1, got = grads()
    counts["loss_fn"] = read_launches()
    kinds = sorted({op.kind for op in ops})
    err = rel_norm_diff(got, want)
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    del want, got
    if not (err <= PARALLEL_GRAD_TOL and math.isfinite(loss1)
            and counts["loss_fn"]["gemm"] and "all-reduce" in kinds):
        raise AssertionError(f"parallel: loss_fn through moe_ep: grads "
                             f"{err:.3e} from the no-mesh step's, loss "
                             f"{loss1} ({loss0} no mesh), launches "
                             f"{counts['loss_fn']}, collectives {kinds}")
    phase("parallel", f"loss_fn forward and backward through moe_ep: loss "
          f"{loss1:.6f} ({loss0:.6f} no mesh), gradients {err:.3e} relative "
          f"norm from the no-mesh step's (limit {PARALLEL_GRAD_TOL}); "
          f"collectives {kinds}; launches {counts['loss_fn']}")
    del leaves
    gc.collect()
    torch.cuda.empty_cache()
    placed = {"dbrx": placed_train(base, params, batch, mesh, "dbrx", label),
              "dbrx_decode": placed_decode(base, params, tokens,
                                           DECODE_STEPS["dbrx"], mesh, label)}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the gpipe pipeline over one stage: SmolLM-135M's 30 layers a stage
    cfg = get_config("smollm-135m")
    gen.manual_seed(0)
    sparams = init_params(cfg, gen)
    hidden = torch.randn((PIPE_MICRO, PIPE_MB, PIPE_S, cfg.d_model),
                         generator=gen, device=dev).to(cfg.dtype)
    positions = torch.arange(PIPE_S, device=dev)

    def walk(layers, h):
        return model_run_stack(cfg, layers, h, pattern=cfg.pattern,
                               positions=positions, causal=True)[0]

    stages = stage_split(sparams["layers"], 1)
    stage_mesh = make_mesh((1,), ("stage",), dev)
    with torch.no_grad():
        plain = torch.stack([walk(sparams["layers"], h) for h in hidden])
        ms["walk"] = median_ms(lambda: [walk(sparams["layers"], h)
                                        for h in hidden], PARALLEL_REPS)
        reset_launches()
        with comm.record() as ops:
            got = pipeline_apply(walk, stages, hidden, mesh=stage_mesh)
        counts["pipeline"] = read_launches()
        ms["pipeline"] = median_ms(lambda: pipeline_apply(
            walk, stages, hidden, mesh=stage_mesh), PARALLEL_REPS)
    nbytes_by_path["pipeline"] = check_bytes(ops, comm.pipeline_bytes(
        n_micro=PIPE_MICRO, n_stages=1,
        micro_bytes=hidden[0].numel() * hidden.element_size()), "pipeline")
    if not torch.equal(got, plain) or not counts["pipeline"]["gemm"]:
        raise AssertionError(f"parallel: pipeline vs the plain walk: equal "
                             f"{torch.equal(got, plain)}, launches "
                             f"{counts['pipeline']}")
    phase("parallel", f"pipeline_apply over one stage ({cfg.name}, "
          f"{cfg.n_layers} layers a stage, {PIPE_MICRO} microbatches of "
          f"{PIPE_MB} x {PIPE_S} hidden states): bitwise the plain walk; "
          f"launches {counts['pipeline']}; bytes "
          f"{nbytes_by_path['pipeline']}; {ms['pipeline']:.2f} ms vs "
          f"{ms['walk']:.2f} ms for the plain walk ({label})")
    del stages, hidden, plain, got
    # the FSDP/TP placements: SmolLM-135M's whole training step and a
    # prefill, through shard_params / shard_batch and every collective
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (PLACED_B, PLACED_S))).to(dev)
    placed["smollm"] = placed_train(cfg, sparams, {"tokens": tokens}, mesh,
                                    "smollm", label)
    placed["smollm_prefill"] = placed_prefill(cfg, sparams, tokens[
        :PARALLEL_B, :PARALLEL_S], mesh, label)
    placed["smollm_decode"] = placed_decode(cfg, sparams, tokens[
        :PARALLEL_B, :PARALLEL_S], DECODE_STEPS["smollm"], mesh, label)
    del sparams
    gc.collect()
    torch.cuda.empty_cache()
    # Mamba's head-parallel TP: mamba2-1.3b whole for decode, cut for a step
    cfg = get_config("mamba2-1.3b")
    gen.manual_seed(0)
    mparams = init_params(cfg, gen)
    placed["mamba_decode"] = placed_decode(cfg, mparams, tokens[
        :PARALLEL_B, :PARALLEL_S], DECODE_STEPS["mamba"], mesh, label)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, n_layers=MAMBA_TRAIN_LAYERS)
    gen.manual_seed(0)
    mparams = init_params(cfg, gen)
    placed["mamba"] = placed_train(cfg, mparams, {"tokens": tokens}, mesh,
                                   "mamba", label)
    del mparams
    for name, got in placed.items():
        counts[f"placed_{name}"] = got["counts"]
        ms.update({f"placed_{name}_{k}": v for k, v in got["ms"].items()})
        nbytes_by_path[f"placed_{name}"] = got["bytes"]
    wall = time.perf_counter() - t_phase
    phase("parallel", f"phase wall {wall:.1f} s")
    total = {k: sum(c[k] for c in counts.values())
             for k in next(iter(counts.values()))}
    return {"counts": total, "by_path": counts, "ms": ms,
            "bytes": nbytes_by_path, "placed": placed, "wall_s": wall}


def _grads_of(cfg, params, batch, mesh=None):
    """(loss, every leaf's gradient) of ``loss_fn``; under ``mesh`` placed
    (``params``, ``batch``: the rank's shards)."""
    leaves = tree_leaves(params)
    ctx = (shd.use_rules(mesh, placed=True) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        loss, _ = loss_fn(params, cfg, batch)
        # a (mamba, none) layer's norm2 takes no part: a zero gradient
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return float(loss.detach()), grads


def placed_train(cfg, params, batch, mesh, name: str, label: str) -> dict:
    """One ``loss_fn`` forward and backward of ``cfg`` on ``batch``
    through ``shard_params`` / ``shard_batch`` and the placed path on the
    1-rank mesh, against the step with no mesh: the loss and every
    gradient within :data:`PARALLEL_GRAD_TOL` (relative norm), GEMM
    launches > 0 and equal; for a dense decoder the collective bytes
    ``analysis.comm.placed_bytes`` gives; the ms of each (median of
    :data:`PARALLEL_REPS`)."""
    whole = tree_map(lambda t: t.detach().requires_grad_(True), params)
    shards = tree_map(lambda t: t.detach().requires_grad_(True),
                      shd.shard_params(params, mesh))
    rows = shd.shard_batch(batch, mesh)
    reset_launches()
    loss0, want = _grads_of(cfg, whole, batch)
    counts0 = read_launches()
    reset_launches()
    with comm.record() as ops:
        loss1, got = _grads_of(cfg, shards, rows, mesh)
    counts = read_launches()
    err = rel_norm_diff(got, want)
    del got, want
    nbytes = collective_bytes(ops)
    kinds = sorted({op.kind for op in ops})
    B, S = batch["tokens"].shape
    formula = None
    if cfg.pattern == (("attn", "dense"),):
        formula = comm.placed_bytes(cfg, B=B, S=S, sizes=shd.mesh_axes(mesh),
                                    kind="train")
    ms = {"no_mesh": median_ms(lambda: _grads_of(cfg, whole, batch),
                               PARALLEL_REPS),
          "placed": median_ms(lambda: _grads_of(cfg, shards, rows, mesh),
                              PARALLEL_REPS)}
    if not (err <= PARALLEL_GRAD_TOL and math.isfinite(loss1)
            and counts["gemm"] and counts == counts0
            and {"all-gather", "reduce-scatter", "all-reduce"} <= set(kinds)
            and formula in (None, nbytes)):
        raise AssertionError(f"parallel: {name} placed step: grads {err:.3e} "
                             f"from the no-mesh step's, loss {loss1} "
                             f"({loss0} no mesh), launches {counts} (no mesh "
                             f"{counts0}), collectives {nbytes}, formula "
                             f"{formula}")
    phase("parallel", f"{cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {str(cfg.dtype)[6:]}) placed training step on "
          f"{B} x {S} tokens (shard_params, shard_batch, FSDP gathers, "
          f"seq gather/scatter, vocab-parallel loss, gradients reduced) on "
          f"the 1-rank NCCL mesh: loss {loss1:.6f} ({loss0:.6f} no mesh), "
          f"gradients {err:.3e} relative norm from the no-mesh step's "
          f"(limit {PARALLEL_GRAD_TOL}); launches {counts} = no mesh's; "
          f"collectives {kinds}, bytes {nbytes}"
          + (" = analysis.comm.placed_bytes" if formula else "")
          + f"; forward and backward {ms['placed']:.2f} ms vs "
          f"{ms['no_mesh']:.2f} ms with no mesh: "
          f"{ms['placed'] - ms['no_mesh']:+.2f} ms of placed-path host "
          f"cost ({label})")
    return {"counts": counts, "ms": ms, "bytes": nbytes, "err": err,
            "loss": loss1, "loss_no_mesh": loss0}


def placed_prefill(cfg, params, tokens, mesh, label: str) -> dict:
    """A prefill of ``tokens`` placed on the 1-rank mesh: logits and K/V
    rows bitwise the no-mesh prefill's, GEMM launches > 0 and equal, the
    collective bytes ``analysis.comm.placed_bytes``'s."""
    B, S = tokens.shape
    dev = tokens.device
    shards = shd.shard_params(params, mesh)
    rows = shd.shard_batch({"tokens": tokens}, mesh)

    def run(placed: bool):
        cache = init_cache(cfg, B, S, dev)
        ctx = (shd.use_rules(mesh, placed=True) if placed
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            return prefill(shards if placed else params, cfg,
                           rows if placed else {"tokens": tokens}, cache)

    reset_launches()
    want, want_c = run(False)
    counts0 = read_launches()
    reset_launches()
    with comm.record() as ops:
        got, got_c = run(True)
    counts = read_launches()
    kv = lambda c: [t for pos in c.values() for t in pos["attn"].values()]
    same = torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(kv(got_c), kv(want_c), strict=True))
    nbytes = collective_bytes(ops)
    formula = comm.placed_bytes(cfg, B=B, S=S, sizes=shd.mesh_axes(mesh),
                                kind="prefill")
    ms = {"no_mesh": median_ms(lambda: run(False), PARALLEL_REPS),
          "placed": median_ms(lambda: run(True), PARALLEL_REPS)}
    if not (same and counts["gemm"] and counts == counts0
            and nbytes == formula):
        raise AssertionError(f"parallel: placed prefill: bitwise {same}, "
                             f"launches {counts} (no mesh {counts0}), bytes "
                             f"{nbytes}, formula {formula}")
    phase("parallel", f"{cfg.name} placed {B} x {S}-token prefill on the "
          f"1-rank NCCL mesh: logits and K/V rows bitwise the no-mesh "
          f"prefill's; launches {counts} = no mesh's; bytes {nbytes} = "
          f"analysis.comm.placed_bytes; {ms['placed']:.2f} ms vs "
          f"{ms['no_mesh']:.2f} ms with no mesh ({label})")
    return {"counts": counts, "ms": ms, "bytes": nbytes}


def placed_decode(cfg, params, prompt, steps: int, mesh, label: str) -> dict:
    """A prefill of ``prompt`` (B, S) into a cache of ``S + steps``
    positions rounded up to 64, then ``steps`` greedy decode steps with
    per-slot (B,) indices, placed on the 1-rank mesh (``shard_params``,
    ``shard_batch``, ``shard_cache``) against the same with no mesh:
    every step's logits bitwise or within :data:`DECODE_TOL` of their max
    (which is printed), the greedy tokens equal, GEMM launches > 0 and
    equal; for a dense decoder the collective bytes ``placed_bytes``'s
    (the prefill and each step); the ms of one decode step each way
    (median of :data:`PARALLEL_REPS`)."""
    B, S = prompt.shape
    dev = prompt.device
    L = -(-(S + steps) // 64) * 64
    shards = shd.shard_params(params, mesh)

    def ctx(placed: bool):
        return (shd.use_rules(mesh, placed=True) if placed
                else contextlib.nullcontext())

    def run(placed: bool):
        p = shards if placed else params
        cache = init_cache(cfg, B, L, dev)
        if placed:
            cache = shd.shard_cache(cache, mesh)
        batch = {"tokens": prompt}
        out, toks = [], []
        with torch.no_grad(), ctx(placed):
            if placed:
                batch = shd.shard_batch(batch, mesh)
            lg, cache = prefill(p, cfg, batch, cache)
            for t in range(steps + 1):
                out.append(lg)
                toks.append(lg.argmax(-1))
                if t == steps:
                    break
                step = {"tokens": toks[-1][:, None],
                        "index": torch.full((B,), S + t, device=dev)}
                if placed:
                    step = shd.shard_batch(step, mesh, whole_rows=True)
                lg, cache = decode_step(p, cfg, step["tokens"], cache,
                                        step["index"])
        return out, torch.stack(toks, 1), cache, step

    reset_launches()
    want, want_tok, want_cache, _ = run(False)
    counts0 = read_launches()
    reset_launches()
    with comm.record() as ops:
        got, got_tok, cache, step = run(True)
    counts = read_launches()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(got, want))
    nbytes = collective_bytes(ops)
    formula = None
    if cfg.pattern == (("attn", "dense"),):
        sizes = shd.mesh_axes(mesh)
        formula = comm.placed_bytes(cfg, B=B, S=S, sizes=sizes,
                                    kind="prefill")
        one = comm.placed_bytes(cfg, B=B, S=1, sizes=sizes, kind="decode")
        formula = {k: formula[k] + steps * one[k] for k in formula}

    def tick(placed: bool):
        # the last step again (a Mamba state advances once more: timed,
        # not compared)
        p, c = (shards, cache) if placed else (params, want_cache)
        with torch.no_grad(), ctx(placed):
            decode_step(p, cfg, step["tokens"], c, step["index"])

    ms = {"no_mesh": median_ms(lambda: tick(False), PARALLEL_REPS),
          "placed": median_ms(lambda: tick(True), PARALLEL_REPS)}
    kinds = sorted({op.kind for op in ops})
    if not (err <= DECODE_TOL and torch.equal(got_tok, want_tok)
            and counts["gemm"] and counts == counts0
            and formula in (None, nbytes)):
        raise AssertionError(f"parallel: {cfg.name} placed decode: logits "
                             f"{err:.3e} from the no-mesh steps' (bitwise "
                             f"{bitwise}), tokens equal "
                             f"{torch.equal(got_tok, want_tok)}, launches "
                             f"{counts} (no mesh {counts0}), bytes {nbytes}, "
                             f"formula {formula}")
    phase("parallel", f"{cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {str(cfg.dtype)[6:]}) placed {B} x {S}-token "
          f"prefill into a shard_cache cache of {L} positions, then "
          f"{steps} greedy decode steps with per-slot indices on the "
          f"1-rank NCCL mesh: logits "
          + ("bitwise the no-mesh steps'" if bitwise else
             f"{err:.3e} of their max from the no-mesh steps' (not bitwise; "
             f"limit {DECODE_TOL})")
          + f"; greedy tokens equal ({got_tok.shape[1]} a slot); launches "
          f"{counts} = no mesh's; collectives {kinds}, bytes {nbytes}"
          + (" = analysis.comm.placed_bytes" if formula else "")
          + f"; a decode step {ms['placed']:.2f} ms vs {ms['no_mesh']:.2f} "
          f"ms with no mesh: {ms['placed'] - ms['no_mesh']:+.2f} ms of "
          f"placed-path host cost ({label})")
    return {"counts": counts, "ms": ms, "bytes": nbytes, "err": err,
            "bitwise": bitwise}


# the dryrun phase: the two cells held against the card, then full-size
# cells through the CLI (a child process).  arctic-480b's train_4k stands
# for the 8-microbatch, bf16-state cells: llama3-405b's took 148.8 s of
# the GPU machine's host time, arctic's 59.4-107.0 s before the counting
# mode replayed repeated meta ops (PERF.md)
DRYRUN_CELLS = ("smollm-135m:train_4k:pod", "smollm-135m:prefill_32k:pod",
                "smollm-135m:decode_32k:pod", "dbrx-132b:prefill_32k:pod",
                "dbrx-132b:prefill_32k:multipod", "arctic-480b:train_4k:pod",
                "jamba-v0.1-52b:long_500k:multipod")
DRYRUN_V1 = Shape("v1_train_8x512", "train", 512, 8)     # the trainer's
DRYRUN_V2 = Shape("v2_prefill_4x32", "prefill", 32, 4)
DRYRUN_V2_LAYERS = 2                 # dbrx-132b's depth in V2
DRYRUN_V3 = Shape("v3_decode_16x32k", "decode", 32768, 16)  # SmolLM's
DRYRUN_WARMUP, DRYRUN_REPS = 2, 5    # the step's wall: median of REPS
# estimated temp over the measured peak above the held bytes: the limits
# PERF.md's prediction for the dryrun phase states
DRYRUN_MEM_RATIO = (0.95, 1.05)
DRYRUN_CHILD_TIMEOUT_S = 600
# what must equal, meta against the card
DRYRUN_EXACT = ("gemm_calls", "flops_gemm", "reduce_calls", "flops_aten",
                "bytes_accessed")

# V2's and V3's meta passes: rank 0 of a fake world of one, the host mesh
# on the CPU device type (the phase's NCCL group is another process's);
# arguments: arch, layers (0: all), kind, S, B
DRYRUN_PLACED_META = r"""
import dataclasses, json, sys
from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch, layers, kind, S, B = sys.argv[1:6]
cfg = get_config(arch)
if int(layers):
    cfg = dataclasses.replace(cfg, n_layers=int(layers))
compat.init_fake_world(1)
mesh = make_host_mesh(model=1, device="cpu")
print(json.dumps(dryrun.cell_artifact(cfg, Shape(kind, kind, int(S), int(B)),
                                      mesh, placed=True)))
"""


def split_k_store(shapes) -> RecordStore:
    """An in-memory store with one record per GEMM shape (M, N, K): the
    vendor heuristic's tile at k_split 4, else 2, where the kernel can
    launch it (else the heuristic's own config), so that a step resolved
    from it on the exact tier runs the split-K reduction pass.  Not tuned
    records: the phase holds counts, not speed."""
    store = RecordStore()
    for M, N, K in shapes:
        x = gemm_input(M, N, K)
        base = dispatch._heuristic_cfg("gemm", x)
        cfg = next((c for c in ({**base, "k_split": ks} for ks in (4, 2))
                    if launchable("gemm", c, x)), base)
        store.add(TuneRecord(space="gemm", inputs=x, config=cfg, tflops=0.0,
                             source="chip_smoke-dryrun"))
    return store


def dryrun_same(what: str, meta: dict, real: dict, coll: bool) -> None:
    """Fail unless the card's counts equal the dry-run's exactly; the
    aten ops whose counts differ are named."""
    diff = {k: (meta["cost"][k], real["cost"][k]) for k in DRYRUN_EXACT
            if meta["cost"][k] != real["cost"][k]}
    if coll and meta["collectives"] != real["collectives"]:
        diff["collectives"] = (meta["collectives"], real["collectives"])
    if diff:
        mo, ro = meta["cost"]["by_op"], real["cost"]["by_op"]
        ops_diff = {k: (mo.get(k), ro.get(k)) for k in sorted(set(mo) | set(ro))
                    if mo.get(k) != ro.get(k)}
        raise AssertionError(f"dryrun: {what}: the card's counts differ from "
                             f"the dry-run's (meta, card): {diff}; aten ops "
                             f"[calls, flops, bytes] that differ: "
                             f"{dict(list(ops_diff.items())[:16])}")


def dryrun_hold(what: str, cfg, shape, mesh_name: str, meta: dict, cell,
                dev: torch.device, coll: bool, label: str) -> dict:
    """The cell's step on the card: counted once (launches read), held to
    the meta counts; its wall (median of :data:`DRYRUN_REPS` after
    :data:`DRYRUN_WARMUP`, synchronised, counting off) against the
    roofline's largest term; the peak allocated above what was held
    before against the estimated temp."""
    reset_launches()
    real = dryrun.count_step(cell)
    launches = read_launches()
    dryrun_same(what, meta, real, coll)
    for _ in range(DRYRUN_WARMUP):
        cell.run()
    times = []
    for _ in range(DRYRUN_REPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = cell.run()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        del out
    wall = statistics.median(times)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    out = cell.run()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - held
    del out
    ratio = meta["memory"]["temp"] / peak
    art = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
           "chips": 1, "kind": shape.kind,
           "model_flops": model_flops(cfg, shape, kind=shape.kind),
           "cost": meta["cost"], "collectives": meta["collectives"]}
    rt = roofline_from_artifacts(art, recompute_model_flops=False)
    largest = max(rt.t_compute, rt.t_memory, rt.t_collective)
    c = meta["cost"]
    phase("dryrun", f"{what}: card = dry-run exactly: GEMM calls "
          f"{c['gemm_calls']}, sum 2MNK {c['flops_gemm']:.6e}, reduction "
          f"passes {c['reduce_calls']}, aten FLOPs {c['flops_aten']:.6e}, "
          f"bytes {c['bytes_accessed']:.6e}"
          + (f", collectives {meta['collectives']}" if coll else "")
          + f"; launches {launches}; temp estimated "
          f"{meta['memory']['temp'] / 1e9:.4f} GB against "
          f"{peak / 1e9:.4f} GB allocated above the {held / 1e9:.3f} GB "
          f"held (ratio {ratio:.4f}, limits {DRYRUN_MEM_RATIO}); argument "
          f"{meta['memory']['argument'] / 1e9:.4f} GB; step wall "
          f"{1e3 * wall:.2f} ms (median of {DRYRUN_REPS}) against the "
          f"roofline's {rt.bottleneck} term {1e3 * largest:.4f} ms: "
          f"{largest / wall:.2%} of the roofline ({label})")
    if not DRYRUN_MEM_RATIO[0] <= ratio <= DRYRUN_MEM_RATIO[1]:
        raise AssertionError(f"dryrun: {what}: memory ratio {ratio:.4f} "
                             f"outside {DRYRUN_MEM_RATIO}")
    return {"launches": launches, "wall_ms": 1e3 * wall, "peak": peak,
            "held": held, "ratio": ratio, "roofline_ms": 1e3 * largest,
            "bottleneck": rt.bottleneck, "fraction": largest / wall,
            "cost": {k: c[k] for k in DRYRUN_EXACT},
            "collectives": meta["collectives"]}


def phase_dryrun(dev: torch.device, tmp: Path, label: str) -> dict:
    """The dry-run (``launch/dryrun.py``).  B first: three cells both
    ways, the dry-run on meta and the same step on the card: V1
    SmolLM-135M's training step at 8 x 512 (no mesh) from an in-memory
    store of split-K records (:func:`split_k_store`; exact tier), V2
    dbrx-132b at 2 of 40 layers, a 4 x 32 prefill, and V3 SmolLM-135M's
    decode step over a 16 x 32768 cache, both placed under
    ``make_host_mesh(model=1)`` in a 1-rank NCCL group (their meta passes
    in children, fake worlds of one, which have exited before V1's step
    is timed), nothing installed.  GEMM calls, sum 2·M·N·K, reduction
    passes, aten FLOPs and bytes (V2, V3: the collective bytes too) must
    equal exactly; the real runs launch the
    GEMM kernel, V1 the reduction pass too; the meta passes launch
    nothing.  Then A, with no step being timed: the full-size cells of
    :data:`DRYRUN_CELLS` through ``python -m repro_torch.launch.dryrun``
    in a child process (its fake worlds never meet this process's NCCL
    group); each cell's wall, per-rank FLOPs, bytes, collective bytes and
    peak, ``fits`` and roofline row printed."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    if serving_state().store is not None or serving_state().models is not None:
        raise AssertionError("dryrun: a store or models are installed")
    out_dir = tmp / "dryrun_torch"
    metas = {name: Child(f"dryrun-{name}-meta", [
        sys.executable, "-c", DRYRUN_PLACED_META, arch, str(layers),
        shape.kind, str(shape.seq_len), str(shape.global_batch)],
        tmp / f"dryrun_{name}_meta.log") for name, arch, layers, shape in (
            ("v2", "dbrx-132b", DRYRUN_V2_LAYERS, DRYRUN_V2),
            ("v3", "smollm-135m", 0, DRYRUN_V3))}
    children = list(metas.values())
    try:
        held = {}
        # V1: no mesh, the meta pass here
        cfg = get_config("smollm-135m")
        M = DRYRUN_V1.global_batch * DRYRUN_V1.seq_len
        install_serving(store=split_k_store(train_step_shapes(cfg, M)[
            "calls"]), models=None, fingerprint=None, build_plan=False)
        try:
            reset_launches()
            t0 = time.perf_counter()
            meta = dryrun.count_step(dryrun.build_cell(cfg, DRYRUN_V1))
            meta_s = time.perf_counter() - t0
            if any(read_launches().values()):
                raise AssertionError(f"dryrun: V1's meta pass launched "
                                     f"{read_launches()}")
            cell = dryrun.build_cell(cfg, DRYRUN_V1, device=dev, seed=0)
            lines = {name: child.wait_line(lambda ln: ln.startswith("{"),
                                           f"{name}'s dry-run JSON",
                                           DRYRUN_CHILD_TIMEOUT_S)
                     for name, child in metas.items()}
            for child in metas.values():
                child.wait_exit(0, DRYRUN_CHILD_TIMEOUT_S)
            held["v1"] = dryrun_hold(
                f"V1 {cfg.name} train {DRYRUN_V1.global_batch} x "
                f"{DRYRUN_V1.seq_len} (meta pass {meta_s:.1f} s, "
                f"resolutions {meta['resolutions']})", cfg, DRYRUN_V1,
                "none", meta, cell, dev, False, label)
            del cell
        finally:
            install_serving(store=None, models=None, fingerprint=None,
                            build_plan=False)
        if not (held["v1"]["launches"]["gemm"]
                and held["v1"]["launches"]["gemm_reduce"]):
            raise AssertionError(f"dryrun: V1 launches {held['v1']}")
        gc.collect()
        torch.cuda.empty_cache()

        # V2: dbrx-132b at 2 layers under the host mesh in a 1-rank group
        cfg = dataclasses.replace(get_config("dbrx-132b"),
                                  n_layers=DRYRUN_V2_LAYERS)
        meta = json.loads(lines["v2"])
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv-dry",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_host_mesh(model=1, device=dev)
            cell = dryrun.build_cell(cfg, DRYRUN_V2, mesh, device=dev, seed=0,
                                     placed=True)
            held["v2"] = dryrun_hold(
                f"V2 {cfg.name} ({cfg.n_layers} of 40 layers) prefill "
                f"{DRYRUN_V2.global_batch} x {DRYRUN_V2.seq_len} on the "
                f"1-rank NCCL host mesh (meta pass {meta['wall_s']:.1f} s in "
                f"a fake world of one, resolutions {meta['resolutions']})",
                cfg, DRYRUN_V2, "host", meta, cell, dev, True, label)
            del cell
            gc.collect()
            torch.cuda.empty_cache()
            # V3: SmolLM-135M's decode step, placed, a cache of 16 x 32768
            cfg = get_config("smollm-135m")
            meta = json.loads(lines["v3"])
            cell = dryrun.build_cell(cfg, DRYRUN_V3, mesh, device=dev, seed=0,
                                     placed=True)
            held["v3"] = dryrun_hold(
                f"V3 {cfg.name} decode step, {DRYRUN_V3.global_batch} slots "
                f"x a {DRYRUN_V3.seq_len}-position cache, on the 1-rank NCCL "
                f"host mesh (meta pass {meta['wall_s']:.1f} s in a fake world "
                f"of one, resolutions {meta['resolutions']})",
                cfg, DRYRUN_V3, "host", meta, cell, dev, True, label)
            del cell
        finally:
            dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()
        for v in ("v2", "v3"):
            if not held[v]["launches"]["gemm"] or \
                    not held[v]["collectives"]["total"]:
                raise AssertionError(f"dryrun: {v} {held[v]}")
        held_s = time.perf_counter() - t_phase

        # A: the CLI's full-size cells, with no step being timed
        t_cells = time.perf_counter()
        children.append(Child(
            "dryrun-cells", [sys.executable, "-m", "repro_torch.launch.dryrun",
                             "--force", "--out", str(out_dir)]
            + [a for c in DRYRUN_CELLS for a in ("--cell", c)],
            tmp / "dryrun_cells.log"))
        children[-1].wait_exit(0, DRYRUN_CHILD_TIMEOUT_S)
        cells_s = time.perf_counter() - t_cells
    finally:
        left = [c.name for c in children if c.proc.poll() is None]
        for c in children:
            if c.proc.poll() is None:
                c.kill()
        Child.ALL = [c for c in Child.ALL if c not in children]
    if left:
        raise AssertionError(f"dryrun: children left running: {left}")
    rows, walls = [], {}
    for spec in DRYRUN_CELLS:
        arch, shape_name, mesh_name = spec.split(":")
        art = json.loads(dryrun.artifact_path(arch, shape_name, mesh_name,
                                              out=out_dir).read_text())
        c, m = art.get("cost", {}), art.get("memory", {})
        if "skipped" in art or not all(
                math.isfinite(v) and v > 0 for v in (
                    c["flops"], c["bytes_accessed"], m["peak_per_device"])):
            raise AssertionError(f"dryrun: {spec}: {art}")
        rt = roofline_from_artifacts(art)
        rows.append(rt)
        walls[spec] = art["wall_s"]
        phase("dryrun", f"{spec}: wall {art['wall_s']:.1f} s, flops/dev "
              f"{c['flops']:.4e}, bytes/dev {c['bytes_accessed']:.4e}, "
              f"coll/dev {art['collectives']['total']:.4e} B, peak/dev "
              f"{m['peak_per_device'] / 1e9:.2f} GB (argument "
              f"{m['argument'] / 1e9:.2f}, temp {m['temp'] / 1e9:.2f}), fits "
              f"{m['fits']}; roofline compute {rt.t_compute * 1e3:.2f} ms, "
              f"memory {rt.t_memory * 1e3:.2f} ms, collective "
              f"{rt.t_collective * 1e3:.2f} ms, {rt.bottleneck}-bound, "
              f"MODEL/HLO {rt.useful_ratio:.4f}, roofline fraction "
              f"{rt.roofline_fraction:.2%}; GEMM calls {c['gemm_calls']}")
    if not any(r.collective_bytes_per_device for r in rows):
        raise AssertionError("dryrun: no full-size cell made a collective")
    print(format_table(rows, title="dry-run roofline of the full-size cells "
                       "(model figures at H100 SXM peaks, not card "
                       "measurements)"), flush=True)
    wall = time.perf_counter() - t_phase
    launches = {k: sum(h["launches"][k] for h in held.values())
                for k in held["v1"]["launches"]}
    phase("dryrun", f"the cells' walls {walls} ({sum(walls.values()):.1f} s "
          f"in the child); launches on the "
          f"dryrun path (V1's, V2's and V3's counted card runs) "
          f"{launches}; phase wall {wall:.1f} s: V1, V2 and V3 "
          f"{held_s:.1f} s, then the cells "
          f"{cells_s:.1f} s")
    return {"counts": launches, "held": held, "cell_walls": walls,
            "wall_s": wall, "held_s": held_s, "cells_s": cells_s}


REPLACES = {"gemm": "src/repro/kernels/matmul.py:36",
            "conv": "src/repro/kernels/conv.py:38",
            "attention": "src/repro/kernels/attention.py:29",
            "ssd": "src/repro/kernels/ssd.py:28",
            "gemm_reduce": "src/repro/kernels/ops.py:61"}


def kernels_line(rows: dict, worst: dict, launches: dict, n_layers: int
                 ) -> dict:
    """One row per hand-written kernel: the four ported TPU kernels, then
    the GEMM's split-K reduction pass (``gemm_reduce``).  GEMM and its
    reduction: times summed over one decode
    tick's projections; conv: summed over the 14 Table 5 shapes, one call
    each; attention and SSD: summed over their tune targets, one call each.
    ``ms`` is the tuned config's kernel time.  ``launches`` is the count on
    the kernel's own path (serve for the GEMM, tune for the rest): the
    wrapper's count, so for serving the launches of the graphs' captures
    and their warm-ups, from the warm-up run through the graph runs (a
    replay launches from its graph, not the wrapper; the GEMM row's ``device_launches`` is the
    count of GEMM kernels given to the device in the measured graph run:
    the captured tick's GEMM nodes times its replays plus the 32-token
    prefill graph's times its replays); ``launches_by_path`` gives every
    path's (serve_mamba: the mamba phase's, serve_moe: the moe phase's);
    ``main`` adds the GEMM and reduction rows' ``device_launches_by_path``
    (serve, serve_retune, serve_mamba, serve_moe, serve_encdec,
    serve_frontend)."""
    per = {"gemm": "one decode tick: 210 projections at M=4, tuned configs",
           "conv": "the 14 Table 5 shapes, bf16, one call each, tuned configs",
           "attention": "the 4 attention targets, bf16, one call each, tuned "
                        "configs",
           "ssd": "the 2 SSD targets, bf16, one call each, tuned configs"}
    path = {"gemm": "serve", "conv": "tune", "attention": "tune",
            "ssd": "tune"}
    out = []
    for name in KERNELS:
        if name == "gemm":
            tot = lambda key: per_tick(rows["gemm"], key, n_layers)
        else:
            tot = lambda key, n=name: sum(r[key] for r in rows[n])
        t_bytes, t_ops = tot("t_bytes"), tot("t_ops")
        alt = "heuristic_ms" if name in ("gemm", "conv") else "default_ms"
        library = None if name == "ssd" else tot("library_ms")
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[path[name]][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": worst[name]["abs"],
            "max_rel_err": worst[name]["rel"],
            "ms": tot("kernel_ms"), "kernel_ms": tot("kernel_ms"),
            alt: tot(alt), "plain_ms": tot("plain_ms"),
            "library_ms": library,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "per": per[name],
            "shapes": [{k: r[k] for k in r if k not in ("t_bytes", "t_ops")}
                       for r in rows[name]]})
        if name == "ssd":
            # the rate by 4·B·L·H·P·S over the targets' summed time
            out[-1]["tflops"] = tot("flops") / (tot("kernel_ms") * 1e-3) / 1e12
    # the GEMM's split-K reduction pass, over the same decode tick
    tot = lambda key: per_tick(rows["gemm"], key, n_layers)
    t_bytes, t_ops = tot("reduce_t_bytes"), tot("reduce_t_ops")
    out.append({
        "name": "gemm_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": REPLACES["gemm_reduce"],
        "note": "not a TPU kernel: the reference sums the split-K partials "
                "with parts.sum(axis=0) in ops.matmul",
        "launches": launches["serve"]["gemm_reduce"],
        "launches_by_path": {p: c["gemm_reduce"] for p, c in launches.items()},
        "max_abs_err": worst["gemm"]["reduce_abs"],
        "max_ulp": worst["gemm"]["reduce_ulp"],
        "ms": tot("reduce_ms"), "plain_ms": tot("reduce_plain_ms"),
        "library_ms": tot("reduce_library_ms"),
        "library": "parts.sum(dim=0)",
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "per": "one decode tick: the projections at M=4 whose tuned config "
               "splits K"})
    return {"kernels": out}


# main's phases in order (device and build always run first) and the
# phases whose results each needs; ``--only NAME`` runs NAME after these,
# transitively, in this order
PHASES = ("checks", "tune", "models", "times", "serve", "plans", "host_cost",
          "prefill_parity", "admission", "measure", "degradation", "trace",
          "model", "profile", "retune", "fleet", "chaos", "mamba", "moe",
          "encdec", "frontend", "train", "parallel", "dryrun")
NEEDS = {"models": ("tune",), "times": ("tune", "models"),
         "serve": ("times",), "plans": ("serve",), "host_cost": ("plans",),
         "prefill_parity": ("serve",), "admission": ("serve",),
         "measure": ("serve",), "degradation": ("serve",),
         "trace": ("serve",), "profile": ("serve",),
         "retune": ("profile",), "fleet": ("tune",), "chaos": ("serve",),
         "mamba": ("tune",), "moe": ("tune",), "encdec": ("tune",),
         "frontend": ("tune",), "train": ("tune",)}


def phases_to_run(only: Optional[str]) -> set:
    if only is None:
        return set(PHASES)
    todo, stack = set(), [only]
    while stack:
        name = stack.pop()
        if name not in todo:
            todo.add(name)
            stack.extend(NEEDS.get(name, ()))
    return todo


def print_summary(limit: int = 240) -> None:
    """One line a phase, in the order they first printed: its line count,
    the seconds from its first line to its last, and its figures (those
    ``SUMMARY`` holds, else its last line cut at ``limit`` characters),
    small enough for a 24 KB tail."""
    for name, (t0, t1, n, last) in PHASE_LOG.items():
        figs = SUMMARY.get(name)
        text = json.dumps(figs) if figs else (
            last if len(last) <= limit else last[:limit] + " ...")
        print(f"[summary] {name}: {n} lines over {t1 - t0:.1f} s; {text}",
              flush=True)


def main(argv: Optional[list] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--only", choices=PHASES,
                    help="run this phase after the phases it needs (device "
                         "and build always run); no kernels line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    run = phases_to_run(args.only)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    peaks = card_peaks(name)
    label = f"{smi}; peaks of H100 SXM"
    phase_build()
    if "checks" in run:
        worst = {"gemm": phase_gemm_check(dev), "conv": phase_conv_check(dev),
                 "attention": phase_attention_check(dev),
                 "ssd": phase_ssd_check(dev)}

    cfg = get_config("smollm-135m")
    backend = CheckedBackend(CudaEventBackend(device=dev))
    fp = backend.fingerprint
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        store_path = Path(tmp) / "tunedb.jsonl"
        store = RecordStore.open(store_path)
        if "tune" in run:
            phase("tune", f"backend fingerprint {fp}")
            reset_launches()
            tuners = phase_tune(backend, store, fp, dev)["tuners"]
            launches["tune"] = read_launches()
            if not all(launches["tune"].values()):
                raise AssertionError(f"tune path launches {launches['tune']}")
            phase("tune", f"launches on the tune path: {launches['tune']}")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen)
        if "models" in run:
            models = phase_models(backend, store, store_path, fp, cfg,
                                  params, dev, label)
            launches["models"] = models["counts"]
            if not (launches["models"]["gemm"]
                    and launches["models"]["gemm_reduce"]):
                raise AssertionError(f"models path launches "
                                     f"{launches['models']}")
        if "times" in run:
            gemm_rows, conv_rows = phase_times(dev, peaks, label)
            table4 = phase_gemm_table4(dev, peaks, label)
            attn_rows, ssd_rows = phase_times_attention_ssd(dev, peaks, label)
        if "serve" in run:
            serve = phase_serve(cfg, params, store_path, fp, gemm_rows, label)
            launches["serve"] = serve["counts"]
            SUMMARY["serve"] = {k: serve[k] for k in (
                "tokens_per_s", "tick_ms", "eager_tokens_per_s",
                "eager_tick_ms")}
        if "plans" in run:
            serve_state = serving_state()
            plans = phase_plans(cfg, params, store_path, serve, label)
            launches["plans"] = plans["counts"]
            install_serving(store=serve_state.store,
                            models=serve_state.models, fingerprint=fp,
                            plan=serve_state.plan)
        if "host_cost" in run:
            phase_host_cost(cfg, params, serve, fp, dev, label)
        if "prefill_parity" in run:
            phase_prefill_parity(serve["engine"], cfg, dev, label)
        if "admission" in run:
            admission = phase_admission(cfg, params, store_path, fp, label)
            launches["admission"] = admission["counts"]
        if "measure" in run:
            launches["measure"] = phase_measure(cfg, params, store_path, fp,
                                                dev, label)["counts"]
        if "degradation" in run:
            launches["degradation"] = phase_degradation(
                cfg, params, store_path, fp, label)["counts"]
        if "trace" in run:
            trace = phase_trace(cfg, params, store_path, fp, serve, label)
            launches["trace"] = trace["counts"]
        if "model" in run:
            phase_model(cfg, params, dev)
        if "profile" in run:
            profile = phase_profile(serve.pop("engine"), cfg, dev, label)
            gc.collect()
        if "retune" in run:
            reset_launches()
            retune = phase_retune(cfg, params, backend, fp, tuners, dev,
                                  label, serve_device_ms=profile["device_ms"])
            launches["retune"] = read_launches()
            if not (launches["retune"]["gemm"]
                    and launches["retune"]["attention"]
                    and (launches["retune"]["gemm_reduce"]
                         or not retune["device_reduce_launches"])):
                raise AssertionError(f"retune path launches "
                                     f"{launches['retune']}")
            phase("retune", f"launches on the retune path: "
                  f"{launches['retune']}")
            gc.collect()
        if "fleet" in run:
            fleet = phase_fleet(cfg, fp, tuners, store, dev, Path(tmp), label)
            launches["fleet"] = fleet["a"]["launches"]
            launches["fleet_worker"] = {
                k: fleet["a"]["worker_launches"][k]
                + fleet["b"]["worker_launches"][k]
                for k in fleet["a"]["worker_launches"]}
            # the engine's attention is plain PyTorch (only its split count
            # is a dispatch lookup, ROADMAP A4.2): the attention kernel runs
            # in the worker's timings of the decode attention shape
            if not (launches["fleet"]["gemm"]
                    and launches["fleet"]["gemm_reduce"]
                    and launches["fleet_worker"]["gemm"]
                    and launches["fleet_worker"]["attention"]):
                raise AssertionError(f"fleet path launches "
                                     f"{launches['fleet']}, the workers' "
                                     f"{launches['fleet_worker']}")
            phase("fleet", f"launches on the fleet path: the engine "
                  f"{launches['fleet']}, the workers "
                  f"{launches['fleet_worker']}")
            gc.collect()
        if "chaos" in run:
            chaos = phase_chaos(cfg, params, fp, tuners, dev, Path(tmp),
                                serve["tick_ms"], label)
            launches["chaos"] = chaos["counts"]
            launches["chaos_workers"] = chaos["worker_launches"]
            phase("chaos", f"launches on the chaos path: the engine "
                  f"{launches['chaos']}, the workers "
                  f"{launches['chaos_workers']}")
        if "mamba" in run:
            mamba = phase_mamba(backend, store, store_path, fp, dev, peaks,
                                label)
            launches["serve_mamba"] = mamba["counts"]
        if "moe" in run:
            moe = phase_moe(backend, store, store_path, fp, dev, peaks, label)
            launches["serve_moe"] = moe["counts"]
        if "encdec" in run:
            encdec = phase_encdec(backend, store, fp, dev, peaks, label)
            launches["serve_encdec"] = encdec["counts"]
        if "frontend" in run:
            frontend = phase_frontend(backend, store, store_path, fp, dev,
                                      peaks, label)
            launches["serve_frontend"] = frontend["counts"]
            if "encdec" in run:
                phase("frontend", f"the encdec and frontend phases' wall "
                      f"{encdec['wall_s'] + frontend['wall_s']:.1f} s")
        if "train" in run:
            train = phase_train(fp, tuners, dev, peaks, Path(tmp), label)
            launches["train"] = train["counts"]
            phase("train", f"launches on the train path (A's and B's "
                  f"steps): {launches['train']}")
        if "parallel" in run:
            parallel = phase_parallel(dev, Path(tmp), label)
            launches["parallel"] = parallel["counts"]
            SUMMARY["parallel"] = {"ms": parallel["ms"],
                                   "wall_s": parallel["wall_s"]}
            phase("parallel", f"launches on the parallel path (the EP "
                  f"prefills, the step, the pipeline): "
                  f"{launches['parallel']}")
        clear_store()
        clear_models()
        if "dryrun" in run:
            dry = phase_dryrun(dev, Path(tmp), label)
            launches["dryrun"] = dry["counts"]
            SUMMARY["dryrun"] = {
                v: {k: dry["held"][v][k] for k in (
                    "wall_ms", "roofline_ms", "bottleneck", "fraction",
                    "ratio", "launches")} for v in ("v1", "v2")}
            SUMMARY["dryrun"]["cell_walls"] = dry["cell_walls"]
            for k in ("wall_s", "held_s", "cells_s"):
                SUMMARY["dryrun"][k] = dry[k]
            if not (launches["dryrun"]["gemm"]
                    and launches["dryrun"]["gemm_reduce"]):
                raise AssertionError(f"dryrun path launches "
                                     f"{launches['dryrun']}")
    if args.only is None:
        rows = {"gemm": gemm_rows, "conv": conv_rows, "attention": attn_rows,
                "ssd": ssd_rows}
        line = kernels_line(rows, worst, launches, cfg.n_layers)
        line["kernels"][0]["device_launches"] = serve["device_launches"]
        served = {"serve": serve, "serve_retune": retune,
                  "serve_fleet": fleet, "serve_chaos": chaos,
                  "serve_mamba": mamba, "serve_moe": moe,
                  "serve_encdec": encdec, "serve_frontend": frontend}
        line["kernels"][0]["device_launches_by_path"] = {
            p: r["device_launches"] for p, r in served.items()}
        # ms, plain_ms and library_ms time C = A @ B (ops.matmul, the
        # split-K reduction pass included); gemm_ms is the GEMM kernel alone
        line["kernels"][0]["gemm_ms"] = per_tick(gemm_rows, "gemm_ms",
                                                 cfg.n_layers)
        line["kernels"][0]["table4"] = table4
        # one SmolLM-135M training step's 840 GEMMs under the tuned configs
        line["kernels"][0]["train_gemm_ms"] = train["sums"]["tuned"]
        line["kernels"][-1]["device_launches"] = \
            serve["device_reduce_launches"]
        line["kernels"][-1]["device_launches_by_path"] = {
            p: r["device_reduce_launches"] for p, r in served.items()}
        print(json.dumps(line), flush=True)
    else:
        phase("kernels", f"--only {args.only}: phases run {sorted(run)}; "
              f"launches by path {launches}; no kernels line")
    phase("done", f"{time.perf_counter() - t_start:.1f} s")
    print_summary()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
