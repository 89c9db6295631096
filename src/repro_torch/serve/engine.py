"""Batched serving engine: slot-based continuous batching over a shared KV
cache (port of the core of ``repro.serve.engine``).

Requests are admitted into free slots (prefill fills the slot's cache
region), every decode tick advances all slots together at their own cache
positions, and finished requests (EOS or length budget) free their slot.
Inactive slots decode too, on token 0 at position 0, and their output is
discarded — the batch keeps one shape, as in the reference.

On CUDA each decode tick replays one captured CUDA graph, the port's
counterpart of the reference's ``jax.jit`` of ``decode_step``: the tick is
captured once for the engine's fixed (slots, max_len) batch, with static
token and position buffers that are filled before each replay, and
dispatch resolves every config at capture, as the reference's does at
trace time.  A new serving generation (``serving_state().generation``:
another store or model set installed) forces a re-capture.  The graph
keeps its node list (:attr:`Engine.graph`), so a caller can count the
kernels a replay gives the device.  Prefill stays eager (prompt lengths
vary), and so does every tick on the CPU.  A capture or replay that fails raises; it
never falls back to the eager tick, which stays a method
(:meth:`Engine.decode_eager`) for comparison.  The reference's trace-time
telemetry capture, retuning, routing, admission policies, deadlines,
tracing, the status endpoint, dispatch plans and the model tier's
deferred re-measurement are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import pathlib
import time
import warnings
from typing import Any, Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ModelConfig, decode_step, init_cache, prefill
from repro_torch.tunedb.model import ModelSet, default_models_dir
from repro_torch.tunedb.store import (RecordStore, install_serving,
                                      serving_state)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    slots: int = 8                  # concurrent sequences
    eos_token: int = -1             # -1: never emitted (synthetic tokens)
    temperature: float = 0.0        # 0 => greedy
    seed: int = 0
    tunedb: Optional[str] = None    # warm-start: tuning-record store path
    # model artifacts dir for the model tier; None finds `<tunedb>.models/`
    # beside the store, "" turns the tier off
    tunedb_models: Optional[str] = None
    # pin dispatch lookups to one backend fingerprint; None = any backend
    tunedb_backend: Optional[str] = None
    # the model tier's confidence gates (tunedb.model.ModelSet): decline
    # when the top-1 beats the top-2 by less than this relative margin
    # (0 trusts every argmax) ...
    tunedb_margin: float = 0.0
    # ... or when an input feature lies more than this many training
    # standard deviations off (0 turns the gate off)
    tunedb_max_z: float = 6.0
    # keep (start perf_counter, wall seconds) of each decode tick
    record_tick_times: bool = False
    tick_times_cap: int = 4096      # newest ticks kept; 0 keeps all


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (len,) int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)


class Engine:
    def __init__(self, cfg: ModelConfig, params: Any, serve_cfg: ServeConfig,
                 *, device: DeviceLike = None):
        cfg.check_supported()
        self.device = resolve_device(device)
        self.cfg, self.sc = cfg, serve_cfg
        self.params = _to_device(params, self.device)
        # warm start: the store and its model artifacts become the port's
        # process-wide dispatch state, pinned to tunedb_backend, in one
        # install; a missing file serves on the heuristics tier (dispatch
        # warns once).  The models are installed even when there are none
        # (None), so an earlier engine's regressors never serve this
        # store's traffic.  No measurer is installed: serving never
        # measures.
        self.tunedb_store: Optional[RecordStore] = None
        self.tunedb_models: Optional[ModelSet] = None
        if serve_cfg.tunedb or serve_cfg.tunedb_models:
            swap = {"fingerprint": serve_cfg.tunedb_backend}
            models_dir = serve_cfg.tunedb_models
            if serve_cfg.tunedb:
                path = pathlib.Path(serve_cfg.tunedb)
                if not path.exists():
                    warnings.warn(f"tunedb store {path} does not exist; "
                                  "serving starts with an empty store "
                                  "(heuristics fallback)", RuntimeWarning,
                                  stacklevel=2)
                self.tunedb_store = swap["store"] = RecordStore.open(path)
                if models_dir is None:
                    models_dir = default_models_dir(path)
            models = ModelSet.load(models_dir) if models_dir else ModelSet()
            models.margin_threshold = serve_cfg.tunedb_margin
            models.max_feature_z = serve_cfg.tunedb_max_z
            if len(models):
                self.tunedb_models = models
            install_serving(models=self.tunedb_models, **swap)
        self.cache = init_cache(cfg, serve_cfg.slots, serve_cfg.max_len,
                                self.device)
        self.lengths = np.zeros(serve_cfg.slots, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * serve_cfg.slots
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(serve_cfg.seed)
        self.ticks = 0
        self.prefills = 0
        # the decode graph (CUDA), its static inputs and output, and the
        # store generation its configs were resolved under
        self.captures = 0
        self.replays = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_gen = -1
        self._static: Optional[Tuple[torch.Tensor, ...]] = None
        # the tick generate runs: the graph on CUDA, eager on the CPU
        self.decode = (self.decode_graph if self.device.type == "cuda"
                       else self.decode_eager)
        cap = serve_cfg.tick_times_cap
        self.tick_times: Deque[Tuple[float, float]] = collections.deque(
            maxlen=cap if cap > 0 else None)

    # -- prefill ---------------------------------------------------------------
    def _prefill_one(self, slot: int, req: Request) -> None:
        """Prefill the prompt straight into the slot's cache rows (zeroed
        first, as the reference replaces the slot with a fresh cache)."""
        kv = self.cache["pos0"]["attn"]
        for t in (kv["k"], kv["v"]):
            t[:, slot].zero_()
        single = {"pos0": {"attn": {"k": kv["k"][:, slot:slot + 1],
                                    "v": kv["v"][:, slot:slot + 1]}}}
        tokens = torch.as_tensor(req.prompt[None], dtype=torch.long,
                                 device=self.device)
        logits, _ = prefill(self.params, self.cfg, {"tokens": tokens}, single)
        self.prefills += 1
        self.lengths[slot] = len(req.prompt)
        self.slot_req[slot] = req
        req.out.append(int(self._sample(logits[:, : self.cfg.vocab])[0]))

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.sc.temperature <= 0:
            return logits.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].cpu(
            ).numpy()

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The captured decode tick (None before the first CUDA tick).  It
        keeps its ``cudaGraph_t`` (``raw_cuda_graph()``): the kernels each
        replay gives the device can be read from its nodes.  Serving itself
        needs only the instantiated graph; the kept ``cudaGraph_t`` (a
        second host copy per capture) is there for that exact count of the
        replayed kernels, which chip_smoke.py's serve phase checks."""
        return self._graph

    # -- decode tick -------------------------------------------------------------
    def decode_eager(self, last: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
        """One decode tick, op by op: last (slots, 1) tokens at positions
        idx (slots,) -> logits (slots, V)."""
        return decode_step(self.params, self.cfg, last, self.cache, idx)[0]

    def decode_graph(self, last: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
        """The same tick replayed from a CUDA graph.  The returned logits
        are the graph's static output: read them before the next tick."""
        gen = serving_state().generation
        if self._graph is None or self._graph_gen != gen:
            self._capture(last, idx)
            self._graph_gen = gen
        s_last, s_idx, logits = self._static
        s_last.copy_(last)
        s_idx.copy_(idx)
        self._graph.replay()
        self.replays += 1
        return logits

    def _capture(self, last: torch.Tensor, idx: torch.Tensor) -> None:
        """Capture :meth:`decode_eager` on static buffers holding this
        tick's inputs.  One eager warm-up on a side stream first (lazy
        library state must exist before capture); it writes this tick's
        K/V rows, which the replay then writes again with the same
        values."""
        self._graph = self._static = None
        s_last, s_idx = last.clone(), idx.clone()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.decode_eager(s_last, s_idx)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            logits = self.decode_eager(s_last, s_idx)
        graph.instantiate()
        self._graph, self._static = graph, (s_last, s_idx, logits)
        self.captures += 1

    # -- main loop --------------------------------------------------------------
    def generate(self, prompts: List[np.ndarray], max_new: int = 32
                 ) -> List[List[int]]:
        """Continuous-batching loop: admit -> decode tick -> retire."""
        sc = self.sc
        queue = [Request(np.asarray(p, np.int64), max_new) for p in prompts]
        pending = list(queue)
        active = 0
        while pending or active:
            while pending:                       # admit into free slots
                slot = next((i for i, r in enumerate(self.slot_req)
                             if r is None), None)
                if slot is None:
                    break
                self._prefill_one(slot, pending.pop(0))
                active += 1
            if active == 0:
                break

            t_tick = time.perf_counter()
            last = torch.as_tensor(
                [[r.out[-1] if r is not None and r.out else 0]
                 for r in self.slot_req], dtype=torch.long,
                device=self.device)
            idx = torch.as_tensor(self.lengths, dtype=torch.long,
                                  device=self.device)
            logits = self.decode(last, idx)
            toks = self._sample(logits[:, : self.cfg.vocab])
            self.ticks += 1

            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                self.lengths[s] += 1
                tok = int(toks[s])
                req.out.append(tok)
                if (tok == sc.eos_token or len(req.out) >= req.max_new
                        or self.lengths[s] + 1 >= sc.max_len):
                    self.slot_req[s] = None
                    self.lengths[s] = 0
                    active -= 1
            if sc.record_tick_times:
                self.tick_times.append((t_tick, time.perf_counter() - t_tick))
        return [r.out for r in queue]


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
