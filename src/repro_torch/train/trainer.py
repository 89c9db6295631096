"""Trainer: the train step and the training loop (port of
``repro.train.trainer``).

``make_train_step`` wires together the model's loss, microbatch gradient
accumulation, int8 gradient compression with error feedback and AdamW.
The reference jits the step with ``donate_argnums``; here the step runs
eagerly and AdamW writes the new parameters and states into the old
tensors.  Every projection of the forward, of its recompute and of both
gradients goes through ``dispatch.matmul`` (``kernels/dispatch.py``
``_TunedGemm``), so on the card each runs the hand-written GEMM under its
tuned config.

The training state is a dict: ``params`` (leaves that require grad),
``opt`` (``optim.AdamWState``), ``rng`` (two uint32 words, the
reference's ``jax.random`` key layout; where stochastic rounding is on,
each step derives a new pair and seeds a ``torch.Generator`` on the
device from it) and, with ``compress_grads``, ``ef`` (the fp32 error
feedback).

``Trainer`` is the single-process driver: auto-resume from the newest
checkpoint, periodic async snapshots, a preemption-safe exit and the
straggler monitor.  It runs on the card unless ``device`` names the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ModelConfig, init_params, loss_fn, tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, decompress_grads,
                               init_error_feedback)

from . import checkpoint as ckpt
from .fault import PreemptionHandler, StragglerMonitor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1            # grad accumulation factor
    compress_grads: bool = False     # int8 + error feedback
    stochastic_rounding: bool = False
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    async_checkpoint: bool = True
    log_every: int = 10
    seed: int = 0


def _rebuild(template: Any, leaves: List[Any]) -> Any:
    """``leaves`` (in ``tree_leaves`` order) in ``template``'s dicts."""
    it = iter(leaves)

    def go(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return next(it)
    return go(template)


def _next_key(rng: np.ndarray) -> Tuple[np.ndarray, int]:
    """(the state's next key, a seed for this step's generator), both
    drawn from the two uint32 words of ``rng``."""
    words = np.random.default_rng([int(w) for w in rng]).integers(
        0, 1 << 32, 4, dtype=np.uint64)
    seed = (int(words[2]) << 32 | int(words[3])) & ((1 << 63) - 1)
    return words[:2].astype(np.uint32), seed


def make_train_step(model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                    train_cfg: TrainConfig) -> Callable:
    """Returns step(state, batch) -> (state, metrics).  ``batch`` is a dict
    of tensors on the parameters' device; with ``microbatches`` > 1 it is
    split along the batch and the grads are accumulated in fp32, the loss
    and the accuracy averaged.  Metrics are device scalars (``lr`` a host
    float): loss, acc, grad_norm, lr and, with compression, ef_norm."""

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss, aux = loss_fn(params, model_cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), aux["acc"].detach(), grads

    def step(state, batch):
        params = state["params"]
        nm = train_cfg.microbatches
        if nm > 1:
            mbs = {k: torch.chunk(v, nm, dim=0) for k, v in batch.items()}
            gsum = lsum = asum = None
            for i in range(nm):
                loss, acc, g = grads_of(params, {k: v[i]
                                                 for k, v in mbs.items()})
                g = [t.float() for t in g]
                if gsum is None:
                    gsum, lsum, asum = g, loss, acc
                else:
                    gsum = [a + b for a, b in zip(gsum, g)]
                    lsum, asum = lsum + loss, asum + acc
            grads = [g / nm for g in gsum]
            loss, acc = lsum / nm, asum / nm
        else:
            loss, acc, grads = grads_of(params, batch)
        grads = _rebuild(params, list(grads))

        metrics: Dict[str, Any] = {"loss": loss, "acc": acc}
        ef = state.get("ef")
        if train_cfg.compress_grads and ef is not None:
            q, scales, ef = compress_grads(grads, ef)
            grads = decompress_grads(q, scales)
            metrics["ef_norm"] = torch.sqrt(sum(
                torch.sum(torch.square(e)) for e in tree_leaves(ef)))

        rng, sr_gen = state["rng"], None
        if train_cfg.stochastic_rounding:
            rng, seed = _next_key(rng)
            sr_gen = torch.Generator(device=loss.device)
            sr_gen.manual_seed(seed)
        params, opt, om = adamw_update(params, grads, state["opt"], opt_cfg,
                                       sr_gen=sr_gen)
        metrics.update(om)
        new_state = {"params": params, "opt": opt, "rng": rng}
        if ef is not None:
            new_state["ef"] = ef
        return new_state, metrics

    return step


def _trainable(params: Any) -> Any:
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def init_train_state(model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                     train_cfg: TrainConfig, device: DeviceLike = None
                     ) -> Dict[str, Any]:
    """A fresh state: ``init_params`` from a generator seeded with
    ``train_cfg.seed`` on ``device``; zero AdamW states; the key [0,
    seed + 1] (the reference's ``PRNGKey(seed + 1)``); with compression a
    zero error feedback."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(train_cfg.seed)
    params = _trainable(init_params(model_cfg, gen))
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "rng": np.array([0, train_cfg.seed + 1], np.uint32)}
    if train_cfg.compress_grads:
        state["ef"] = init_error_feedback(params)
    return state


class Trainer:
    """Single-driver training loop with checkpoint/resume/fault handling.
    It resumes from the newest checkpoint in ``checkpoint_dir``, the
    reference's included (a reference state saved at step 0 starts the
    port from the reference's parameters)."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 train_cfg: TrainConfig, data_cfg: DataConfig,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model_cfg, self.opt_cfg = model_cfg, opt_cfg
        self.train_cfg, self.data_cfg = train_cfg, data_cfg
        self.pipeline = SyntheticTokenPipeline(data_cfg)
        self.step_fn = make_train_step(model_cfg, opt_cfg, train_cfg)
        self.monitor = StragglerMonitor()
        self.preempt = PreemptionHandler()
        self._ckpt_thread = None
        self.history: list = []

    # -- state ----------------------------------------------------------------
    def init_or_resume(self) -> Tuple[Dict[str, Any], int]:
        tc = self.train_cfg
        state = init_train_state(self.model_cfg, self.opt_cfg, tc,
                                 self.device)
        if tc.checkpoint_dir and ckpt.latest_step(tc.checkpoint_dir) is not None:
            state, step, _ = ckpt.load_checkpoint(tc.checkpoint_dir, state)
            _trainable(state["params"])
            return state, step
        return state, 0

    def _save(self, state, step):
        tc = self.train_cfg
        if not tc.checkpoint_dir:
            return
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        self._ckpt_thread = ckpt.save_checkpoint(
            tc.checkpoint_dir, step, state, data_step=step,
            async_save=tc.async_checkpoint)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch of ``step`` on the trainer's device."""
        return {k: torch.as_tensor(v, dtype=torch.long, device=self.device)
                for k, v in self.pipeline.batch(step).items()}

    # -- loop -----------------------------------------------------------------
    def run(self, verbose: bool = True) -> Dict[str, Any]:
        tc = self.train_cfg
        state, start = self.init_or_resume()
        step = start
        for step in range(start, tc.steps):
            batch = self.batch(step)
            self.monitor.step_start()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])     # waits for the step's device work
            dt = self.monitor.step_end(step)
            self.history.append({"step": step, "loss": loss, "time": dt})
            if verbose and (step % tc.log_every == 0 or step == tc.steps - 1):
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"acc {float(metrics['acc']):.3f}  {dt*1e3:.0f} ms")
            if tc.checkpoint_dir and step > start \
                    and step % tc.checkpoint_every == 0:
                self._save(state, step)
            if self.preempt.should_stop:
                self._save(state, step)
                break
        self._save(state, step + 1) if tc.checkpoint_dir else None
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        return {"state": state, "history": self.history,
                "straggler_events": self.monitor.events}
