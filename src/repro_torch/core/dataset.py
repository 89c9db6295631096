"""Training-set synthesis for the performance regressor (paper §4).

Pipeline:  fit CategoricalSampler on a short uniform phase  ->  draw legal
(config, inputs) pairs from it  ->  label each with the measurement backend
->  (featurize, split, persist).

The port of ``repro.core.dataset``: the same draws in the same order, but
the labels come from whatever backend the caller passes (the port's
``CudaEventBackend`` times the kernels on the card); there is no default,
since the port has no simulated speed model.  A draw that the correctness
gate rejects (``ConfigRejected``) is passed over, as an illegal one is.
A workload draw the backend cannot label within its per-call budgets (its
``fits``, where it has one: on the card, a call or a footprint too large)
is dropped from the pool and drawn again; a backend that refuses nothing
(the CPU's) gets the reference's pool, draw for draw.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .features import Featurizer, target_transform
from .generative import CategoricalSampler, workload_inputs
from .space import Config, ConfigRejected, ParamSpace


@dataclasses.dataclass
class Dataset:
    """Labeled benchmarking data for one parameter space."""

    space: ParamSpace
    inputs: List[Dict[str, int]]
    configs: List[Config]
    tflops: np.ndarray                    # shape (n,)

    def __len__(self) -> int:
        return len(self.configs)

    def featurize(self, featurizer: Optional[Featurizer] = None
                  ) -> Tuple[Featurizer, np.ndarray, np.ndarray]:
        """Returns (featurizer, X, y_log)."""
        f = featurizer or Featurizer(self.space)
        X_raw = f.raw_batch(list(zip(self.inputs, self.configs)))
        if f.mean is None:
            f.fit(X_raw)
        return f, f.transform(X_raw), target_transform(self.tflops)

    def split(self, val_frac: float = 0.05, seed: int = 0
              ) -> Tuple["Dataset", "Dataset"]:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        n_val = max(1, int(len(self) * val_frac))
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        pick = lambda idx: Dataset(
            space=self.space,
            inputs=[self.inputs[i] for i in idx],
            configs=[self.configs[i] for i in idx],
            tflops=self.tflops[idx])
        return pick(tr_idx), pick(val_idx)

    def subset(self, n: int, seed: int = 0) -> "Dataset":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self))[:n]
        return Dataset(space=self.space,
                       inputs=[self.inputs[i] for i in idx],
                       configs=[self.configs[i] for i in idx],
                       tflops=self.tflops[idx])


MAX_POOL_ROUNDS = 1000      # redraws before a pool that will not fill fails


def workload_pool(space: ParamSpace, n: int, rng: np.random.Generator,
                  fits: Optional[Callable[[str, Mapping[str, int]], bool]]
                  = None) -> List[Dict[str, int]]:
    """``n`` draws of :func:`workload_inputs` that ``fits(space, inputs)``
    accepts: a refused draw is dropped and the missing ones are drawn
    again from the same ``rng``.  Without ``fits``, or where it accepts
    every draw, this is ``workload_inputs(space, n, rng)`` itself."""
    pool: List[Dict[str, int]] = []
    for _ in range(MAX_POOL_ROUNDS):
        pool += [x for x in workload_inputs(space, n - len(pool), rng)
                 if fits is None or fits(space.name, x)]
        if len(pool) == n:
            return pool
    raise RuntimeError(f"{space.name}: {len(pool)} of {n} workload draws fit "
                       f"the backend after {MAX_POOL_ROUNDS} rounds")


def generate_dataset(space: ParamSpace, n_samples: int, *,
                     backend: Any,
                     sampler: Optional[CategoricalSampler] = None,
                     n_uniform_fit: int = 4000,
                     n_workloads: int = 512,
                     seed: int = 0,
                     verbose: bool = False) -> Tuple[Dataset, CategoricalSampler]:
    """End-to-end §4: fit the generative model, draw legal pairs, label them."""
    rng = np.random.default_rng(seed)
    inputs_pool = workload_pool(space, n_workloads, rng,
                                getattr(backend, "fits", None))

    if sampler is None:
        sampler = CategoricalSampler(space=space)
        sampler.fit(inputs_pool, n_uniform_fit, rng)

    inputs_out: List[Dict[str, int]] = []
    configs_out: List[Config] = []
    y: List[float] = []
    t0 = time.time()
    tries = rejected = 0
    while len(configs_out) < n_samples:
        tries += 1
        inputs = inputs_pool[rng.integers(len(inputs_pool))]
        cfg = sampler.sample(rng)
        if not space.is_legal(cfg, inputs):
            continue
        try:
            tflops = backend.measure(space.name, cfg, inputs)
        except ConfigRejected:          # the gate's verdict: not in X(inputs)
            rejected += 1
            continue
        inputs_out.append(dict(inputs))
        configs_out.append(cfg)
        y.append(tflops)
    if verbose:
        dt = time.time() - t0
        print(f"[dataset] {n_samples} legal samples from {tries} draws "
              f"({n_samples / max(tries, 1):.1%} acceptance, {rejected} "
              f"rejected by the gate) in {dt:.1f}s")
    return (Dataset(space=space, inputs=inputs_out, configs=configs_out,
                    tflops=np.asarray(y, np.float64)),
            sampler)
