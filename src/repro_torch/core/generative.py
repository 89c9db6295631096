"""Generative modeling of the legal configuration space (paper §4).

When only X-hat is explicitly known, uniform sampling of configurations is
wasteful (paper: >99.9% of uniform GEMM samples are illegal).  The paper's
remedy is a *naive factorized categorical model*: treat the configuration as a
random vector with independent categorical components,

    p(x in X) ~= p(x_0) p(x_1) ... p(x_N),

estimate each p(x_i = v) as the proportion of value v among *accepted* samples
of a short uniform-sampling phase, and smooth with a Dirichlet prior by
initializing every count at alpha > 0 (the paper uses alpha = 100, and so do
we).  Sampling from the fitted model then concentrates on the legal region.

A copy of ``repro.core.generative``: the same numpy draws in the same
order, so a seed gives the reference's configurations and workloads.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional

import numpy as np

from .space import Config, ParamSpace


@dataclasses.dataclass
class CategoricalSampler:
    """Factorized categorical generative model with Dirichlet-prior smoothing."""

    space: ParamSpace
    alpha: float = 100.0
    counts: Optional[Dict[str, np.ndarray]] = None

    def __post_init__(self) -> None:
        if self.counts is None:
            self.counts = {
                name: np.full(len(choices), self.alpha, dtype=np.float64)
                for name, choices in self.space.params.items()
            }

    # -- fitting ------------------------------------------------------------
    def fit(self, inputs_list: List[Mapping[str, int]], n_uniform: int,
            rng: np.random.Generator) -> "CategoricalSampler":
        """Uniform-sampling phase: draw configurations uniformly from X-hat,
        check legality against inputs drawn from the workload distribution,
        and accumulate acceptance counts per parameter value."""
        names = self.space.param_names
        choices = [self.space.params[n] for n in names]
        for _ in range(n_uniform):
            idx = [rng.integers(len(c)) for c in choices]
            cfg = {n: c[i] for n, c, i in zip(names, choices, idx)}
            inputs = inputs_list[rng.integers(len(inputs_list))]
            if self.space.is_legal(cfg, inputs):
                for n, i in zip(names, idx):
                    self.counts[n][i] += 1.0
        return self

    def probs(self, name: str) -> np.ndarray:
        c = self.counts[name]
        return c / c.sum()

    # -- sampling -----------------------------------------------------------
    def sample(self, rng: np.random.Generator) -> Config:
        """Draw one configuration from the fitted factorized model.  The
        result is *probably* legal; callers re-check legality (the model is
        an importance distribution, not an exact characterization of X)."""
        cfg: Config = {}
        for name, choices in self.space.params.items():
            p = self.probs(name)
            cfg[name] = int(choices[rng.choice(len(choices), p=p)])
        return cfg

    def sample_legal(self, inputs: Mapping[str, int], rng: np.random.Generator,
                     max_tries: int = 1000) -> Optional[Config]:
        for _ in range(max_tries):
            cfg = self.sample(rng)
            if self.space.is_legal(cfg, inputs):
                return cfg
        return None

    # -- diagnostics (Table 1 of the paper) ----------------------------------
    def acceptance_rate(self, inputs_list: List[Mapping[str, int]], n: int,
                        rng: np.random.Generator,
                        uniform: bool = False) -> float:
        """Fraction of draws that land in X; `uniform=True` measures the naive
        baseline the paper compares against."""
        names = self.space.param_names
        choices = [self.space.params[n] for n in names]
        ok = 0
        for _ in range(n):
            if uniform:
                cfg = {nm: c[rng.integers(len(c))] for nm, c in zip(names, choices)}
            else:
                cfg = self.sample(rng)
            inputs = inputs_list[rng.integers(len(inputs_list))]
            ok += self.space.is_legal(cfg, inputs)
        return ok / n

    # -- persistence ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "space": self.space.name,
            "alpha": self.alpha,
            "counts": {k: v.tolist() for k, v in self.counts.items()},
        })

    @classmethod
    def from_json(cls, space: ParamSpace, payload: str) -> "CategoricalSampler":
        d = json.loads(payload)
        assert d["space"] == space.name
        sampler = cls(space=space, alpha=d["alpha"])
        sampler.counts = {k: np.asarray(v, dtype=np.float64)
                          for k, v in d["counts"].items()}
        return sampler


def workload_inputs(space: ParamSpace, n: int, rng: np.random.Generator
                    ) -> List[Dict[str, int]]:
    """Draw input-parameter vectors from a realistic workload distribution.

    The paper trains on inputs spanning LINPACK-, DeepBench-, ICA- and
    LAPACK-like regimes; we mirror that with log-uniform dims plus explicit
    skinny / deep-reduction tails so the model sees the irregular regions
    where input-awareness matters.
    """
    out: List[Dict[str, int]] = []

    def logu(lo: int, hi: int) -> int:
        return int(2 ** rng.uniform(np.log2(lo), np.log2(hi)))

    for _ in range(n):
        if space.name == "gemm":
            mode = rng.integers(4)
            if mode == 0:        # square-ish (LINPACK)
                m = n_ = k = logu(128, 8192)
            elif mode == 1:      # skinny-N (DeepBench fwd/bwd)
                m, n_, k = logu(512, 8192), logu(8, 256), logu(512, 8192)
            elif mode == 2:      # deep reduction (ICA / covariance)
                m = n_ = logu(16, 512)
                k = logu(8192, 131072)
            else:                # outer-product-ish (LAPACK blocked)
                m = n_ = logu(512, 8192)
                k = logu(16, 64)
            bits = int(rng.choice([16, 32]))
            out.append({"M": m, "N": n_, "K": k, "dtype_bits": bits,
                        "trans_a": int(rng.integers(2)),
                        "trans_b": int(rng.integers(2))})
        elif space.name == "conv":
            nb = int(rng.choice([8, 16, 32]))
            h = logu(7, 128)
            w = logu(7, 256)
            c = int(rng.choice([1, 16, 32, 64, 128, 256, 512, 832, 1024]))
            k = int(rng.choice([32, 64, 128, 174, 256, 512, 2048]))
            r = int(rng.choice([1, 3, 5]))
            s = int(rng.choice([1, 3, 5, 10, 20]))
            out.append({"N": nb, "H": h, "W": w, "C": c, "K": k,
                        "R": r, "S": s, "dtype_bits": int(rng.choice([16, 32]))})
        elif space.name == "attention":
            out.append({"B": logu(1, 64), "Hq": int(rng.choice([8, 16, 32, 64])),
                        "Hkv": int(rng.choice([1, 2, 8])),
                        "Lq": logu(128, 32768), "Lkv": logu(128, 32768),
                        "D": int(rng.choice([64, 128, 256])),
                        "dtype_bits": int(rng.choice([16, 32])),
                        "causal": int(rng.integers(2))})
        elif space.name == "ssd":
            out.append({"B": logu(1, 64), "L": logu(256, 65536),
                        "H": int(rng.choice([16, 32, 64])),
                        "P": int(rng.choice([32, 64, 128])),
                        "S": int(rng.choice([64, 128, 256])),
                        "dtype_bits": int(rng.choice([16, 32]))})
        else:
            raise ValueError(f"unknown space {space.name}")
    return out
