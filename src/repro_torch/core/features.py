"""Feature engineering for the performance regressor (paper §5.2).

The paper's central modeling insight: Volkov-style performance models
(eq. 2-3) are built from products, quotients and maxima of hardware and
input/tuning quantities.  An MLP cannot easily represent products of its
inputs, but ``log`` turns products/quotients into sums/differences which a
ReLU network represents trivially (and ``max`` is native to ReLU).  The paper
reports that the log transform is the difference between converging and not
(Table 2, "no log" column).

A featurizer is generic over a :class:`~repro_torch.core.space.ParamSpace`:
the feature vector is ``log2(input params) ++ log2(tuning params)``,
standardized to zero-mean/unit-variance with statistics estimated from the
training set.

A copy of ``repro.core.features`` (numpy only): importing anything of
``repro.core`` would load JAX through its package ``__init__``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from .space import ParamSpace


@dataclasses.dataclass
class Featurizer:
    """Maps (inputs, config) dicts -> standardized log2 feature vectors."""

    space: ParamSpace
    log: bool = True                      # paper ablates this (Table 2)
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None

    @property
    def feature_names(self) -> Tuple[str, ...]:
        return tuple(self.space.input_params) + tuple(self.space.param_names)

    @property
    def dim(self) -> int:
        return len(self.feature_names)

    # -- raw (un-standardized) features --------------------------------------
    def raw(self, inputs: Mapping[str, int], cfg: Mapping[str, int]) -> np.ndarray:
        vals = [float(inputs[k]) for k in self.space.input_params]
        vals += [float(cfg[k]) for k in self.space.param_names]
        x = np.asarray(vals, dtype=np.float64)
        if self.log:
            # +1 shift keeps binary flags (0/1) and degenerate dims finite.
            x = np.log2(x + 1.0)
        return x

    def raw_batch(self, pairs: Sequence[Tuple[Mapping[str, int], Mapping[str, int]]]
                  ) -> np.ndarray:
        return np.stack([self.raw(i, c) for i, c in pairs])

    # -- standardization ------------------------------------------------------
    def fit(self, X_raw: np.ndarray) -> "Featurizer":
        self.mean = X_raw.mean(axis=0)
        self.std = X_raw.std(axis=0) + 1e-8
        return self

    def transform(self, X_raw: np.ndarray) -> np.ndarray:
        assert self.mean is not None, "call fit() first"
        return ((X_raw - self.mean) / self.std).astype(np.float32)

    def __call__(self, inputs: Mapping[str, int], cfg: Mapping[str, int]
                 ) -> np.ndarray:
        return self.transform(self.raw(inputs, cfg)[None])[0]

    # -- persistence ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "space": self.space.name,
            "log": self.log,
            "mean": None if self.mean is None else self.mean.tolist(),
            "std": None if self.std is None else self.std.tolist(),
        })

    @classmethod
    def from_json(cls, space: ParamSpace, payload: str) -> "Featurizer":
        d = json.loads(payload)
        assert d["space"] == space.name
        f = cls(space=space, log=d["log"])
        if d["mean"] is not None:
            f.mean = np.asarray(d["mean"], dtype=np.float64)
            f.std = np.asarray(d["std"], dtype=np.float64)
        return f


def target_transform(y_tflops: np.ndarray) -> np.ndarray:
    """Regress log-throughput: performance spans 3+ orders of magnitude and
    relative (not absolute) error is what matters for ranking kernels."""
    return np.log2(np.maximum(y_tflops, 1e-6)).astype(np.float32)


def target_untransform(y_log: np.ndarray) -> np.ndarray:
    # clip to a physically absurd ceiling (2^40 TFLOPS) so a regressor
    # extrapolating far off its training manifold saturates instead of
    # overflowing to inf and poisoning downstream argmax/geomean math
    return np.exp2(np.minimum(y_log, 40.0))
