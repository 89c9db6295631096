"""Runtime kernel inference (paper §6).

At runtime the input parameters are fixed; the trained regressor is optimized
over tuning parameters only.  The paper picks exhaustive search because (a)
it finds the global optimum of the model within the search range, (b) it is
embarrassingly parallel — the whole candidate set is scored by ONE batched
MLP forward pass (a chain of rectangular matmuls: the self-bootstrap), and
(c) the top-k survivors can be re-measured on hardware to wash out model
noise.

The port of ``repro.core.search``, unchanged but for the regressor it
calls (``repro_torch.core.mlp.MLP``) and one rule: a top-k config that the
correctness gate rejects while it is re-measured drops out of the pick.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np

from .features import Featurizer, target_untransform
from .mlp import MLP
from .space import Config, ConfigRejected, ParamSpace


@dataclasses.dataclass
class SearchResult:
    best: Config
    predicted_tflops: float
    measured_tflops: Optional[float]
    top_k: List[Tuple[Config, float]]           # (config, predicted)
    n_candidates: int
    # every (config, measured) pair from the top-k re-measurement pass: each
    # one is a labeled training point for the performance model (model.py),
    # so sessions commit them to the store as source="sample" records.
    measured: Optional[List[Tuple[Config, float]]] = None


def enumerate_legal(space: ParamSpace, inputs: Mapping[str, int],
                    cap: Optional[int] = None) -> List[Config]:
    """Materialize X(inputs) — the legal slice of the space at fixed input."""
    out: List[Config] = []
    for cfg in space.enumerate():
        if space.is_legal(cfg, inputs):
            out.append(cfg)
            if cap is not None and len(out) >= cap:
                break
    return out


def exhaustive_search(space: ParamSpace, inputs: Mapping[str, int], *,
                      model: MLP, featurizer: Featurizer,
                      top_k: int = 10,
                      measure: Optional[Callable[[Config], float]] = None,
                      candidates: Optional[List[Config]] = None
                      ) -> SearchResult:
    """Score every legal config with one batched forward pass; optionally
    re-measure the top-k on the backend and return the measured argmax."""
    cands = candidates if candidates is not None else \
        enumerate_legal(space, inputs)
    if not cands:
        raise ValueError(f"no legal configuration for inputs {inputs}")

    X_raw = featurizer.raw_batch([(inputs, c) for c in cands])
    X = featurizer.transform(X_raw)
    pred_log = model.predict(X)
    pred = target_untransform(pred_log)

    order = np.argsort(-pred)
    k = min(top_k, len(cands))
    top = [(cands[i], float(pred[i])) for i in order[:k]]

    if measure is not None:
        measured = []
        for cfg, _ in top:
            try:
                measured.append((cfg, measure(cfg)))
            except ConfigRejected:      # the gate's verdict: not a candidate
                continue
        if not measured:
            raise ConfigRejected(f"the gate rejected all {k} re-measured "
                                 f"configs for inputs {dict(inputs)}")
        best_cfg, best_m = max(measured, key=lambda t: t[1])
        best_pred = next(p for c, p in top if c == best_cfg)
        return SearchResult(best=best_cfg, predicted_tflops=best_pred,
                            measured_tflops=best_m, top_k=top,
                            n_candidates=len(cands), measured=measured)
    best_cfg, best_pred = top[0]
    return SearchResult(best=best_cfg, predicted_tflops=best_pred,
                        measured_tflops=None, top_k=top,
                        n_candidates=len(cands))


def oracle_search(space: ParamSpace, inputs: Mapping[str, int],
                  measure: Callable[[Config], float],
                  candidates: Optional[List[Config]] = None
                  ) -> Tuple[Config, float]:
    """Ground-truth exhaustive search on the backend itself — the '10 hours
    on hardware' baseline of §6, tractable here because the oracle is fast.
    Benchmarks use it to report ISAAC's regret vs the true optimum."""
    cands = candidates if candidates is not None else \
        enumerate_legal(space, inputs)
    best_cfg, best = None, -1.0
    for cfg in cands:
        y = measure(cfg)
        if y > best:
            best_cfg, best = cfg, y
    return best_cfg, best
