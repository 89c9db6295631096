"""Tuner facade: train once, infer anywhere (the port of
``repro.core.tuner``).

    backend = CheckedBackend(CudaEventBackend())        # times the kernels
    tuner   = InputAwareTuner.train(GEMM_SPACE, n_samples=8000,
                                    backend=backend, store=store)
    cfg     = tuner.best_config(gemm_input(M=4, N=576, K=576))

``best_config`` looks up, in order, the in-process memo, the record store
(scoped to this tuner's backend fingerprint) and a fresh §6 search whose
result is committed back to the store; it always returns a plain
``Dict[str, int]``.  The backend is any object with ``measure(space, cfg,
inputs) -> TFLOPS`` (``repro_torch.core.backend`` on the card; tests pass
the reference's simulator as a deterministic label source).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.tunedb.session import backend_fingerprint, record_from_search
from repro_torch.tunedb.store import RecordStore, input_key, normalize_config

from .dataset import generate_dataset
from .features import Featurizer
from .generative import CategoricalSampler
from .mlp import MLP
from .search import SearchResult, exhaustive_search
from .space import Config, ParamSpace


@dataclasses.dataclass
class InputAwareTuner:
    """Trained input-aware tuner for one parameter space."""

    space: ParamSpace
    model: MLP
    featurizer: Featurizer
    sampler: CategoricalSampler
    backend: Any
    top_k: int = 10
    store: Optional[RecordStore] = None
    _mem_cache: Dict[str, Config] = dataclasses.field(default_factory=dict)

    # -- training (the offline hours of §4-§5) --------------------------------
    @classmethod
    def train(cls, space: ParamSpace, *, backend: Any,
              n_samples: int = 20000, hidden: Tuple[int, ...] = (64, 128, 64),
              epochs: int = 40, seed: int = 0,
              store: Optional[RecordStore] = None,
              verbose: bool = False) -> "InputAwareTuner":
        ds, sampler = generate_dataset(space, n_samples, backend=backend,
                                       seed=seed, verbose=verbose)
        featurizer, X, y = ds.featurize()
        model = MLP.create(seed, in_dim=featurizer.dim, hidden=hidden)
        model.fit(X, y, epochs=epochs, verbose=verbose)
        return cls(space=space, model=model, featurizer=featurizer,
                   sampler=sampler, backend=backend, store=store)

    # -- runtime inference (§6) ------------------------------------------------
    def search(self, inputs: Mapping[str, int], *, remeasure: bool = True
               ) -> SearchResult:
        measure = (lambda cfg: self.backend.measure(self.space.name, cfg,
                                                    inputs)) if remeasure else None
        return exhaustive_search(self.space, inputs, model=self.model,
                                 featurizer=self.featurizer, top_k=self.top_k,
                                 measure=measure)

    def best_config(self, inputs: Mapping[str, int], *,
                    remeasure: bool = True) -> Config:
        """Best known config for ``inputs``: memo -> store -> search."""
        key = input_key(self.space.name, inputs)
        if key in self._mem_cache:
            return self._mem_cache[key]
        fp = backend_fingerprint(self.backend)
        if self.store is not None:
            # fingerprint-scoped: another backend's record is not THIS
            # backend's answer — the search below writes our own instead
            rec = self.store.get(self.space.name, inputs, backend=fp)
            if rec is not None:
                cfg = normalize_config(rec.config)
                self._mem_cache[key] = cfg
                return cfg
        res = self.search(inputs, remeasure=remeasure)
        cfg = normalize_config(res.best)
        self._mem_cache[key] = cfg
        if self.store is not None:
            self.store.add(record_from_search(self.space.name, inputs, res,
                                              self.backend, source="tuner"))
        return cfg

    # -- persistence (the reference's file layout) -----------------------------
    def save(self, directory: str) -> None:
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{self.space.name}.mlp.npz").write_bytes(self.model.to_bytes())
        (d / f"{self.space.name}.feat.json").write_text(self.featurizer.to_json())
        (d / f"{self.space.name}.sampler.json").write_text(self.sampler.to_json())

    @classmethod
    def load(cls, directory: str, space: ParamSpace, *, backend: Any,
             store: Optional[RecordStore] = None) -> "InputAwareTuner":
        d = pathlib.Path(directory)
        model = MLP.from_bytes((d / f"{space.name}.mlp.npz").read_bytes())
        featurizer = Featurizer.from_json(
            space, (d / f"{space.name}.feat.json").read_text())
        sampler = CategoricalSampler.from_json(
            space, (d / f"{space.name}.sampler.json").read_text())
        return cls(space=space, model=model, featurizer=featurizer,
                   sampler=sampler, backend=backend, store=store)


_GLOBAL_TUNERS: Dict[str, InputAwareTuner] = {}


def install_tuner(tuner: InputAwareTuner) -> None:
    """Register a tuner under its space's name."""
    _GLOBAL_TUNERS[tuner.space.name] = tuner


def get_tuner(space_name: str) -> Optional[InputAwareTuner]:
    return _GLOBAL_TUNERS.get(space_name)


def clear_tuners() -> None:
    _GLOBAL_TUNERS.clear()
