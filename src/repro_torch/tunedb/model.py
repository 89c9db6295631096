"""Performance models served from the tuning-record store (paper §5-§6).

The port of ``repro.tunedb.model``: the records a store accumulates (each
session's winners and its measured losers, and the ``source="sample"``
labellings of :func:`collect_samples`) become the training set of an MLP
regressor per (space, backend fingerprint); at dispatch time a shape that
nobody tuned is resolved by the §6 runtime search, one batched forward pass
of the regressor over every legal config of that shape, instead of
borrowing its nearest tuned neighbour's config.

  * §5.1 dataset    :func:`harvest` turns the store's training log into
                    ``core.dataset.Dataset``\\ s
  * §5.2 features   ``core.features.Featurizer``: log2 transform and
                    standardisation, persisted with the model
  * §5.3 regressor  ``core.mlp.MLP``: ReLU MLP, Adam, MSE on log2(TFLOPS)
  * §6   runtime    :meth:`PerfModel.predict_config` /
                    :meth:`ModelSet.predict`: every legal config of the
                    port's space scored in one forward pass, memoized per
                    shape

Artifacts keep the reference's format, ``<space>--<slug>.json`` beside
``.npz``, so an artifact written by either package loads in the other.
The port's legal set holds only configs the kernels can launch
(``core.space``), so a reference-trained artifact scores the port's
configs.  Where the port differs on purpose:

  * :func:`collect_samples` labels through the backend it is given; the
    port's is the gated ``CheckedBackend(CudaEventBackend)``, and a draw
    whose config the gate rejects is neither recorded nor counted.
  * :meth:`ModelSet.predict` with an inline ``measurer`` (no
    ``measure_queue``) refuses to measure while a CUDA stream is capturing
    a graph.  With a queue attached (``tunedb/measure.py``, the serving
    engine's ``measure="wallclock"``) it only pushes, so it is safe there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import re
import time
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dataset import Dataset
from repro_torch.core.features import Featurizer
from repro_torch.core.mlp import MLP
from repro_torch.core.search import (SearchResult, enumerate_legal,
                                     exhaustive_search)
from repro_torch.core.space import SPACES, ConfigRejected, ParamSpace

from .session import backend_fingerprint
from .store import (SAMPLE_SOURCE, RecordStore, TuneRecord, install_serving,
                    normalize_config, normalize_inputs, serving_state,
                    shape_key)

MODEL_SCHEMA_VERSION = 1


class ModelArtifactError(ValueError):
    """Raised when a persisted model artifact cannot be loaded safely."""


def backend_slug(fingerprint: str) -> str:
    """Filesystem-safe, collision-resistant slug for a backend fingerprint."""
    clean = re.sub(r"[^A-Za-z0-9_.-]+", "-", fingerprint).strip("-") or "any"
    return f"{clean[:48]}-{hashlib.sha1(fingerprint.encode()).hexdigest()[:8]}"


def default_models_dir(store_path: os.PathLike) -> pathlib.Path:
    """Where a store's model artifacts live: ``<store>.models/`` beside it."""
    p = pathlib.Path(store_path)
    return p.with_name(p.name + ".models")


# ---------------------------------------------------------------------------
# §5.1: the record log as training sets
# ---------------------------------------------------------------------------

def harvest(store: RecordStore, *, space: Optional[str] = None,
            backend: Optional[str] = None,
            min_tflops: float = 1e-6) -> Dict[Tuple[str, str], Dataset]:
    """Every usable record of the store's training log, grouped by
    (space, backend) into Datasets, in file order.  Records with no
    throughput or whose config or inputs lack a parameter of the space are
    dropped."""
    grouped: Dict[Tuple[str, str], Dict[str, list]] = {}
    for rec in store.training_records(space=space, backend=backend):
        sp = SPACES.get(rec.space)
        if sp is None or rec.tflops <= min_tflops:
            continue
        if not all(k in rec.config for k in sp.param_names):
            continue
        if not all(k in rec.inputs for k in sp.input_params):
            continue
        g = grouped.setdefault((rec.space, rec.backend),
                               {"inputs": [], "configs": [], "tflops": []})
        g["inputs"].append(dict(rec.inputs))
        g["configs"].append(dict(rec.config))
        g["tflops"].append(rec.tflops)
    return {key: Dataset(space=SPACES[key[0]], inputs=g["inputs"],
                         configs=g["configs"],
                         tflops=np.asarray(g["tflops"], np.float64))
            for key, g in grouped.items()}


def collect_samples(store: RecordStore, backend, *, per_shape: int = 48,
                    space: Optional[str] = None, seed: int = 0) -> int:
    """Label up to ``per_shape`` random legal configs at every tuned shape
    (newest record first) and append them as ``sample`` records: the
    regressor must see mediocre configs too, not only the session's
    top-k.  A config the backend's gate rejects is skipped uncounted.
    Returns the number of samples committed."""
    rng = np.random.default_rng(seed)
    fp = backend_fingerprint(backend)
    shapes: List[Tuple[str, Dict[str, int]]] = []
    seen = set()
    for rec in sorted(store.records(), key=lambda r: -r.created_at):
        if (space is not None and rec.space != space) \
                or rec.space not in SPACES:
            continue
        key = (rec.space, shape_key(rec.inputs))
        if key not in seen:
            seen.add(key)
            shapes.append((rec.space, dict(rec.inputs)))
    n = 0
    for space_name, inputs in shapes:
        legal = enumerate_legal(SPACES[space_name], inputs)
        if not legal:
            continue
        for i in rng.permutation(len(legal))[:per_shape]:
            cfg = legal[int(i)]
            try:
                tflops = float(backend.measure(space_name, cfg, inputs))
            except ConfigRejected:      # the gate's verdict: not a sample
                continue
            store.add(TuneRecord(space=space_name, inputs=inputs,
                                 config=dict(cfg), tflops=tflops, backend=fp,
                                 source=SAMPLE_SOURCE))
            n += 1
    return n


# ---------------------------------------------------------------------------
# §5.3 + §6: one trained regressor per (space, backend fingerprint)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PerfModel:
    """A trained performance regressor for one (space, backend) pair."""

    space: ParamSpace
    backend: str                          # backend fingerprint it models
    model: MLP
    featurizer: Featurizer                # fitted
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> Tuple[str, str]:
        return (self.space.name, self.backend)

    def predict_config(self, inputs: Mapping[str, int], *, top_k: int = 1,
                       candidates: Optional[List[Dict[str, int]]] = None
                       ) -> SearchResult:
        """§6 runtime search: score every legal config (or
        ``candidates``) in one forward pass."""
        return exhaustive_search(self.space, normalize_inputs(inputs),
                                 model=self.model, featurizer=self.featurizer,
                                 top_k=top_k, candidates=candidates)

    def _stem(self) -> str:
        return f"{self.space.name}--{backend_slug(self.backend)}"

    def save(self, directory: os.PathLike) -> pathlib.Path:
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        stem = self._stem()
        npz_path = d / f"{stem}.npz"
        npz_tmp = npz_path.with_name(npz_path.name + ".tmp")
        npz_tmp.write_bytes(self.model.to_bytes())
        os.replace(npz_tmp, npz_path)    # never a readable meta + torn npz
        meta_path = d / f"{stem}.json"
        tmp = meta_path.with_name(meta_path.name + ".tmp")
        tmp.write_text(json.dumps({
            "model_schema_version": MODEL_SCHEMA_VERSION,
            "space": self.space.name,
            "backend": self.backend,
            "featurizer": json.loads(self.featurizer.to_json()),
            "meta": self.meta,
        }, sort_keys=True))
        os.replace(tmp, meta_path)
        return meta_path

    @classmethod
    def load(cls, meta_path: os.PathLike) -> "PerfModel":
        meta_path = pathlib.Path(meta_path)
        try:
            d = json.loads(meta_path.read_text())
        except (ValueError, OSError) as e:
            raise ModelArtifactError(f"{meta_path.name}: unreadable ({e})")
        try:
            version = int(d.get("model_schema_version", -1))
        except (TypeError, ValueError):
            version = -1
        if version != MODEL_SCHEMA_VERSION:
            raise ModelArtifactError(
                f"{meta_path.name}: model schema v{version} != "
                f"v{MODEL_SCHEMA_VERSION} (refusing to misread)")
        space = SPACES.get(d.get("space"))
        if space is None:
            raise ModelArtifactError(
                f"{meta_path.name}: unknown space {d.get('space')!r}")
        npz = meta_path.with_suffix(".npz")
        if not npz.exists():
            raise ModelArtifactError(f"{meta_path.name}: missing {npz.name}")
        try:
            featurizer = Featurizer.from_json(space,
                                              json.dumps(d["featurizer"]))
            model = MLP.from_bytes(npz.read_bytes())
            return cls(space=space, backend=d["backend"], model=model,
                       featurizer=featurizer, meta=dict(d.get("meta", {})))
        except Exception as e:   # noqa: BLE001 — a torn npz or malformed
            # meta is a damaged artifact: skipped, never fatal to serving
            raise ModelArtifactError(
                f"{meta_path.name}: damaged artifact "
                f"({type(e).__name__}: {e})")


def train_models(store: RecordStore, *, space: Optional[str] = None,
                 backend: Optional[str] = None, min_samples: int = 24,
                 hidden: Tuple[int, ...] = (64, 128, 64), epochs: int = 30,
                 val_frac: float = 0.1, seed: int = 0,
                 verbose: bool = False) -> "ModelSet":
    """Train one regressor per (space, backend) group with enough samples
    (the MLP is seeded with ``seed``, as the reference seeds its PRNG key)."""
    models = ModelSet()
    for (space_name, fp), ds in sorted(harvest(store, space=space,
                                               backend=backend).items()):
        if len(ds) < min_samples:
            if verbose:
                print(f"[model] {space_name}/{fp}: {len(ds)} samples "
                      f"< {min_samples}, skipping")
            continue
        train, val = ds.split(val_frac=val_frac, seed=seed)
        featurizer, X, y = train.featurize()
        _, Xv, yv = val.featurize(featurizer)
        model = MLP.create(seed, in_dim=featurizer.dim, hidden=hidden)
        history = model.fit(X, y, epochs=epochs, X_val=Xv, y_val=yv,
                            verbose=verbose)
        pm = PerfModel(space=ds.space, backend=fp, model=model,
                       featurizer=featurizer, meta={
                           "created_at": time.time(),
                           "n_samples": len(ds),
                           "hidden": list(hidden),
                           "epochs": epochs,
                           "seed": seed,
                           "val_mse": history[-1] if history else None,
                       })
        models.add(pm)
        if verbose:
            mse = pm.meta["val_mse"]
            print(f"[model] {space_name}/{fp}: trained on {len(ds)} samples, "
                  f"val mse {'n/a' if mse is None else f'{mse:.4f}'}")
    return models


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


# ---------------------------------------------------------------------------
# The serving side: the registry dispatch's model tier reads
# ---------------------------------------------------------------------------

class ModelSet:
    """Per-(space, backend) PerfModels with a memoized resolution per shape.

    ``measurer`` is the optional §6 top-k re-measurement: a callable
    ``(space_name, config, inputs) -> TFLOPS`` (a backend's ``measure``).
    When set, the first resolution of a shape measures the model's top
    ``remeasure_top_k`` configs and serves the measured winner; a config
    the gate rejects drops out.  It never measures while the current CUDA
    stream is capturing a graph: such a resolution raises.  With a
    ``measure_queue`` (``tunedb.measure.MeasureQueue``) attached as well,
    the resolution serves the model's argmax at once and pushes the top-k
    onto the queue, which the serving engine drains between decode ticks
    (:meth:`apply_measurement` commits each winner).  Without a measurer
    the model's argmax is served.

    Confidence gates (off at 0): a resolution is declined, and dispatch
    falls through to the nearest record, when the predicted top-1 beats
    the top-2 by less than ``margin_threshold`` (relative), or when an
    input feature lies more than ``max_feature_z`` training standard
    deviations from the featurizer's mean (off the training manifold).
    """

    def __init__(self, *, measurer=None, remeasure_top_k: int = 12,
                 margin_threshold: float = 0.0,
                 max_feature_z: float = 0.0) -> None:
        self.models: Dict[Tuple[str, str], PerfModel] = {}
        self.measurer = measurer
        # deferred re-measurement (serving): predict pushes the top-k here
        # instead of measuring inline
        self.measure_queue = None
        self.remeasure_top_k = remeasure_top_k
        self.margin_threshold = margin_threshold
        self.max_feature_z = max_feature_z
        self.hits = 0                    # resolutions served (memo or fresh)
        self.misses = 0                  # no model / no legal config / gated
        self.gated = 0                   # resolutions declined by a gate
        self.skipped: List[str] = []     # artifacts refused at load time
        self._memo: Dict[tuple, Optional[Tuple[Dict[str, int], float]]] = {}

    def add(self, pm: PerfModel) -> None:
        self.models[pm.key] = pm
        self._memo.clear()

    def invalidate_memos(self) -> None:
        """Drop per-shape resolutions (a serving-state install calls this)."""
        self._memo.clear()

    def apply_measurement(self, space: str, backend: Optional[str],
                          inputs: Mapping[str, int], cfg: Mapping[str, int],
                          tflops: float) -> None:
        """Serve a measured config for this shape from now on, in place of
        the model's pick."""
        inputs = normalize_inputs(inputs)
        memo_key = (space, backend, tuple(sorted(inputs.items())))
        self._memo[memo_key] = (normalize_config(cfg), float(tflops))

    def merged_with(self, newer: "ModelSet") -> "ModelSet":
        """A new set with this set's models overridden by ``newer``'s (a
        retrain's hot swap); the serving policy (measurer, measure queue,
        re-measure width, gates) stays this set's.  An empty queue is
        carried too (the reference's ``or`` drops a queue of length 0)."""
        out = ModelSet(measurer=self.measurer or newer.measurer,
                       remeasure_top_k=self.remeasure_top_k,
                       margin_threshold=self.margin_threshold,
                       max_feature_z=self.max_feature_z)
        out.measure_queue = (self.measure_queue
                             if self.measure_queue is not None
                             else newer.measure_queue)
        out.models.update(self.models)
        out.models.update(newer.models)
        return out

    def __len__(self) -> int:
        return len(self.models)

    def resolve_model(self, space: str, backend: Optional[str] = None
                      ) -> Optional[PerfModel]:
        """The (space, backend) model; with no backend, the newest model
        of the space."""
        if backend is not None:
            return self.models.get((space, backend))
        best = None
        for (sp, _), pm in self.models.items():
            if sp != space:
                continue
            if best is None or (pm.meta.get("created_at", 0)
                                > best.meta.get("created_at", 0)):
                best = pm
        return best

    def _off_manifold(self, pm: PerfModel, inputs: Mapping[str, int]) -> bool:
        """Does an input feature lie more than ``max_feature_z`` standard
        deviations from the training mean?  (Only the inputs: the §6 scan
        sweeps the tuning parameters.)"""
        f = pm.featurizer
        if self.max_feature_z <= 0 or f.mean is None:
            return False
        names = list(f.space.input_params)
        vals = np.asarray([float(inputs[k]) for k in names], np.float64)
        raw = np.log2(vals + 1.0) if f.log else vals
        n = len(names)                   # input dims lead the feature vector
        z = np.abs((raw - f.mean[:n]) / f.std[:n])
        return bool(z.max() > self.max_feature_z)

    def predict(self, space: str, inputs: Mapping[str, int], *,
                backend: Optional[str] = None
                ) -> Optional[Tuple[Dict[str, int], float]]:
        """(config, TFLOPS) for a shape: predicted, or measured where a
        measurer re-measures the top-k.  The first resolution of a shape
        pays the §6 scan; later ones are memo hits.  ``None`` (dispatch
        falls through) when no model covers the (space, backend), the shape
        has no legal config, or a confidence gate declines."""
        inputs = normalize_inputs(inputs)
        memo_key = (space, backend, tuple(sorted(inputs.items())))
        if memo_key in self._memo:
            out = self._memo[memo_key]
            if out is None:
                self.misses += 1
            else:
                self.hits += 1
            return out
        if (self.measurer is not None and self.measure_queue is None
                and _capturing()):
            raise RuntimeError(
                f"tunedb model: resolving a new {space} shape {inputs} would "
                "measure configs while a CUDA graph is being captured; "
                "resolve it before the capture")
        pm = self.resolve_model(space, backend)
        out: Optional[Tuple[Dict[str, int], float]] = None
        gated = False
        if pm is not None:
            try:
                if self._off_manifold(pm, inputs):
                    gated = True
                else:
                    k = (self.remeasure_top_k if self.measurer is not None
                         else 1)
                    if self.margin_threshold > 0:
                        k = max(k, 2)    # the gate needs the runner-up
                    res = pm.predict_config(inputs, top_k=k)
                    if self.margin_threshold > 0 and len(res.top_k) > 1:
                        p1, p2 = res.top_k[0][1], res.top_k[1][1]
                        if p1 <= 0 or (p1 - p2) / p1 < self.margin_threshold:
                            gated = True
                    if gated:
                        pass
                    elif (self.measurer is not None and len(res.top_k) > 1
                          and self.measure_queue is not None):
                        # serving: the argmax now, the top-k re-measured
                        # in an idle gap (MeasureQueue.process)
                        self.measure_queue.push(
                            space, backend, inputs,
                            [dict(c) for c, _ in res.top_k])
                        out = (normalize_config(res.best),
                               float(res.predicted_tflops))
                    elif self.measurer is not None and len(res.top_k) > 1:
                        measured = []
                        for cfg, _ in res.top_k:
                            try:
                                measured.append((cfg, float(self.measurer(
                                    space, cfg, inputs))))
                            except ConfigRejected:
                                continue
                        if measured:
                            cfg, tflops = max(measured, key=lambda t: t[1])
                            out = (normalize_config(cfg), tflops)
                    else:
                        out = (normalize_config(res.best),
                               float(res.predicted_tflops))
            except ValueError:           # no legal configuration for inputs
                out = None
            except Exception as e:   # noqa: BLE001 — an artifact whose
                # featurizer or space drifted degrades to the lower tiers
                # (warned once: the miss is memoized), never crashes dispatch
                warnings.warn(
                    f"tunedb model for {space!r} failed at resolution "
                    f"({type(e).__name__}: {e}); falling back",
                    RuntimeWarning, stacklevel=2)
                out = None
        if len(self._memo) > 4096:
            self._memo.clear()
        self._memo[memo_key] = out
        if gated:
            self.gated += 1
        if out is None:
            self.misses += 1
        else:
            self.hits += 1
        return out

    def save(self, directory: os.PathLike) -> pathlib.Path:
        d = pathlib.Path(directory)
        for pm in self.models.values():
            pm.save(d)
        return d

    @classmethod
    def load(cls, directory: os.PathLike, *, warn: bool = True) -> "ModelSet":
        """Every readable artifact of ``directory``; an unknown schema, a
        torn ``.json`` or a damaged ``.npz`` is skipped with one warning
        and noted in ``skipped``."""
        ms = cls()
        d = pathlib.Path(directory)
        if not d.is_dir():
            return ms
        for meta_path in sorted(d.glob("*.json")):
            try:
                ms.add(PerfModel.load(meta_path))
            except ModelArtifactError as e:
                ms.skipped.append(str(e))
                if warn:
                    warnings.warn(f"tunedb model artifact skipped: {e}",
                                  RuntimeWarning, stacklevel=2)
        return ms

    def stats(self) -> Dict[str, object]:
        return {
            "models": {
                f"{sp}/{fp}": dict(pm.meta)
                for (sp, fp), pm in sorted(self.models.items())},
            "lookups": {"hits": self.hits, "misses": self.misses,
                        "gated": self.gated},
            "gating": {"margin_threshold": self.margin_threshold,
                       "max_feature_z": self.max_feature_z},
            "skipped_artifacts": list(self.skipped),
        }


# ---------------------------------------------------------------------------
# The installed model set: a view of the port's serving state, so a store
# and its models swap in one generation
# ---------------------------------------------------------------------------

def install_models(models: Optional[ModelSet]) -> None:
    """Make ``models`` the port's dispatch model tier (``None`` turns it
    off)."""
    install_serving(models=models)


def get_models() -> Optional[ModelSet]:
    return serving_state().models


def clear_models() -> None:
    install_models(None)
