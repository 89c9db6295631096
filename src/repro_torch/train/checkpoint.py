"""Atomic, optionally async checkpoints in the reference's on-disk format
(port of ``repro.train.checkpoint``).

Format: one directory per step holding
  manifest.json  — step, data_step and each leaf's shape and dtype
  arrays.npz     — one entry per leaf, keyed by its tree path

A leaf's key is the reference's path string, so a training state of the
port and one of the reference line up key for key: ``params/...``,
``opt/.step``, ``opt/.m/...``, ``opt/.v/...``, ``ef/...`` and ``rng``
(dict keys by name, the optimizer state's fields as ``.step``, ``.m`` and
``.v``, as JAX names a NamedTuple's fields).  A bf16 leaf is stored as the
reference stores it: its 2-byte words as ``V2`` in the npz, ``"bfloat16"``
in the manifest; it is read back by viewing those bytes as bf16.  So a
checkpoint the reference wrote loads here, and one the port wrote of an
fp32 tree loads with the reference's ``load_checkpoint``.

The save is atomic (written to ``step-K.tmp``, then renamed) and keeps the
newest ``keep`` steps.  An async save copies every leaf to the host before
its writer thread starts, so training may go on changing the tensors.

The reference's ``rng`` leaf is a ``jax.random`` key, two uint32 words;
the port's training state keeps two uint32 words there too
(``train.trainer``), which seed its stochastic-rounding generator.  A
reference checkpoint's key therefore loads as it is, and the port's run
continues from those two words with its own draws, not the reference's
``jax.random`` stream.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim import AdamWState

_BF16 = "bfloat16"


def _items(tree: Any, prefix: str = ""):
    """(path, leaf) pairs in the reference's order: dict keys sorted, an
    ``AdamWState``'s fields as ``.step``, ``.m``, ``.v``."""
    if isinstance(tree, AdamWState):
        for name in AdamWState._fields:
            yield from _items(getattr(tree, name), f"{prefix}.{name}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array the npz holds, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)     # a CPU leaf is copied too
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        a = t.numpy()
    elif isinstance(leaf, int):
        a = np.asarray(leaf, np.int32)
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _flatten(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _to_host(v) for k, v in _items(tree)}


def _from_host(a: np.ndarray, dtype: str, like: Any, key: str) -> Any:
    """The stored array as the template leaf's kind: a tensor on the
    leaf's device, a host int, or a numpy array."""
    if dtype == _BF16:
        a = a.view(np.int16)
    want = tuple(like.shape) if hasattr(like, "shape") else ()
    if a.shape != want:
        raise ValueError(f"checkpoint leaf {key}: shape {a.shape}, the "
                         f"state wants {want}")
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(a))
        if dtype == _BF16:
            t = t.view(torch.bfloat16)
        if t.dtype != like.dtype:
            raise TypeError(f"checkpoint leaf {key}: dtype {t.dtype}, the "
                            f"state wants {like.dtype}")
        return t.to(like.device)
    if isinstance(like, int):
        return int(a)
    return np.array(a, dtype=np.asarray(like).dtype)


def _unflatten(template: Any, arrays: Dict[str, np.ndarray],
               dtypes: Dict[str, str], prefix: str = "") -> Any:
    if isinstance(template, AdamWState):
        return AdamWState(*(
            _unflatten(getattr(template, n), arrays, dtypes,
                       f"{prefix}.{n}/") for n in AdamWState._fields))
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, dtypes, f"{prefix}{k}/")
                for k, v in template.items()}
    key = prefix[:-1]
    if key not in arrays:
        raise KeyError(f"checkpoint has no leaf {key}")
    return _from_host(arrays[key], dtypes.get(key, ""), template, key)


def save_checkpoint(directory: str, step: int, state: Any, *,
                    data_step: int = 0, async_save: bool = False,
                    keep: int = 3) -> Optional[threading.Thread]:
    """Snapshot ``state`` (nested dicts, an ``AdamWState``, tensors,
    numpy arrays, ints) at ``step``.  Returns the writer thread when
    ``async_save`` (join it before exiting), else None."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    host = _flatten(state)             # the host copy, before any thread

    def write():
        tmp = d / f"step-{step}.tmp"
        final = d / f"step-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in host.items()})
        (tmp / "manifest.json").write_text(json.dumps({
            "step": step, "data_step": data_step,
            "keys": {k: {"shape": list(a.shape), "dtype": dt}
                     for k, (a, dt) in host.items()},
        }))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(d, keep)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(d: pathlib.Path, keep: int) -> None:
    steps = sorted(int(p.name.split("-")[1]) for p in d.glob("step-*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(d / f"step-{s}", ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory``, or None."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("-")[1]) for p in d.glob("step-*")
             if p.is_dir() and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template: Any, *,
                    step: Optional[int] = None) -> Tuple[Any, int, int]:
    """Restore (state, step, data_step).  ``template`` gives the tree, the
    shapes, the dtypes and the devices (a freshly initialised state); each
    stored leaf must have its template leaf's shape and dtype.  The newest
    step unless ``step`` is given."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = pathlib.Path(directory) / f"step-{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    dtypes = {k: v["dtype"] for k, v in manifest["keys"].items()}
    state = _unflatten(template, arrays, dtypes)
    return state, manifest["step"], manifest.get("data_step", 0)
