"""Kernel dispatch: route model GEMMs through tuned configs and the kernel.

Every ``matmul``/``matmul2`` resolves an input-aware config for its shape
(the paper's §6 runtime) and runs ``ops.matmul`` with it: the CUDA kernel
for a CUDA tensor, its plain version for a CPU tensor.  Resolution follows
``repro.kernels.dispatch._resolve_cfg`` without the plan and model tiers:

  1. exact    the installed store's record for this shape (and fingerprint)
  2. nearest  the closest tuned shape within the store's log2 radius
  3. degraded vendor-style heuristics, with one warning per space

A record whose config the kernel cannot launch (a TPU-tuned ``bn=1024``, say)
never reaches the kernel: an exact one is passed over with one warning, and
the nearest tier only considers launchable records.  With no store
installed the ops defaults apply (tier ``none``).
"""

from __future__ import annotations

import collections
import warnings
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.heuristics import VendorHeuristicLibrary
from repro_torch.core.space import SPACES, gemm_fits, gemm_input
from repro_torch.device import on_cuda  # noqa: F401  (the reference's on_tpu)
from repro_torch.tunedb.store import serving_state, shape_key

from . import ops

# resolutions per (space, tier) since the last reset
tier_counts: collections.Counter = collections.Counter()

# (generation, reason, space): one warning per serving generation
_WARNED: set = set()
_HEURISTIC_LIBS: Dict[str, VendorHeuristicLibrary] = {}
_HEURISTIC_MEMO: Dict[tuple, Dict[str, int]] = {}


def _dtype_bits(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits


def _warn_once(key: tuple, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)


def reset_counts() -> None:
    tier_counts.clear()


def _gemm_launchable(cfg: Mapping[str, int], inputs: Mapping[str, int]
                     ) -> bool:
    return gemm_fits(cfg, inputs["dtype_bits"])


# spaces with a ported kernel: a record's config must launch on it.  Other
# spaces (attention's decode split count) only steer host-side code.
_LEGAL = {"gemm": _gemm_launchable}


def _heuristic_cfg(space: str, inputs: Mapping[str, int]
                   ) -> Optional[Dict[str, int]]:
    """Vendor-style pick, memoized per shape: the menu scan costs more than
    the small GEMMs it picks for."""
    if space not in SPACES:
        return None                     # ops-layer defaults apply
    key = (space, shape_key(inputs))
    cfg = _HEURISTIC_MEMO.get(key)
    if cfg is None:
        lib = _HEURISTIC_LIBS.get(space)
        if lib is None:
            lib = _HEURISTIC_LIBS[space] = VendorHeuristicLibrary.gemm(
                SPACES[space])
        if len(_HEURISTIC_MEMO) > 4096:
            _HEURISTIC_MEMO.clear()
        cfg = _HEURISTIC_MEMO[key] = lib.select(inputs)
    return dict(cfg)


def _resolve_cfg(space: str, inputs: Mapping[str, int]
                 ) -> Tuple[Optional[Dict[str, int]], str]:
    """``(config, tier)`` for one call; tier is one of ``none``/``exact``/
    ``nearest``/``degraded``."""
    state = serving_state()
    store, fp = state.store, state.fingerprint
    if store is None:
        tier_counts[(space, "none")] += 1
        return None, "none"
    legal = _LEGAL.get(space)
    cfg = tier = None
    rec = store.get(space, inputs, backend=fp)
    if rec is not None:
        if legal is None or legal(rec.config, inputs):
            cfg, tier = dict(rec.config), "exact"
        else:
            _warn_once((state.generation, "illegal", space),
                       f"tunedb: record config {rec.config} for {space} "
                       f"shape {dict(inputs)} cannot launch on sm_90a; "
                       "falling through to the nearest launchable record")
    if cfg is None:
        rec = store.nearest(space, inputs, backend=fp, legal=legal)
        if rec is not None:
            cfg, tier = dict(rec.config), "nearest"
    if cfg is None:
        _warn_once((state.generation, "untuned", space),
                   f"tunedb: no launchable record or neighbor for a {space} "
                   f"shape {dict(inputs)}; serving on vendor heuristics")
        cfg, tier = _heuristic_cfg(space, inputs), "degraded"
    tier_counts[(space, tier)] += 1
    return cfg, tier


def _tuned_cfg(space: str, inputs: Mapping[str, int]
               ) -> Optional[Dict[str, int]]:
    return _resolve_cfg(space, inputs)[0]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Model-facing 2-D GEMM through the tuned config."""
    inputs = gemm_input(a.shape[0], b.shape[1], a.shape[1],
                        _dtype_bits(a.dtype))
    cfg = _tuned_cfg("gemm", inputs)
    return ops.matmul(a, b, cfg)


def matmul2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection (..., D) @ (D, F) -> (..., F); leading dims fold into M so
    the tuner sees the true GEMM shape."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return matmul(x2, w).reshape(*lead, w.shape[-1])
