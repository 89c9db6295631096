"""Kernel dispatch: route GEMMs and convolutions through tuned configs and
the kernels.

Every ``matmul``/``matmul2``/``conv2d`` resolves an input-aware config for
its shape (the paper's §6 runtime) and runs ``ops.matmul``/``ops.conv2d``
with it: the CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor.  Resolution follows
``repro.kernels.dispatch._resolve_cfg`` without the plan and model tiers:

  0. tuner    an installed tuner (``core.tuner.install_tuner``) answers
              through its ``best_config``: a training or benchmark process
  1. exact    the installed store's record for this shape (and fingerprint)
  2. nearest  the closest tuned shape within the store's log2 radius
  3. degraded the space's own vendor-style heuristics (the GEMM menu for
              GEMMs, the conv menu for convolutions), one warning per space

A record whose config the kernel cannot launch (a TPU-tuned ``bn=1024`` or
conv ``b_k=512``, say) never reaches the kernel: an exact one is passed over
with one warning, and the nearest tier only considers launchable records.
With no store installed the ops defaults apply (tier ``none``).

``check_config`` is the tuner's correctness gate: it runs a config's kernel
at a shape (on the card the whole shape, on the CPU the reference's
shrunken instance) and holds it to the kernel's plain version and to the
fp32 oracle.
"""

from __future__ import annotations

import collections
import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.heuristics import VendorHeuristicLibrary
from repro_torch.core.space import (FITS, SPACES, ConfigRejected, conv_input,
                                    gemm_input)
from repro_torch.core.tuner import get_tuner
from repro_torch.device import DeviceLike, on_cuda  # noqa: F401  (on_tpu)
from repro_torch.tunedb.store import serving_state, shape_key

from . import conv as _conv
from . import matmul as _matmul
from . import ops, ref

# resolutions per (space, tier) since the last reset
tier_counts: collections.Counter = collections.Counter()

# (generation, reason, space): one warning per serving generation
_WARNED: set = set()
_HEURISTIC_LIBS: Dict[str, VendorHeuristicLibrary] = {}
_HEURISTIC_MEMO: Dict[tuple, Dict[str, int]] = {}

# the gate's bound: max-abs error over the oracle's max (the reference's)
GATE_RTOL = 2e-2


def _dtype_bits(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits


def _warn_once(key: tuple, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)


def reset_counts() -> None:
    tier_counts.clear()


def _launchable(space: str):
    fits = FITS[space]

    def legal(cfg: Mapping[str, int], inputs: Mapping[str, int]) -> bool:
        return fits(cfg, inputs["dtype_bits"])
    return legal


# spaces with a ported kernel: a record's config must launch on it.  Other
# spaces (attention's decode split count) only steer host-side code.
_LEGAL = {space: _launchable(space) for space in FITS}

# each space's vendor menu: a conv shape never gets a GEMM tile
_HEURISTIC_MAKERS = {"gemm": VendorHeuristicLibrary.gemm,
                     "conv": VendorHeuristicLibrary.conv}


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
            lib = _HEURISTIC_LIBS[space] = _HEURISTIC_MAKERS[space](
                SPACES[space])
        if len(_HEURISTIC_MEMO) > 4096:
            _HEURISTIC_MEMO.clear()
        cfg = _HEURISTIC_MEMO[key] = lib.select(inputs)
    return dict(cfg)


def _resolve_cfg(space: str, inputs: Mapping[str, int]
                 ) -> Tuple[Optional[Dict[str, int]], str]:
    """``(config, tier)`` for one call; tier is one of ``tuner``/``none``/
    ``exact``/``nearest``/``degraded``."""
    tuner = get_tuner(space)
    if tuner is not None:
        tier_counts[(space, "tuner")] += 1
        return tuner.best_config(inputs, remeasure=False), "tuner"
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


def conv2d(i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """SAME/stride-1 conv (N,H,W,C) * (R,S,C,K) through the tuned config."""
    N, H, W, C = i.shape
    R, S, _, K = f.shape
    inputs = conv_input(N, H, W, C, K, R, S, _dtype_bits(i.dtype))
    return ops.conv2d(i, f, _tuned_cfg("conv", inputs))


# ---------------------------------------------------------------------------
# Correctness gate used by CheckedBackend and the tests
# ---------------------------------------------------------------------------

def check_instance(space_name: str, inputs: Mapping[str, int], *,
                   max_dim: int = 512) -> Dict[str, int]:
    """The shrunken instance of ``inputs`` that ``check_config`` runs on
    the CPU: every dim capped at ``max_dim``; a conv also keeps at most 2
    images of at most 16 x 16 pixels (the reference's caps)."""
    cap = lambda v: int(min(v, max_dim))
    out = dict(inputs)
    if space_name == "gemm":
        out.update(M=cap(inputs["M"]), N=cap(inputs["N"]), K=cap(inputs["K"]))
    elif space_name == "conv":
        out.update(N=min(cap(inputs["N"]), 2), H=min(cap(inputs["H"]), 16),
                   W=min(cap(inputs["W"]), 16), C=cap(inputs["C"]),
                   K=cap(inputs["K"]))
    else:
        raise ValueError(f"no ported kernel for space {space_name!r}")
    return out


def gate_instance(space_name: str, inputs: Mapping[str, int],
                  device: DeviceLike) -> Dict[str, int]:
    """The problem ``check_config`` runs: the whole shape on the card, the
    reference's shrunken instance on the CPU."""
    if torch.device(device).type == "cpu":
        return check_instance(space_name, inputs)
    if space_name not in ("gemm", "conv"):
        raise ValueError(f"no ported kernel for space {space_name!r}")
    return dict(inputs)


def check_config(space_name: str, cfg: Mapping[str, int],
                 inputs: Mapping[str, int], *, device: DeviceLike = "cuda"
                 ) -> None:
    """Run the kernel for ``cfg`` at ``inputs`` and raise
    :class:`ConfigRejected` unless it agrees with its plain version and
    with the fp32 oracle.

    On a CUDA device the kernel runs at the whole shape, on operands drawn
    on the card: a reduction cut short would hide the rounding drift of the
    full one (at K=1536 an ``acc32=0`` GEMM drifts half as far again as at
    the reference's K cap of 512).  On the CPU its plain version runs on
    the reference gate's shrunken instance and seeded numpy operands, so
    the gate checks the config handling there and gives the reference's
    verdicts.  Both comparisons are max-abs error over the oracle's max,
    within :data:`GATE_RTOL`.  Every config is held to the oracle, as the
    reference's gate holds it: ``acc32=0`` in bf16 rounds the running sum
    after every sub-dot, and where that drifts past the bound the config
    is rejected.
    """
    dev = torch.device(device)
    small = gate_instance(space_name, inputs, dev)
    if space_name == "gemm":
        shapes = [(small["M"], small["K"]), (small["K"], small["N"])]
        scale = small["K"] ** 0.5
    else:
        R, S, C = small["R"], small["S"], small["C"]
        shapes = [(small["N"], small["H"], small["W"], C),
                  (R, S, C, small["K"])]
        scale = (R * S * C) ** 0.5
    if dev.type == "cpu":
        # seeded numpy operands, as the reference's gate makes them
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.normal(size=shapes[0]), dtype=torch.float32)
        y = torch.as_tensor(rng.normal(size=shapes[1]) / scale,
                            dtype=torch.float32)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x = torch.randn(shapes[0], generator=gen, device=dev)
        y = torch.randn(shapes[1], generator=gen, device=dev) / scale
    dtype = torch.bfloat16 if small.get("dtype_bits", 16) <= 16 \
        else torch.float32
    x, y = x.to(dtype), y.to(dtype)
    if space_name == "gemm":
        kernel, plain = _matmul.gemm, _matmul.matmul_plain
        run = ops.shrink_gemm_cfg(cfg, small["M"], small["N"], small["K"])
        oracle = ref.matmul_ref(x, y).float()
    else:
        kernel, plain = _conv.conv, _conv.conv2d_plain
        run = ops.shrink_conv_cfg(cfg, *(small[k] for k in
                                         ("N", "H", "W", "C", "K", "R", "S")))
        oracle = ref.conv2d_ref(x, y).float()
    # partials reduced in fp32, as ops.matmul / ops.conv2d reduce them
    got = kernel(x, y, run).float().sum(dim=0)
    if not bool(torch.isfinite(got).all()):
        raise ConfigRejected(f"{space_name} cfg {dict(cfg)}: non-finite output")
    scale = max(float(oracle.abs().max()), 1e-6)
    for what, want in (("plain version", plain(x, y, run).float().sum(dim=0)),
                       ("fp32 oracle", oracle)):
        err = float((got - want).abs().max()) / scale
        if err > GATE_RTOL:
            raise ConfigRejected(f"{space_name} cfg {dict(cfg)} on "
                                 f"{dict(small)}: rel err {err:.4f} > "
                                 f"{GATE_RTOL} against the {what}")
