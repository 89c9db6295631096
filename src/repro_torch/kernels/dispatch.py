"""Kernel dispatch: route GEMMs, convolutions, attention and SSD scans
through tuned configs and the kernels.

Every ``matmul``/``matmul2``/``conv2d``/``flash_attention``/``ssd_scan``
records its shape into the shape telemetry (``tunedb.telemetry``),
resolves an input-aware config for it (the paper's §6 runtime) and runs
the matching ``ops`` entry point with it: the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor.  Resolution follows
``repro.kernels.dispatch._resolve_cfg``:

  tuner     an installed tuner (``core.tuner.install_tuner``) answers
            through its ``best_config``: a training or benchmark process
  plan      the generation's frozen dispatch plan (``tunedb.store.
            DispatchPlan``, compiled or loaded at install): one dict probe.
            It stands aside while the store has records newer than the
            plan; a miss falls through to the slow path below, whose
            answer is promoted into the plan
  exact     the installed store's record for this shape (and fingerprint)
  model     the installed performance model (``tunedb.model.ModelSet``)
            scores every legal config of the shape in one forward pass
            and its pick is memoized per shape (the paper's §6 answer for
            a shape nobody tuned)
  nearest   the closest tuned shape within the store's log2 radius
  degraded  the space's own vendor-style heuristics (the GEMM menu for
            GEMMs, the conv menu for convolutions), one warning per space;
            attention and SSD have no vendor menu, so their degraded tier
            returns no config and the ops defaults apply (the reference's
            rule)

A record or a model pick whose config the kernel cannot launch (a
TPU-tuned ``bn=1024``, conv ``b_k=512``, attention ``b_kv=2048`` or SSD
``chunk=512``, say) never reaches the kernel: it is passed over with one
warning per serving generation, and the nearest tier only considers
launchable records.  A plan holds only launchable configs (a compiled,
promoted or loaded entry alike), so a plan hit never skips that rule.
With neither a store, models nor a plan installed the ops defaults apply
(tier ``none``).

``check_config`` is the tuner's correctness gate: it runs a config's kernel
at a shape (on the card the whole shape, on the CPU the reference's
shrunken instance) and holds it to the kernel's plain version and to the
fp32 oracle.
"""

from __future__ import annotations

import collections
import functools
import warnings
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.heuristics import VendorHeuristicLibrary
from repro_torch.core.space import (SPACES, ConfigRejected, attention_input,
                                    conv_input, gemm_input, ssd_input)
from repro_torch.core.tuner import get_tuner
from repro_torch.device import DeviceLike, on_cuda  # noqa: F401  (on_tpu)
from repro_torch.tunedb.store import launchable, serving_state, shape_key
from repro_torch.tunedb.telemetry import record_shape

from . import attention as _attention
from . import conv as _conv
from . import matmul as _matmul
from . import ops, ref
from . import ssd as _ssd

# resolutions per (space, tier) since the last reset
tier_counts: collections.Counter = collections.Counter()

# (generation, reason, space): one warning per serving generation
_WARNED: set = set()
_HEURISTIC_LIBS: Dict[str, VendorHeuristicLibrary] = {}
_HEURISTIC_MEMO: Dict[tuple, Dict[str, int]] = {}

# the gate's bound: max-abs error over the oracle's max (the reference's)
GATE_RTOL = 2e-2

# the trace module, bound at the first resolution (an import here would
# cycle through tunedb): the tracing probe is one read of its ``_TRACER``
_TRACE = None


def _dtype_bits(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits


def _count_degraded(space: str) -> None:
    """One more dispatch served on the degraded tier, in the metrics
    registry's ``tunedb_dispatch_degraded_calls_total{reason, space}``:
    the warning below is once per generation, the count is every call."""
    try:
        from repro_torch.tunedb.obs.metrics import get_registry
        get_registry().counter(
            "tunedb_dispatch_degraded_calls_total",
            "dispatches served by the heuristic fallback tier").inc(
                reason="untuned", space=space)
    except Exception:       # noqa: BLE001 — metrics never block dispatch
        pass


def _warn_once(key: tuple, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)


def reset_counts() -> None:
    tier_counts.clear()


# each space's vendor menu: a conv shape never gets a GEMM tile
_HEURISTIC_MAKERS = {"gemm": VendorHeuristicLibrary.gemm,
                     "conv": VendorHeuristicLibrary.conv}


def _heuristic_cfg(space: str, inputs: Mapping[str, int]
                   ) -> Optional[Dict[str, int]]:
    """Vendor-style pick, memoized per shape: the menu scan costs more than
    the small GEMMs it picks for.  ``None`` for a space without a vendor
    menu (attention, SSD): the ops defaults apply, as in the reference."""
    if space not in _HEURISTIC_MAKERS:
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
    ``plan``/``exact``/``model``/``nearest``/``degraded``."""
    tuner = get_tuner(space)
    if tuner is not None:
        tier_counts[(space, "tuner")] += 1
        return tuner.best_config(inputs, remeasure=False), "tuner"
    state = serving_state()
    store, models, fp, plan = (state.store, state.models, state.fingerprint,
                               state.plan)
    if store is None and models is None and plan is None:
        tier_counts[(space, "none")] += 1
        return None, "none"
    key = None
    if plan is not None and (store is None
                             or store.version == plan.store_version):
        key = shape_key(inputs)
        entry = plan.lookup(space, key)
        if entry is not None:            # tier 0: frozen plan hit
            cfg, tier = entry
            plan.hits += 1
            # the entry's own tier keeps its credit, as on the slow path
            if store is not None:
                if tier == "exact":
                    store.hits += 1
                else:
                    store.misses += 1
                    if tier == "nearest":
                        store.nearest_hits += 1
            if tier == "model" and models is not None:
                models.hits = getattr(models, "hits", 0) + 1
            tier_counts[(space, "plan")] += 1
            return dict(cfg), "plan"
        plan.misses += 1
    # a record's or a model's config must launch on the space's kernel (at
    # the call's dtype, and head/state dims for attention and SSD), also
    # where only host code reads it (the decode split count from an
    # attention record): the plan's own rule, ``store.launchable``
    cfg = tier = None
    rec = store.get(space, inputs, backend=fp) if store is not None else None
    if rec is not None:
        if launchable(space, rec.config, inputs):
            cfg, tier = dict(rec.config), "exact"
        else:
            _warn_once((state.generation, "illegal", space),
                       f"tunedb: record config {rec.config} for {space} "
                       f"shape {dict(inputs)} cannot launch on sm_90a; "
                       "falling through to the model and nearest tiers")
    if cfg is None and models is not None:
        got = models.predict(space, inputs, backend=fp)
        if got is not None:
            if launchable(space, got[0], inputs):
                cfg, tier = dict(got[0]), "model"
            else:
                _warn_once((state.generation, "illegal-model", space),
                           f"tunedb: model pick {got[0]} for {space} shape "
                           f"{dict(inputs)} cannot launch on sm_90a; "
                           "falling through to the nearest launchable "
                           "record")
    if cfg is None and store is not None:
        rec = store.nearest(space, inputs, backend=fp,
                            legal=functools.partial(launchable, space))
        if rec is not None:
            cfg, tier = dict(rec.config), "nearest"
    if cfg is not None:
        if key is not None and (store is None
                                or store.version == plan.store_version):
            plan.promote(space, key, cfg, tier)
    else:
        _count_degraded(space)
        _warn_once((state.generation, "untuned", space),
                   f"tunedb: no launchable record, model pick or neighbor "
                   f"for a {space} shape {dict(inputs)}; serving on "
                   + ("vendor heuristics" if space in _HEURISTIC_MAKERS
                      else "the ops defaults"))
        cfg, tier = _heuristic_cfg(space, inputs), "degraded"
    tier_counts[(space, tier)] += 1
    return cfg, tier


def _tuned_cfg(space: str, inputs: Mapping[str, int]
               ) -> Optional[Dict[str, int]]:
    """The config of one call (:func:`_resolve_cfg`).  With tracing on, the
    resolution is timed in a ``dispatch.resolve`` span under the thread's
    open trace (a no-op where none is open) with its winning ``tier`` and
    its ``shape``; with tracing off it costs one module-attribute read."""
    global _TRACE
    t = _TRACE
    if t is None:
        from repro_torch.tunedb.obs import trace as t
        _TRACE = t
    tr = t._TRACER
    if tr is not None:
        with tr.span("dispatch.resolve", space=space) as sp:
            cfg, tier = _resolve_cfg(space, inputs)
            if sp is not None:
                sp.attrs["tier"] = tier
                sp.attrs["shape"] = ",".join(
                    f"{k}={v}" for k, v in sorted(inputs.items()))
        return cfg
    return _resolve_cfg(space, inputs)[0]


def _record(space: str, inputs: Mapping[str, int]) -> None:
    """Count one call of ``space`` at ``inputs`` in the shape telemetry."""
    record_shape(space, inputs)


def _gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One GEMM: the shape recorded, its config resolved, ``ops.matmul``."""
    inputs = gemm_input(a.shape[0], b.shape[1], a.shape[1],
                        _dtype_bits(a.dtype))
    _record("gemm", inputs)
    cfg = _tuned_cfg("gemm", inputs)
    return ops.matmul(a, b, cfg)


class _TunedGemm(torch.autograd.Function):
    """C = A @ B through the tuned dispatch, with its gradient: dA = dC·Bᵀ
    and dB = Aᵀ·dC, each a GEMM of its own through :func:`matmul` (so
    through the hand-written kernel on the card), only where
    ``needs_input_grad`` asks for it.  Each backward product records its
    own shape in the telemetry and resolves its own tuned config, so the
    tuner sees the training step's backward shapes; the reference's
    telemetry records shapes at trace time and never sees XLA's backward
    dots.  ``ops.matmul`` makes the transposed operand (Bᵀ or Aᵀ, a view)
    row-major: that copy is the relayout a transposed operand costs."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _gemm(a, b)

    @staticmethod
    def backward(ctx, dc: torch.Tensor):
        a, b = ctx.saved_tensors
        dc = dc.to(a.dtype).contiguous()
        da = matmul(dc, b.t()) if ctx.needs_input_grad[0] else None
        db = matmul(a.t(), dc) if ctx.needs_input_grad[1] else None
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Model-facing 2-D GEMM through the tuned config.  Where autograd
    records (grad mode on and an operand requiring grad) the call goes
    through :class:`_TunedGemm`, on the CPU as on the card, so the
    gradient runs the same kernel; otherwise it makes no autograd node."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _TunedGemm.apply(a, b)
    return _gemm(a, b)


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
    _record("conv", inputs)
    return ops.conv2d(i, f, _tuned_cfg("conv", inputs))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Flash attention q (B,Hq,Lq,D), k/v (B,Hkv,Lkv,D) through the tuned
    config (``ops.flash_attention``'s semantics)."""
    B, Hq, Lq, D = q.shape
    inputs = attention_input(B, Hq, k.shape[1], Lq, k.shape[2], D,
                             _dtype_bits(q.dtype), causal)
    _record("attention", inputs)
    return ops.flash_attention(q, k, v, _tuned_cfg("attention", inputs),
                               causal=causal, q_offset=q_offset)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """SSD chunk scan x (B,L,H,P), dt (B,L,H), a (H,), B/C (B,L,S) through
    the tuned config."""
    B, L, H, P = x.shape
    inputs = ssd_input(B, L, H, P, bm.shape[-1], _dtype_bits(x.dtype))
    _record("ssd", inputs)
    return ops.ssd_scan(x, dt, a, bm, cm, _tuned_cfg("ssd", inputs))


# ---------------------------------------------------------------------------
# Correctness gate used by CheckedBackend and the tests
# ---------------------------------------------------------------------------

def check_instance(space_name: str, inputs: Mapping[str, int], *,
                   max_dim: int = 512) -> Dict[str, int]:
    """The shrunken instance of ``inputs`` that ``check_config`` runs on
    the CPU: every dim capped at ``max_dim``; a conv also keeps at most 2
    images of at most 16 x 16 pixels; attention at most B=2, Hq=4 (Hkv cut
    to a divisor of it) and D=128; SSD at most B=2, H=4, P=64, S=64 (the
    reference's caps)."""
    cap = lambda v: int(min(v, max_dim))
    out = dict(inputs)
    if space_name == "gemm":
        out.update(M=cap(inputs["M"]), N=cap(inputs["N"]), K=cap(inputs["K"]))
    elif space_name == "conv":
        out.update(N=min(cap(inputs["N"]), 2), H=min(cap(inputs["H"]), 16),
                   W=min(cap(inputs["W"]), 16), C=cap(inputs["C"]),
                   K=cap(inputs["K"]))
    elif space_name == "attention":
        hq = min(inputs["Hq"], 4)
        hkv = min(inputs["Hkv"], hq)
        while hq % hkv:
            hkv -= 1
        out.update(B=min(inputs["B"], 2), Hq=hq, Hkv=hkv,
                   Lq=cap(inputs["Lq"]), Lkv=cap(inputs["Lkv"]),
                   D=min(inputs["D"], 128))
    elif space_name == "ssd":
        out.update(B=min(inputs["B"], 2), L=cap(inputs["L"]),
                   H=min(inputs["H"], 4), P=min(inputs["P"], 64),
                   S=min(inputs["S"], 64))
    else:
        raise ValueError(f"no ported kernel for space {space_name!r}")
    return out


def gate_instance(space_name: str, inputs: Mapping[str, int],
                  device: DeviceLike) -> Dict[str, int]:
    """The problem ``check_config`` runs: the whole shape on the card, the
    reference's shrunken instance on the CPU."""
    if torch.device(device).type == "cpu":
        return check_instance(space_name, inputs)
    if space_name not in SPACES:
        raise ValueError(f"no ported kernel for space {space_name!r}")
    return dict(inputs)


def gate_causal(inputs: Mapping[str, int]) -> bool:
    """Does the gate (and the timer) run an attention shape causal?  Only
    where Lq == Lkv, as the reference's gate has it: a causal query block
    shorter than its cache is a decode step, which sees every key."""
    return bool(inputs.get("causal", 1)) and inputs["Lq"] == inputs["Lkv"]


# fp32 scores the gate's attention oracle materialises at once, at most
ORACLE_SCORE_BYTES = 1 << 30


def _attention_oracle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, q_offset: int = 0) -> torch.Tensor:
    """``ref.attention_ref`` one KV head's query group and at most
    :data:`ORACLE_SCORE_BYTES` of fp32 scores at a time (row blocks keep
    their causal offset): the same numbers, without materialising every
    head's scores at once (40 heads x 4096^2 would be 2.7 GB for each of
    several intermediates)."""
    B, Hq, Lq, _ = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    rows = max(1, ORACLE_SCORE_BYTES // (4 * B * group * Lkv))
    out = torch.empty_like(q)
    for h in range(Hkv):
        hs = slice(h * group, (h + 1) * group)
        for r0 in range(0, Lq, rows):
            out[:, hs, r0:r0 + rows] = ref.attention_ref(
                q[:, hs, r0:r0 + rows], k[:, h:h + 1], v[:, h:h + 1],
                causal=causal, q_offset=q_offset + r0)
    return out


def _gate_operands(space_name: str, small: Mapping[str, int],
                   dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """Operands of the gate's problem: seeded numpy draws on the CPU (the
    reference gate's draws, in its order), a seeded generator on the
    card.  Values are fp32 here; the IO dtype is applied by the caller."""
    if space_name == "gemm":
        scale = small["K"] ** 0.5
        draws = [("normal", (small["M"], small["K"]), 1.0),
                 ("normal", (small["K"], small["N"]), scale)]
    elif space_name == "conv":
        R, S, C = small["R"], small["S"], small["C"]
        draws = [("normal", (small["N"], small["H"], small["W"], C), 1.0),
                 ("normal", (R, S, C, small["K"]), (R * S * C) ** 0.5)]
    elif space_name == "attention":
        B, D = small["B"], small["D"]
        draws = [("normal", (B, small["Hq"], small["Lq"], D), 1.0),
                 ("normal", (B, small["Hkv"], small["Lkv"], D), 1.0),
                 ("normal", (B, small["Hkv"], small["Lkv"], D), 1.0)]
    else:
        B, L, H = small["B"], small["L"], small["H"]
        draws = [("normal", (B, L, H, small["P"]), 1.0),
                 ("dt", (B, L, H), None), ("a", (H,), None),
                 ("normal", (B, L, small["S"]), 1.0),
                 ("normal", (B, L, small["S"]), 1.0)]
    out = []
    if dev.type == "cpu":
        rng = np.random.default_rng(0)
        for kind, shape, scale in draws:
            if kind == "normal":
                x = rng.normal(size=shape) / scale
            elif kind == "dt":
                x = rng.uniform(0.01, 0.1, size=shape)
            else:
                x = -rng.uniform(0.5, 2.0, size=shape)
            out.append(torch.as_tensor(x, dtype=torch.float32))
        return tuple(out)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for kind, shape, scale in draws:
        if kind == "normal":
            x = torch.randn(shape, generator=gen, device=dev) / scale
        else:
            u = torch.rand(shape, generator=gen, device=dev)
            x = 0.01 + 0.09 * u if kind == "dt" else -(0.5 + 1.5 * u)
        out.append(x)
    return tuple(out)


# spaces whose gate oracle is worth keeping between configs: at full size
# the SSD oracle is a Python loop over L and the attention oracle a
# quadratic pass; GEMM and conv operands are cheaper to redraw than to hold
CACHED_SPACES = ("attention", "ssd")


class GateCases:
    """The gate's operands and fp32 oracle per (space, instance, device),
    for :data:`CACHED_SPACES`: the oracle of a shape is computed once
    however many configs are checked there.  The least recently used
    cases are dropped past ``max_bytes`` (the newest is always kept).  The
    owner decides how long the tensors live: ``CheckedBackend`` holds one
    and a tuning session clears it when it ends."""

    def __init__(self, max_bytes: int = 16 << 30):
        self.max_bytes = max_bytes
        self._cases: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._cases)

    def clear(self) -> None:
        self._cases.clear()

    def get(self, space_name: str, small: Mapping[str, int],
            dev: torch.device
            ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        if space_name not in CACHED_SPACES:
            return _gate_case(space_name, small, dev)
        key = (space_name, shape_key(small), str(dev))
        case = self._cases.get(key)
        if case is not None:
            self._cases.move_to_end(key)
            return case
        case = self._cases[key] = _gate_case(space_name, small, dev)
        total = sum(_case_bytes(c) for c in self._cases.values())
        while len(self._cases) > 1 and total > self.max_bytes:
            total -= _case_bytes(self._cases.popitem(last=False)[1])
        return case


def _case_bytes(case: tuple) -> int:
    xs, oracle = case
    return sum(t.numel() * t.element_size() for t in (*xs, oracle))


def _gate_case(space_name: str, small: Mapping[str, int], dev: torch.device
               ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The gate's operands (IO dtype; SSD's ``a`` in fp32) and fp32 oracle."""
    dtype = torch.bfloat16 if small.get("dtype_bits", 16) <= 16 \
        else torch.float32
    xs = _gate_operands(space_name, small, dev)
    # a stays fp32 (the reference's SSD takes it so); the rest in IO dtype
    xs = tuple(x if (space_name == "ssd" and j == 2) else x.to(dtype)
               for j, x in enumerate(xs))
    if space_name == "gemm":
        oracle = ref.matmul_ref(*xs)
    elif space_name == "conv":
        oracle = ref.conv2d_ref(*xs)
    elif space_name == "attention":
        oracle = _attention_oracle(*xs, gate_causal(small))
    else:
        oracle = ref.ssd_ref(*xs)
    return xs, oracle.float()


def _gate_runs(space_name: str, cfg: Mapping[str, int],
               small: Mapping[str, int]
               ) -> Tuple[Callable[..., torch.Tensor],
                          Callable[..., torch.Tensor]]:
    """(kernel, plain) for the gate: each maps the operands to the reduced
    fp32 output under ``cfg`` shrunk to the instance, as ``ops`` would run
    it (split partials summed in fp32)."""
    bits = small.get("dtype_bits", 16)
    if space_name == "gemm":
        run = ops.shrink_gemm_cfg(cfg, small["M"], small["N"], small["K"],
                                  bits)
        return (lambda *x: _matmul.gemm(*x, run).float().sum(dim=0),
                lambda *x: _matmul.matmul_plain(*x, run).float().sum(dim=0))
    if space_name == "conv":
        run = ops.shrink_conv_cfg(cfg, *(small[k] for k in
                                         ("N", "H", "W", "C", "K", "R", "S")))
        return (lambda *x: _conv.conv(*x, run).float().sum(dim=0),
                lambda *x: _conv.conv2d_plain(*x, run).float().sum(dim=0))
    if space_name == "attention":
        run = ops.shrink_attention_cfg(cfg, small["Lq"], small["Lkv"],
                                       small["D"], bits,
                                       group=small["Hq"] // small["Hkv"])
        causal = gate_causal(small)
        return (lambda *x: _attention.attention(*x, run,
                                                causal=causal).float(),
                lambda *x: _attention.attention_plain(*x, run,
                                                      causal=causal).float())
    run = ops.shrink_ssd_cfg(cfg, small["L"], small["H"], small["P"],
                             small["S"], bits)
    return (lambda *x: _ssd.ssd(*x, run).float(),
            lambda *x: _ssd.ssd_plain(*x, run).float())


def check_config(space_name: str, cfg: Mapping[str, int],
                 inputs: Mapping[str, int], *, device: DeviceLike = "cuda",
                 cases: Optional[GateCases] = None) -> None:
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
    is rejected.  Attention runs causal only where Lq == Lkv
    (:func:`gate_causal`); a ragged KV length is masked by length, so the
    shapes where the reference's gate rejects every config for its
    offset trick (non-causal, Lkv not a multiple of ``b_kv``, Lq > 1)
    pass here.  ``cases``, where given, keeps the operands and oracle of
    an attention or SSD instance for the next config checked there;
    without it they are drawn anew and dropped.
    """
    dev = torch.device(device)
    small = gate_instance(space_name, inputs, dev)
    xs, oracle = (cases.get(space_name, small, dev) if cases is not None
                  else _gate_case(space_name, small, dev))
    kernel, plain = _gate_runs(space_name, cfg, small)
    got = kernel(*xs)
    if not bool(torch.isfinite(got).all()):
        raise ConfigRejected(f"{space_name} cfg {dict(cfg)}: non-finite output")
    scale = max(float(oracle.abs().max()), 1e-6)
    for what, want in (("plain version", plain(*xs)), ("fp32 oracle", oracle)):
        err = float((got - want).abs().max()) / scale
        if err > GATE_RTOL:
            raise ConfigRejected(f"{space_name} cfg {dict(cfg)} on "
                                 f"{dict(small)}: rel err {err:.4f} > "
                                 f"{GATE_RTOL} against the {what}")
