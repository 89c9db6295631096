"""Convert a reference parameter tree into the port's parameters.

The tree is what ``repro.models.init_params`` returns, as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``): ``embed``, ``final_norm``
and, per pattern position ``pos{i}``, ``norm1``, ``norm2``, the mixer
(``attn.{wq, wk, wv, wo}`` with ``q_norm`` / ``k_norm`` under qk-norm, or
``mamba.{w_in, conv_w, conv_b, a_log, dt_bias, d_skip, norm, w_out}``),
for a SwiGLU MLP (``dense``, ``moe+dense``) ``mlp.{w_gate, w_up, w_down}``
and for a MoE (``moe``, ``moe+dense``) ``moe.{router, w_gate, w_up,
w_down}``, stacked over the repeats; an encoder-decoder adds
``cross.{wq, wk, wv, wo}`` and ``norm_cross`` to every decoder layer and
the ``encoder`` tree (``pos0``, one (attn, dense) layer stacked over
``encoder_layers``, and ``norm``).  The layout is kept as it is.  Every
leaf must have the dtype the reference gives it: the config's, except
Mamba's fp32 ``a_log``, ``dt_bias`` and ``d_skip`` and the MoE's fp32
``router``.

``train_state_from_jax`` carries a reference training state across: its
params as above, the AdamW step, m and v, the error feedback and the key.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import (ATTN, DENSE, MOE, MOE_DENSE, ModelConfig,
                                tree_leaves)
from repro_torch.models.moe import MOE_KEYS
from repro_torch.models.ssm import FP32_LEAVES

_ATTN = ("wq", "wk", "wv", "wo")
_MAMBA = ("w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm",
          "w_out")
_MLP = ("w_gate", "w_up", "w_down")


def _tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a type torch.from_numpy takes; the
        # round trip through float32 is exact both ways
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)      # a writable copy


def _dtypes(cfg: ModelConfig) -> dict:
    """The reference's tree for ``cfg`` with each leaf's dtype."""
    dt = cfg.dtype
    same = lambda names: {k: dt for k in names}

    def layer(mixer: str, mlp_kind: str, cross: bool) -> dict:
        out: dict = {"norm1": dt, "norm2": dt}
        if mixer == ATTN:
            out["attn"] = same(_ATTN + (("q_norm", "k_norm")
                                        if cfg.qk_norm else ()))
        else:
            out["mamba"] = {k: torch.float32 if k in FP32_LEAVES else dt
                            for k in _MAMBA}
        if cross:
            out["cross"] = same(_ATTN)
            out["norm_cross"] = dt
        if mlp_kind in (DENSE, MOE_DENSE):
            out["mlp"] = same(_MLP)
        if mlp_kind in (MOE, MOE_DENSE):
            out["moe"] = {k: torch.float32 if k == "router" else dt
                          for k in MOE_KEYS}
        return out

    tree = {"embed": dt, "final_norm": dt,
            "layers": {f"pos{i}": layer(mixer, mlp_kind, cfg.is_encdec)
                       for i, (mixer, mlp_kind) in enumerate(cfg.pattern)}}
    if cfg.is_encdec:
        tree["encoder"] = {"pos0": layer(ATTN, DENSE, False), "norm": dt}
    return tree


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> dict:
    """Reference parameter tree (numpy leaves) -> port params on ``device``."""
    cfg.check_supported()
    dev = resolve_device(device)

    def conv(t: Any, want: Any, where: str) -> Any:
        if isinstance(want, dict):
            if not isinstance(t, Mapping) or set(t) != set(want):
                got = sorted(t) if isinstance(t, Mapping) else type(t)
                raise KeyError(f"{where}: expected keys {sorted(want)}, got "
                               f"{got}")
            return {k: conv(t[k], want[k], f"{where}.{k}") for k in want}
        out = _tensor(t, dev)
        if out.dtype != want:
            raise TypeError(f"{where}: leaf dtype {out.dtype}, the "
                            f"reference's is {want}")
        for stack, repeats in (("params.layers.", cfg.n_repeats),
                               ("params.encoder.pos0.", cfg.encoder_layers)):
            if where.startswith(stack) and (
                    out.dim() == 0 or out.shape[0] != repeats):
                raise ValueError(f"{where}: tree holds "
                                 f"{tuple(out.shape)[:1]} repeats, config "
                                 f"wants {repeats}")
        return out

    return conv(tree, _dtypes(cfg), "params")


def _like(tree: Any, params: Any, where: str, dtype=None) -> Any:
    """``tree`` (numpy leaves) as tensors on the devices of ``params``, key
    for key and shape for shape; each leaf keeps its stored dtype, which
    must be ``dtype`` where given."""
    if isinstance(params, dict):
        if not isinstance(tree, Mapping) or set(tree) != set(params):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree)
            raise KeyError(f"{where}: expected keys {sorted(params)}, got "
                           f"{got}")
        return {k: _like(tree[k], params[k], f"{where}.{k}", dtype)
                for k in params}
    out = _tensor(tree, params.device)
    if out.shape != params.shape:
        raise ValueError(f"{where}: shape {tuple(out.shape)}, the parameter "
                         f"is {tuple(params.shape)}")
    if dtype is not None and out.dtype != dtype:
        raise TypeError(f"{where}: dtype {out.dtype}, want {dtype}")
    return out


def train_state_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                         device: DeviceLike = None) -> dict:
    """A reference training state (``repro.train.trainer``'s dict, numpy
    leaves) -> the port's (``repro_torch.train.trainer``): ``params``
    through :func:`params_from_jax`, made trainable; ``opt``, the
    reference's ``AdamWState`` (or a mapping with ``step``, ``m``, ``v``),
    as ``optim.AdamWState`` with a host int step and m and v in their
    stored dtype; ``ef`` in fp32 where present; ``rng``, the reference's
    two uint32 key words, kept as they are (the port seeds its own draws
    from them)."""
    from repro_torch.optim import AdamWState

    params = params_from_jax(tree["params"], cfg, device)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt = tree["opt"]
    get = (lambda k: opt[k]) if isinstance(opt, Mapping) else (
        lambda k: getattr(opt, k))
    m = _like(get("m"), params, "opt.m")
    v = _like(get("v"), params, "opt.v")
    out = {"params": params,
           "opt": AdamWState(step=int(np.asarray(get("step"))), m=m, v=v),
           "rng": np.asarray(tree["rng"], np.uint32)}
    if "ef" in tree:
        out["ef"] = _like(tree["ef"], params, "ef", torch.float32)
    return out

