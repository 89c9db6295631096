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
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ATTN, DENSE, MOE, MOE_DENSE, ModelConfig
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
