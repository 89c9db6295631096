"""Convert a reference parameter tree into the port's parameters.

The tree is what ``repro.models.init_params`` returns, as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``): ``embed``, ``final_norm``
and, per pattern position ``pos{i}``, ``norm1``, ``norm2``, the mixer
(``attn.{wq, wk, wv, wo}`` with ``q_norm`` / ``k_norm`` under qk-norm, or
``mamba.{w_in, conv_w, conv_b, a_log, dt_bias, d_skip, norm, w_out}``),
for a SwiGLU MLP (``dense``, ``moe+dense``) ``mlp.{w_gate, w_up, w_down}``
and for a MoE (``moe``, ``moe+dense``) ``moe.{router, w_gate, w_up,
w_down}``, stacked over the repeats.  The layout is kept as it is.  Every
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
    layers = {}
    for i, (mixer, mlp_kind) in enumerate(cfg.pattern):
        layer: dict = {"norm1": dt, "norm2": dt}
        if mixer == ATTN:
            layer["attn"] = same(_ATTN + (("q_norm", "k_norm")
                                          if cfg.qk_norm else ()))
        else:
            layer["mamba"] = {k: torch.float32 if k in FP32_LEAVES else dt
                              for k in _MAMBA}
        if mlp_kind in (DENSE, MOE_DENSE):
            layer["mlp"] = same(_MLP)
        if mlp_kind in (MOE, MOE_DENSE):
            layer["moe"] = {k: torch.float32 if k == "router" else dt
                            for k in MOE_KEYS}
        layers[f"pos{i}"] = layer
    return {"embed": dt, "final_norm": dt, "layers": layers}


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
        if where.startswith("params.layers.") and (
                out.dim() == 0 or out.shape[0] != cfg.n_repeats):
            raise ValueError(f"{where}: tree holds {tuple(out.shape)[:1]} "
                             f"repeats, config wants {cfg.n_repeats}")
        return out

    return conv(tree, _dtypes(cfg), "params")
