"""Convert a reference parameter tree into the port's parameters.

The tree is what ``repro.models.init_params`` returns, as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``): ``embed``, ``final_norm``
and ``layers.pos0.{norm1, norm2, attn.{wq, wk, wv, wo}, mlp.{w_gate, w_up,
w_down}}`` stacked over the repeats.  The layout is kept as it is.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ModelConfig

_ATTN = {"wq", "wk", "wv", "wo"}
_MLP = {"w_gate", "w_up", "w_down"}


def _tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a type torch.from_numpy takes; the
        # round trip through float32 is exact both ways
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)      # a writable copy


def _check_keys(tree: Mapping[str, Any], want: set, where: str) -> None:
    got = set(tree)
    if got != want:
        raise KeyError(f"{where}: expected keys {sorted(want)}, got "
                       f"{sorted(got)}")


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> dict:
    """Reference parameter tree (numpy leaves) -> port params on ``device``."""
    cfg.check_supported()
    dev = resolve_device(device)
    _check_keys(tree, {"embed", "final_norm", "layers"}, "params")
    _check_keys(tree["layers"], {"pos0"}, "params.layers")
    layer = tree["layers"]["pos0"]
    _check_keys(layer, {"norm1", "norm2", "attn", "mlp"}, "layers.pos0")
    attn_keys = _ATTN | ({"q_norm", "k_norm"} if cfg.qk_norm else set())
    _check_keys(layer["attn"], attn_keys, "layers.pos0.attn")
    _check_keys(layer["mlp"], _MLP, "layers.pos0.mlp")

    def conv(t: Any) -> Any:
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        out = _tensor(t, dev)
        if out.dtype != cfg.dtype:
            raise TypeError(f"leaf dtype {out.dtype} != config dtype "
                            f"{cfg.dtype}")
        return out

    params = conv(tree)
    n = params["layers"]["pos0"]["norm1"].shape[0]
    if n != cfg.n_repeats:
        raise ValueError(f"tree holds {n} repeats, config wants "
                         f"{cfg.n_repeats}")
    return params
