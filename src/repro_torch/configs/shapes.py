"""Assigned input shapes x applicability rules + meta-tensor factories
(port of ``repro.configs.shapes``).

Four shapes per architecture (40 cells):
  train_4k     seq_len=4096   global_batch=256   a training step
  prefill_32k  seq_len=32768  global_batch=32    prefill (serve)
  decode_32k   seq_len=32768  global_batch=128   decode_step (serve)
  long_500k    seq_len=524288 global_batch=1     decode_step (serve)

Rules: ``long_500k`` needs sub-quadratic attention — run only for
SSM/hybrid (mamba2-1.3b, jamba-v0.1-52b), skip for pure full-attention
archs.  No assigned arch is encoder-only, so decode shapes run everywhere
(whisper decodes with its decoder over stub encoder memory).

``input_specs`` returns tensors on the ``meta`` device (shape and dtype,
no storage) in place of the reference's ``jax.ShapeDtypeStruct``; given a
mesh, each carries its :class:`~repro_torch.parallel.sharding.
NamedSharding` as ``.sharding``, as a ShapeDtypeStruct does.  Where the
reference takes a shape's name, the port also takes a :class:`Shape`
(the dry-run's cells cut to one card, ``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import MAMBA, ModelConfig
from repro_torch.parallel.sharding import NamedSharding, logical_to_spec


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str                   # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def _is_subquadratic(cfg: ModelConfig) -> bool:
    return any(mixer == MAMBA for mixer, _ in cfg.pattern)


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    if shape_name == "long_500k" and not _is_subquadratic(cfg):
        return False, ("pure full-attention arch: 500k context needs "
                       "sub-quadratic attention (spec rule; DESIGN.md §5)")
    return True, ""


def _shape(shape: Union[str, Shape]) -> Shape:
    return shape if isinstance(shape, Shape) else SHAPES[shape]


def shape_kind(shape_name: Union[str, Shape]) -> str:
    return _shape(shape_name).kind


def _sds(shape, dtype, mesh: Optional[Any], axes: Tuple[str, ...]
         ) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device="meta")
    if mesh is not None:
        t.sharding = NamedSharding(mesh, logical_to_spec(axes, shape, mesh))
    return t


def batch_specs(cfg: ModelConfig, shape_name: Union[str, Shape],
                mesh: Optional[Any] = None) -> Dict[str, Any]:
    """Model-input meta tensors for the training/prefill batch."""
    sh = _shape(shape_name)
    B, S = sh.global_batch, sh.seq_len
    out: Dict[str, Any] = {}
    tok_len = S
    if cfg.frontend == "vision":
        tok_len = S - cfg.n_frontend_tokens
        out["patch_embeds"] = _sds((B, cfg.n_frontend_tokens, cfg.d_model),
                                   cfg.dtype, mesh, ("batch", "none", "none"))
    out["tokens"] = _sds((B, tok_len), torch.int32, mesh, ("batch", "none"))
    if cfg.is_encdec:
        out["encoder_embeds"] = _sds((B, cfg.encoder_len, cfg.d_model),
                                     cfg.dtype, mesh, ("batch", "none", "none"))
    return out


def decode_specs(cfg: ModelConfig, shape_name: Union[str, Shape],
                 mesh: Optional[Any] = None) -> Dict[str, Any]:
    """Inputs for one decode step: new tokens + cache + index (+ memory)."""
    sh = _shape(shape_name)
    B, L = sh.global_batch, sh.seq_len
    out: Dict[str, Any] = {
        "tokens": _sds((B, 1), torch.int32, mesh, ("batch", "none")),
        "index": _sds((), torch.int32, mesh, ()),
        "cache": cache_specs(cfg, B, L, mesh),
    }
    if cfg.is_encdec:
        out["memory"] = _sds((B, cfg.encoder_len, cfg.d_model), cfg.dtype,
                             mesh, ("batch", "none", "none"))
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                mesh: Optional[Any] = None) -> Any:
    """Meta tensors mirroring ``models.init_cache``, with decode-time
    shardings: KV length over 'seq' ('model' axis — flash-decoding SP),
    mamba state heads over 'model'."""
    cache: Dict[str, Any] = {}
    R = cfg.n_repeats
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer == "attn":
            kv = lambda: _sds((R, batch, max_len, cfg.n_kv, cfg.hd),
                              cfg.dtype, mesh,
                              ("none", "batch", "seq", "none", "none"))
            cache[f"pos{i}"] = {"attn": {"k": kv(), "v": kv()}}
        else:
            d_inner = 2 * cfg.d_model
            H = d_inner // cfg.ssm_head_dim
            cache[f"pos{i}"] = {"mamba": {
                "conv": _sds((R, batch, 3, d_inner + 2 * cfg.ssm_state),
                             cfg.dtype, mesh,
                             ("none", "batch", "none", "model")),
                "ssm": _sds((R, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                            torch.float32, mesh,
                            ("none", "batch", "model", "none", "none")),
            }}
    return cache


def input_specs(cfg: ModelConfig, shape_name: Union[str, Shape],
                mesh: Optional[Any] = None) -> Dict[str, Any]:
    """Unified entry: meta-tensor stand-ins for every model input of this
    (arch x shape) cell — training batch for 'train'/'prefill' kinds,
    token/cache/index set for 'decode' kinds."""
    kind = shape_kind(shape_name)
    if kind in ("train", "prefill"):
        out = dict(batch_specs(cfg, shape_name, mesh))
        if kind == "prefill":
            sh = _shape(shape_name)
            out["cache"] = cache_specs(cfg, sh.global_batch, sh.seq_len, mesh)
        return out
    return decode_specs(cfg, shape_name, mesh)


def make_batch(cfg: ModelConfig, shape_name: str, *, scale: float = 1.0,
               seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Concrete batch matching ``batch_specs``, drawn from a numpy seed as
    the reference draws it (tokens uniform below the vocab, embeddings
    normal at ``scale``), on ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    specs = batch_specs(cfg, shape_name, mesh=None)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in specs.items():
        if not s.dtype.is_floating_point:
            arr = rng.integers(0, cfg.vocab, s.shape)
        else:
            arr = rng.normal(0, scale, s.shape)
        out[k] = torch.as_tensor(arr).to(device=dev, dtype=s.dtype)
    return out
