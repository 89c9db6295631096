"""int8 gradient compression with error feedback (port of
``repro.optim.compress``).

Each tensor is quantised to int8 with one scale, max|x| / 127 + 1e-12,
rounding half to even as ``jnp.round`` does; the residual of the
quantisation is kept (the error feedback) and added to the next step's
gradient.  The reference applies it around the cross-pod reduction; on one
card the trainer applies it to the step's gradient all the same, so a run
with it gives the reference's numbers.  Nothing is edited in place: the
gradients autograd returned and the feedback tree stay as they were.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .adamw import _map


def init_error_feedback(params: Any) -> Any:
    """A zero fp32 residual beside each parameter."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Any, error: Any) -> Tuple[Any, Any, Any]:
    """(grads + error) -> (int8 tree, scale tree, new error tree)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = _quantize(corrected)
        return q, s, corrected - _dequantize(q, s)
    both = _map(one, grads, error)
    return tuple(_map(lambda t, i=i: t[i], both) for i in range(3))


def decompress_grads(q: Any, scales: Any) -> Any:
    return _map(_dequantize, q, scales)
