"""Multi-layer perceptron performance regressor, in PyTorch (paper §5).

The port of ``repro.core.mlp``: ReLU hidden layers, a linear output head,
MSE loss, and minibatch Adam with the reference's own update (its ``lr``
default, ``b1``/``b2``/``eps`` and bias correction), cosine learning-rate
decay over epochs and the minibatch permutation drawn from
``np.random.default_rng(seed)``.  Weights are kept as the reference keeps
them — ``w`` (fan_in, fan_out), ``b`` (fan_out,), ``a @ w + b`` — and
:meth:`MLP.to_bytes` / :meth:`MLP.from_bytes` use the reference's npz
layout, so a regressor trained by either package loads in the other.

The regressor is a few thousand parameters: it trains and predicts on the
CPU in float32, with plain ``torch.matmul`` (as the reference leaves its
matmuls to XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import io
import json
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# the reference's Adam hyper-parameters (``repro.core.mlp._adam_update``)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class MLP(nn.Module):
    """Dense ReLU stack with a linear scalar head, plus its training loop."""

    def __init__(self, sizes: Sequence[int],
                 params: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]]
                 = None, *, seed: int = 0):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        gen = torch.Generator()
        gen.manual_seed(seed)
        ws, bs = [], []
        for li, (fan_in, fan_out) in enumerate(zip(self.sizes[:-1],
                                                   self.sizes[1:])):
            if params is not None:
                w = torch.as_tensor(np.asarray(params[li][0], np.float32))
                b = torch.as_tensor(np.asarray(params[li][1], np.float32))
            else:           # He initialisation, as the reference's init_mlp
                w = torch.randn((fan_in, fan_out), generator=gen) \
                    * math.sqrt(2.0 / fan_in)
                b = torch.zeros((fan_out,))
            ws.append(nn.Parameter(w.clone()))
            bs.append(nn.Parameter(b.clone()))
        self.ws = nn.ParameterList(ws)
        self.bs = nn.ParameterList(bs)

    @classmethod
    def create(cls, seed: int, in_dim: int,
               hidden: Sequence[int] = (64, 128, 64)) -> "MLP":
        return cls((in_dim, *hidden, 1), seed=seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Algorithm 1 of the paper: a_n = f_n(W_n a_{n-1}), linear last."""
        a = x
        for w, b in zip(list(self.ws)[:-1], list(self.bs)[:-1]):
            a = torch.relu(torch.matmul(a, w) + b)
        return (torch.matmul(a, self.ws[-1]) + self.bs[-1])[..., 0]

    def fit(self, X: np.ndarray, y: np.ndarray, *, epochs: int = 60,
            batch_size: int = 512, lr: float = 1e-3, seed: int = 0,
            X_val: Optional[np.ndarray] = None,
            y_val: Optional[np.ndarray] = None,
            verbose: bool = False) -> List[float]:
        """Minibatch Adam on MSE; returns per-epoch validation (or train)
        MSE."""
        X_t = torch.as_tensor(np.asarray(X, np.float32))
        y_t = torch.as_tensor(np.asarray(y, np.float32))
        n = X_t.shape[0]
        params = list(self.parameters())
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        step = 0
        rng = np.random.default_rng(seed)
        history: List[float] = []
        n_batches = max(1, n // batch_size)
        for epoch in range(epochs):
            perm = rng.permutation(n)
            # cosine decay stabilizes the tail of training
            cur_lr = lr * 0.5 * (1 + math.cos(math.pi * epoch / max(1, epochs)))
            step_lr = max(cur_lr, 1e-5)
            for b in range(n_batches):
                idx = torch.as_tensor(perm[b * batch_size:(b + 1) * batch_size])
                loss = torch.mean((self(X_t[idx]) - y_t[idx]) ** 2)
                grads = torch.autograd.grad(loss, params)
                step += 1
                bc1 = 1 - ADAM_B1 ** step
                bc2 = 1 - ADAM_B2 ** step
                with torch.no_grad():
                    for p, g, mm, vv in zip(params, grads, m, v):
                        mm.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                        vv.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
                        p.sub_(step_lr * (mm / bc1)
                               / (torch.sqrt(vv / bc2) + ADAM_EPS))
            if X_val is not None:
                val = self.mse(X_val, y_val)
            else:
                val = self.mse(X, y)
            history.append(val)
            if verbose and (epoch % 10 == 0 or epoch == epochs - 1):
                print(f"  epoch {epoch:3d}  mse {val:.4f}")
        return history

    @torch.no_grad()
    def predict(self, X: np.ndarray, batch: int = 65536) -> np.ndarray:
        """Batched inference for the §6 exhaustive search: every legal
        config of one input scored in one rectangular matmul chain."""
        X = np.asarray(X, np.float32)
        outs = [self(torch.as_tensor(X[i:i + batch])).numpy()
                for i in range(0, X.shape[0], batch)]
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def mse(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean((self.predict(X) - np.asarray(y)) ** 2))

    # -- persistence (the reference's npz layout) ------------------------------
    def to_bytes(self) -> bytes:
        meta = json.dumps({"sizes": list(self.sizes)}).encode()
        arrs = {}
        for li, (w, b) in enumerate(zip(self.ws, self.bs)):
            # the reference flattens each layer's dict by sorted key: b, w
            arrs[f"a{2 * li}"] = b.detach().numpy()
            arrs[f"a{2 * li + 1}"] = w.detach().numpy()
        bio = io.BytesIO()
        np.savez(bio, meta=np.frombuffer(meta, dtype=np.uint8), **arrs)
        return bio.getvalue()

    @classmethod
    def from_bytes(cls, payload: bytes) -> "MLP":
        with np.load(io.BytesIO(payload)) as z:
            sizes = tuple(json.loads(bytes(z["meta"]).decode())["sizes"])
            params = [(z[f"a{2 * li + 1}"], z[f"a{2 * li}"])
                      for li in range(len(sizes) - 1)]
        return cls(sizes, params)


# The architecture sweep of Table 2 (hidden layer sizes).
TABLE2_ARCHS: Tuple[Tuple[int, ...], ...] = (
    (64,),
    (512,),
    (32, 64, 32),
    (64, 128, 64),
    (32, 64, 128, 64, 32),
    (64, 128, 256, 128, 64),
    (64, 128, 192, 256, 192, 128, 64),
)
