"""Losses of the reference's Keras compile settings (counterpart of
``sm_hpss_mtl_tpu/train/losses.py``).

``model.compile(loss={'S': 'binary_crossentropy', 'M':
'binary_crossentropy', 'R': 'mean_squared_error', '3C':
'categorical_crossentropy'}, loss_weights=...)``: the total is the
weighted sum of the per-head losses, each a batch mean.  BCE and CCE take
probabilities (the heads end in sigmoid and softmax), clipped at Keras's
1e-7.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def binary_crossentropy(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean BCE; ``p`` in (0, 1) of shape (B, 1) or (B,), ``y`` in {0, 1}."""
    p = p.squeeze(-1) if p.ndim > y.ndim else p
    p = p.clamp(_EPS, 1 - _EPS)
    y = y.to(p.dtype)
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p))


def categorical_crossentropy(p: torch.Tensor, y_onehot: torch.Tensor
                             ) -> torch.Tensor:
    """Mean CCE over one-hot labels; ``p`` is a softmax output (B, C)."""
    p = p.clamp(_EPS, 1.0)
    return -torch.mean(torch.sum(y_onehot * torch.log(p), dim=-1))


def mean_squared_error(pred: torch.Tensor, target: torch.Tensor
                       ) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def hinge(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Keras hinge on a sigmoid output, labels mapped to +-1:
    ``mean(max(0, 1 - y_pm * p))``."""
    p = p.squeeze(-1) if p.ndim > y.ndim else p
    y_pm = 2.0 * y.to(p.dtype) - 1.0
    return torch.mean(torch.clamp(1.0 - y_pm * p, min=0.0))


def mtl_loss(outputs: dict, labels: dict, loss_weights: dict | None = None,
             loss_types: dict | None = None
             ) -> tuple[torch.Tensor, dict]:
    """Weighted sum of per-head losses.  ``outputs`` and ``labels`` are keyed
    by head name (S, M, [N], R, 3C/NC); ``loss_types`` may set a binary
    head's loss to 'hinge'.  Returns (total, per-head dict)."""
    loss_types = loss_types or {}
    per_head = {}
    for key, out in outputs.items():
        y = labels[key]
        if key == "R":
            per_head[key] = mean_squared_error(out, y)
        elif key in ("3C", "NC"):
            per_head[key] = categorical_crossentropy(out, y)
        elif loss_types.get(key) == "hinge":
            per_head[key] = hinge(out, y)
        else:  # S, M, N binary heads
            per_head[key] = binary_crossentropy(out, y)
    weights = loss_weights or {}
    total = sum(weights.get(k, 1.0) * v for k, v in per_head.items())
    return total, per_head
