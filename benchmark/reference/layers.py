"""Layers the reference's model families share, as plain functions of a
weight dict keyed as the program's ``state_dict`` names them (the format
both sides load): the dropout draws, Keras BatchNorm (eps 1e-3; in
training it normalises by the batch mean and biased variance), dense
layers and the S/M/R/3C heads (Dense 16, BatchNorm, ReLU, Dropout 0.4,
then sigmoid / linear / softmax outputs).

Training draws every random number from one ``torch.Generator`` through
:class:`Draws`, in the order the layers run: a dropout mask per dropout
layer, drawn with ``Tensor.bernoulli_`` over the activations' shape
(SpatialDropout1D over ``(B, C, 1)``).
"""

from __future__ import annotations

import torch


BN_EPS = 1e-3


class Draws:
    """Dropout masks from ``generator``; ``None`` is eval mode."""

    def __init__(self, generator: torch.Generator | None):
        self.generator = generator

    def dropout(self, x: torch.Tensor, rate: float, spatial: bool = False
                ) -> torch.Tensor:
        if self.generator is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        shape = x.shape[:-1] + (1,) if spatial else x.shape
        mask = torch.empty(shape, device=x.device, dtype=x.dtype).bernoulli_(
            keep, generator=self.generator)
        return x * mask / keep


def batch_norm(x: torch.Tensor, W: dict, name: str, train: bool
               ) -> torch.Tensor:
    """Keras BatchNorm over the channel axis 1."""
    dims = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    if train:
        var, mean = torch.var_mean(x, dim=dims, correction=0)
    else:
        mean, var = W[name + ".running_mean"], W[name + ".running_var"]
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
            * W[name + ".weight"].view(shape) + W[name + ".bias"].view(shape))


def dense(x: torch.Tensor, W: dict, name: str) -> torch.Tensor:
    return x @ W[name + ".weight"].t() + W[name + ".bias"]


def mtl_heads(x: torch.Tensor, W: dict, draws: Draws, train: bool
              ) -> dict[str, torch.Tensor]:
    """The S, M and R heads (Dense 16 - BN - ReLU - Dropout 0.4 - output)
    and the 3C softmax over the trunk vector."""
    out = {}
    for head in ("S", "M", "R"):
        y = dense(x, W, f"heads.{head}_block.dense")
        y = torch.relu(batch_norm(y, W, f"heads.{head}_block.bn", train))
        y = dense(draws.dropout(y, 0.4), W, f"heads.{head}_out")
        out[head] = y if head == "R" else torch.sigmoid(y)
    out["3C"] = torch.softmax(dense(x, W, "heads.C_out"), dim=-1)
    return out
