"""Keras Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)`` with ``t``
counting this update."""

from __future__ import annotations

import math

import torch

from . import moment


class Optimizer:
    def __init__(self, opt: dict, params: dict, start: dict | None = None):
        self.opt = opt
        self.t = start["t"] if start else 0
        self.m = {k: moment(start, "m", k, p) for k, p in params.items()}
        self.v = {k: moment(start, "v", k, p) for k, p in params.items()}

    def seen(self, g: torch.Tensor) -> torch.Tensor:
        return g

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        o = self.opt
        b1, b2 = o["beta1"], o["beta2"]
        self.t += 1
        for k, p in params.items():
            g, m, v = grads[k], self.m[k], self.v[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)) + o["eps"]
            p.addcdiv_(m, denom, value=-o["lr"] / (1 - b1 ** self.t))


def gradient(opt: dict, m0: torch.Tensor, m1: torch.Tensor,
             t: int) -> torch.Tensor:
    return (m1 - opt["beta1"] * m0) / (1 - opt["beta1"])
