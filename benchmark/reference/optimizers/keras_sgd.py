"""Keras SGD: momentum ``momentum`` under ``ExponentialDecay(lr, 3 *
decay_tr_steps, 0.1)``, each gradient tensor first clipped to L2 norm
``clipnorm``; ``m = momentum m + lr_t g; p -= m``, ``t`` the updates taken
before this one."""

from __future__ import annotations

import torch

from . import moment


class Optimizer:
    def __init__(self, opt: dict, params: dict, start: dict | None = None):
        self.opt = opt
        self.t = start["t"] if start else 0
        self.m = {k: moment(start, "m", k, p) for k, p in params.items()}

    def lr(self, t: int) -> float:
        o = self.opt
        return o["lr"] * 0.1 ** (t / (3 * o["decay_tr_steps"]))

    def seen(self, g: torch.Tensor) -> torch.Tensor:
        clip = self.opt.get("clipnorm")
        if clip is None:
            return g
        return g * min(1.0, clip / max(float(g.norm()), 1e-12))

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        lr = self.lr(self.t)
        self.t += 1
        for k, p in params.items():
            m = self.m[k]
            m.mul_(self.opt["momentum"]).add_(self.seen(grads[k]), alpha=lr)
            p.sub_(m)


def gradient(opt: dict, m0: torch.Tensor, m1: torch.Tensor,
             t: int) -> torch.Tensor:
    return (m1 - opt["momentum"] * m0) / Optimizer(opt, {}).lr(t)
