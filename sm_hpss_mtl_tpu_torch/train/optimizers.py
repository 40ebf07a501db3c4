"""Optimizers of the reference's per-model compile settings (counterpart
of ``sm_hpss_mtl_tpu/train/optimizers.py``).

======================  ====================================================
Model                   Reference setting
======================  ====================================================
Lemaire*                SGD momentum 0.9, clipnorm=1, ExponentialDecay
                        (0.002, 3*TR_STEPS, 0.1): :class:`KerasSGD`
Doukhan*                Adam 1e-4 (Keras eps 1e-7): ``torch.optim.Adam``
Papakostas*             SGD, ExponentialDecay(0.001, 700, 0.1):
                        ``torch.optim.SGD`` with the decay as a ``LambdaLR``
Jang*                   Adam 1e-3 (eps 1e-7): ``torch.optim.Adam``
======================  ====================================================

Keras ``clipnorm`` clips each gradient *tensor* to L2 norm 1 before the
momentum update (:func:`clip_by_per_tensor_norm`), not the global norm of
``torch.nn.utils.clip_grad_norm_``.  Keras's momentum SGD scales the
gradient by the lr *before* it enters the velocity, which
``torch.optim.SGD`` does not (it scales the velocity), and the two part
under a decaying lr.  Schedules count from 0 at the first update, as
optax's ``scale_by_learning_rate`` does.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def clip_by_per_tensor_norm(grads: list[torch.Tensor], max_norm: float,
                            trial_axis: bool = False) -> None:
    """Scale each gradient tensor in place to at most ``max_norm`` L2 norm
    (norms floored at 1e-12).  With ``trial_axis`` each tensor stacks one
    gradient per trial along its first axis (``train.multitrial``), and
    each trial's slice is clipped by its own norm."""
    if not grads:
        return
    if trial_axis:
        for g in grads:
            norms = torch.linalg.vector_norm(g.flatten(1), dim=1)
            scales = (max_norm / norms.clamp_min(1e-12)).clamp_max(1.0)
            g.mul_(scales.view(-1, *([1] * (g.ndim - 1))))
        return
    norms = torch.stack(torch._foreach_norm(grads))
    scales = (max_norm / norms.clamp_min(1e-12)).clamp_max(1.0)
    torch._foreach_mul_(grads, list(scales.unbind()))


def exponential_decay(init_value: float, decay_steps: int,
                      decay_rate: float = 0.1) -> Callable:
    """Keras ``ExponentialDecay(staircase=False)``:
    ``lr(t) = init * rate ** (t / decay_steps)``, of an int ``t`` or of a
    float64 tensor (:class:`KerasSGD`'s device-side count)."""
    return lambda t: init_value * decay_rate ** (t / decay_steps)


class KerasSGD(torch.optim.Optimizer):
    """Keras momentum SGD under a schedule: per parameter, optionally
    ``g`` clipped to ``clipnorm`` (:func:`clip_by_per_tensor_norm`), then
    ``v <- m*v + lr_t*g; p <- p - v``, with ``t`` the updates taken before
    this one.  State per parameter: ``momentum_buffer`` and ``step``.
    ``trial_axis``: the parameters stack one trial each along their first
    axis, and clipnorm takes each trial's norm.

    The step count and the schedule stay on the parameters' device, so an
    update reads nothing from the host and a CUDA graph of it replays
    right (``train.state.make_train_step``): every parameter's ``step`` is
    one float64 0-d tensor of its group, and ``schedule`` maps it to the
    learning rate in float64 with tensor arithmetic (as
    :func:`exponential_decay`'s does), cast once to the parameters' type.
    A ``step`` loaded as an int or a host tensor (older checkpoints) moves
    there at the next update."""

    #: The whole schedule lives on the device (``train.state`` graphs the
    #: steps of such optimizers only).
    schedule_on_device = True

    def __init__(self, params: Iterable, schedule: Callable,
                 momentum: float = 0.9, clipnorm: float | None = None,
                 trial_axis: bool = False):
        super().__init__(params, dict(momentum=momentum, clipnorm=clipnorm))
        self.schedule = schedule
        self.trial_axis = trial_axis

    def _step_of(self, params: list) -> torch.Tensor:
        """The group's step count, one float64 0-d tensor on the group's
        device that every parameter's state holds; a parameter new to the
        optimizer gets a zero momentum buffer."""
        first = params[0]
        t = self.state[first].get("step", 0)
        if not (torch.is_tensor(t) and t.dtype == torch.float64
                and t.device == first.device):
            t = torch.as_tensor(t, dtype=torch.float64,
                                device=first.device).reshape(())
        for p in params:
            state = self.state[p]
            if "momentum_buffer" not in state:
                state["momentum_buffer"] = torch.zeros_like(p)
            if state.get("step") is not t:
                state["step"] = t
        return t

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["clipnorm"] is not None:
                clip_by_per_tensor_norm(grads, group["clipnorm"],
                                        self.trial_axis)
            t = self._step_of(params)
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            lr = torch.as_tensor(self.schedule(t), dtype=torch.float64,
                                 device=t.device).to(params[0].dtype)
            torch._foreach_mul_(bufs, group["momentum"])
            # v + lr*g rounded once, as add_(g, alpha=lr) rounds it.
            torch._foreach_addcmul_(bufs, grads, [lr] * len(bufs))
            torch._foreach_sub_(params, bufs)
            t.add_(1)
        return loss


def lemaire_optimizer(params: Iterable, tr_steps: int,
                      init_lr: float = 0.002, trial_axis: bool = False):
    sched = exponential_decay(init_lr, 3 * tr_steps)
    return KerasSGD(params, sched, momentum=0.9, clipnorm=1.0,
                    trial_axis=trial_axis), sched


def papakostas_optimizer(params: Iterable, init_lr: float = 0.001):
    sched = exponential_decay(1.0, 700)
    opt = torch.optim.SGD(params, lr=init_lr)
    decay = torch.optim.lr_scheduler.LambdaLR(opt, sched)
    opt.register_step_post_hook(lambda *_: decay.step())
    return opt, lambda t: init_lr * sched(t)


def adam_optimizer(params: Iterable, lr: float):
    # Keras Adam's eps is 1e-7 (torch's default is 1e-8).
    return torch.optim.Adam(params, lr=lr, eps=1e-7), lambda t: lr


def for_model(name: str, params: Iterable, tr_steps: int,
              trial_axis: bool = False):
    """Optimizer over ``params`` and its lr schedule for a registry model
    name.  ``trial_axis``: the parameters are a multi-trial stack
    (``train.multitrial``); only the clipnorm of Lemaire's SGD reads it,
    the other optimizers being elementwise."""
    if name.startswith("Lemaire"):
        return lemaire_optimizer(params, tr_steps, trial_axis=trial_axis)
    if name.startswith("Doukhan"):
        return adam_optimizer(params, 1e-4)
    if name.startswith("Papakostas"):
        return papakostas_optimizer(params)
    if name.startswith("Jang"):
        return adam_optimizer(params, 1e-3)
    raise ValueError(f"unknown model {name!r}")
