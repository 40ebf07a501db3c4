"""Train state and the train, eval and predict steps (counterpart of
``sm_hpss_mtl_tpu/train/state.py``).

A train step is forward, loss, backward, the optimizer update and the
BatchNorm running-statistics update, on the batch's device.  Randomness
(dropout, the noise augmentation) draws from one explicit
``torch.Generator`` on that device.  Metrics stay on the device as 0-d
tensors: the caller decides when to fetch them (``train.loop`` does so
once per epoch).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..models.layers import use_generator
from ..utils.profiling import request, span
from .losses import categorical_crossentropy, mtl_loss


@dataclass
class TrainState:
    """The module (parameters and BatchNorm statistics), its optimizer,
    and the number of train steps taken."""
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


#: Gaussian augmentation scales (the reference's noise augmentation).
NOISE_SCALES = (5e-3, 1e-3, 5e-4, 1e-4)


@functools.lru_cache(maxsize=8)
def _scales_on(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(NOISE_SCALES, device=device, dtype=dtype)


def _first(batch) -> torch.Tensor:
    """A batch's tensor, or the first input of a dict batch."""
    return next(iter(batch.values())) if isinstance(batch, dict) else batch


def augment(batch, generator: torch.Generator):
    """The reference's noise augmentation on the device: one scale drawn
    from :data:`NOISE_SCALES` per step, then Gaussian noise over the whole
    batch, both from ``generator`` (no host round trip).  A dict batch (the
    intermediate-fusion model's two inputs) takes the one scale and its
    own noise per input, in sorted key order, as the JAX ``_augment``."""
    first = _first(batch)
    scales = _scales_on(first.device, first.dtype)
    i = torch.randint(len(NOISE_SCALES), (), generator=generator,
                      device=first.device)

    def leaf(x):
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return x + scales[i] * noise

    if isinstance(batch, dict):
        return {k: leaf(v) for k, v in sorted(batch.items())}
    return leaf(batch)


def l2_kernels(model: nn.Module) -> list[torch.Tensor]:
    """The parameters the JAX step regularizes: flax ``kernel`` leaves
    whose path holds ``heads`` or ``melCl``.  A flax kernel is a dense or
    convolution weight, or a parameter named ``kernel`` (Jang's mel-scale
    layers); a BatchNorm's ``weight`` is flax's ``scale``, no kernel."""
    out = []
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path))
        is_kernel = leaf == "kernel" or (
            leaf == "weight"
            and not isinstance(mod, nn.modules.batchnorm._BatchNorm))
        if is_kernel and any("heads" in q or "melCl" in q for q in path):
            out.append(p)
    return out


def _accuracy(out: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return (out.argmax(-1) == onehot.argmax(-1)).float().mean()


def _losses(outputs, labels, mtl: bool, loss_weights: dict | None):
    if mtl:
        return mtl_loss(outputs, labels, loss_weights)
    total = categorical_crossentropy(outputs, labels)
    return total, {"3C": total}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                    mtl: bool, generator: torch.Generator,
                    loss_weights: dict | None = None, l2_reg: float = 0.0,
                    augment_noise: bool = False,
                    featurize: Callable | None = None,
                    before_update: Callable | None = None) -> Callable:
    """``(state, batch, labels) -> metrics``: one optimizer update of
    ``model`` in place; ``state.step`` counts it.

    ``l2_reg`` adds ``l2 * sum(kernel^2)`` over :func:`l2_kernels`, as the
    reference's Keras ``kernel_regularizer=l2()``.  ``augment_noise``
    applies :func:`augment`.  Dropout and augmentation draw from
    ``generator``.  ``featurize`` maps ``(batch, labels)`` to the model's
    input and per-row labels first, outside autograd (the device pipeline,
    ``train.endtoend``).  ``before_update()`` runs between the backward
    pass and the optimizer's update (``parallel.dp`` averages the
    gradients over its process group there).  Each call is one
    ``utils.profiling.request`` of four spans: ``train.featurize`` (the
    featurizer and the augmentation; ``n`` clips), ``train.forward`` (the
    forward pass, the losses and the L2 term; ``n`` rows),
    ``train.backward`` and ``train.optimizer``."""
    use_generator(model, generator)
    kernels = l2_kernels(model) if l2_reg else []

    def train_step(state: TrainState, batch, labels) -> dict:
        with request():
            with span("train.featurize", n=len(_first(batch))):
                if featurize is not None:
                    with torch.no_grad():
                        batch, labels = featurize(batch, labels)
                if augment_noise:
                    batch = augment(batch, generator)
            with span("train.forward", n=len(_first(batch))):
                model.train()
                outputs = model(batch)
                total, per_head = _losses(outputs, labels, mtl, loss_weights)
                if kernels:
                    total = total + l2_reg * sum(k.square().sum()
                                                 for k in kernels)
            with span("train.backward"):
                optimizer.zero_grad(set_to_none=True)
                total.backward()
            if before_update is not None:
                before_update()
            with span("train.optimizer"):
                optimizer.step()
            state.step += 1
        metrics = {"loss": total.detach(),
                   **{f"{k}_loss": v.detach() for k, v in per_head.items()}}
        out3 = outputs["3C"] if mtl else outputs
        lab3 = labels["3C"] if mtl else labels
        metrics["3C_accuracy" if mtl else "accuracy"] = _accuracy(
            out3.detach(), lab3)
        return metrics

    return train_step


def make_eval_step(model: nn.Module, *, mtl: bool,
                   loss_weights: dict | None = None,
                   featurize: Callable | None = None) -> Callable:
    """``(state, batch, labels) -> metrics`` in eval mode (keys: ``loss``,
    ``accuracy`` and, for MTL models, ``<head>_loss``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, labels) -> dict:
        if featurize is not None:
            batch, labels = featurize(batch, labels)
        model.eval()
        outputs = model(batch)
        total, per_head = _losses(outputs, labels, mtl, loss_weights)
        out3 = outputs["3C"] if mtl else outputs
        lab3 = labels["3C"] if mtl else labels
        metrics = {"loss": total, "accuracy": _accuracy(out3, lab3)}
        if mtl:
            metrics.update({f"{k}_loss": v for k, v in per_head.items()})
        return metrics

    return eval_step


def make_predict(model: nn.Module) -> Callable:
    """``(state, batch) -> outputs`` in eval mode."""

    @torch.no_grad()
    def predict(state: TrainState, batch):
        model.eval()
        return model(batch)

    return predict
