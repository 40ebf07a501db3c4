"""Multi-trial training: N trials of one architecture advance together on a
shared batch stream (counterpart of ``sm_hpss_mtl_tpu/train/multitrial.py``).

The trials' parameters, BatchNorm statistics and optimizer state carry a
leading trial axis (``torch.func.stack_module_state``), and one step is
``torch.func.vmap`` over ``functional_call`` and ``grad`` of the model: each
convolution and product runs once for all trials, not once per trial.  A
trial's step is exactly its single-trial step
(:func:`..train.state.make_train_step`) on the same batch:

- ``loss_weights`` per trial (a dict of per-head scalars) and ``lr_scale``,
  which multiplies the optimizer's final update (every optimizer here is
  linear in the learning rate, so that is training at ``lr_scale * lr``).
- Keras's per-tensor clipnorm takes each trial's norm of each tensor, not
  the stack's (``optimizers.KerasSGD(trial_axis=True)``).
- BatchNorm updates each trial's running statistics in place, as the
  single step does (its ``lerp_`` runs on the stacked buffers).
- Dropout and the noise augmentation draw from one ``torch.Generator`` per
  trial, seeded with the trial's seed, in the order its single step draws
  them; ``vmap`` takes no generator, so the draws happen before the vmapped
  call and each dropout layer reads its trial's mask from a feed
  (``models.layers.Dropout.feed``).  The JAX package splits one key per
  trial and step instead, so the streams differ from its own.

Seed replicates are trials whose initial weights come from their own seed
(``models.lemaire.init_weights``).  ``fit_multi(mesh=...)`` shards the trial
axis over the mesh's ``data`` devices: each trains its ``T/D`` trials with
the vmapped step on its own copy of every batch, with no communication (the
trials are independent), as the JAX package's ``shard_map`` over the trial
axis.
"""

from __future__ import annotations

import copy
import functools
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad, stack_module_state, vmap

from ..models import layers
from ..models.lemaire import init_weights
from .losses import categorical_crossentropy, mtl_loss
from .loop import EARLY_STOP_MIN_DELTA, EARLY_STOP_PATIENCE
from .state import augment, l2_kernels

# BatchNorm's running-statistics ``lerp_`` has no batching rule in
# torch.func: vmap runs it per trial (exact, and small).
warnings.filterwarnings("ignore", message=".*batching rule for aten::lerp_",
                        category=UserWarning)


def stack_hyperparams(trials: list[dict], heads: tuple | None,
                      device: str | torch.device = "cpu") -> dict:
    """Per-trial hyperparameters as tensors with a leading trial axis:
    ``lr_scale`` (default 1) and, for MTL models, ``loss_weights`` per head
    of ``heads`` (a head a trial does not name weighs 1); also
    ``scaled``, whether any lr scale differs from 1 (a host flag, so that
    a step need not read the device to know)."""
    scales = [float(t.get("lr_scale", 1.0)) for t in trials]
    out = {"lr_scale": torch.tensor(scales, dtype=torch.float32,
                                    device=device),
           "scaled": any(s != 1.0 for s in scales)}
    if heads:
        out["loss_weights"] = {
            h: torch.tensor([float((t.get("loss_weights") or {}).get(h, 1.0))
                             for t in trials], dtype=torch.float32,
                            device=device)
            for h in heads}
    return out


@dataclass
class MultiState:
    """The trials' stacked parameters and buffers (trial axis first), the
    optimizer over the stacked parameters, one generator per trial, and
    the steps taken."""
    params: dict
    buffers: dict
    optimizer: torch.optim.Optimizer
    generators: list
    step: int = 0


def init_trials(model: nn.Module, seeds, make_optimizer: Callable,
                device: str | torch.device = "cpu") -> MultiState:
    """Stacked state of ``len(seeds)`` trials of ``model``'s architecture:
    trial i's weights are Keras's initialisation from ``seeds[i]`` (as
    ``cli.experiment.model_spec`` makes a run's), its generator is seeded
    with ``seeds[i]`` on ``device``.  ``make_optimizer(params)`` builds the
    optimizer over the stacked parameters (for Lemaire's SGD with
    ``trial_axis=True``)."""
    nets = []
    for s in seeds:
        net = _copy(model)
        init_weights(net, torch.Generator().manual_seed(int(s)))
        nets.append(net.to(device))
    return stacked_state(nets, make_optimizer, seeds, device)


def stacked_state(nets: list[nn.Module], make_optimizer: Callable, seeds,
                  device: str | torch.device = "cpu") -> MultiState:
    """:class:`MultiState` of the trials ``nets`` (one module each, the
    same architecture), generators seeded with ``seeds``."""
    params, buffers = stack_module_state([n.train() for n in nets])
    params = {k: v.detach().to(device).requires_grad_(True)
              for k, v in params.items()}
    buffers = {k: v.to(device) for k, v in buffers.items()}
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    return MultiState(params, buffers, make_optimizer(list(params.values())),
                      gens)


def unstack_trial(state: MultiState, i: int) -> dict:
    """Trial ``i``'s ``state_dict`` (parameters and buffers), on the CPU."""
    return {k: v[i].detach().cpu().clone()
            for k, v in {**state.params, **state.buffers}.items()}


def _copy(model: nn.Module) -> nn.Module:
    """A deep copy of ``model`` without its dropout generators."""
    drops = [m for m in model.modules() if isinstance(m, layers.Dropout)]
    gens = [m.generator for m in drops]
    for m in drops:
        m.generator = None
    try:
        return copy.deepcopy(model)
    finally:
        for m, g in zip(drops, gens):
            m.generator = g


def _template(model: nn.Module) -> nn.Module:
    """A weightless copy of ``model`` for ``functional_call``."""
    return _copy(model).to("meta")


class _MaskFeed:
    """Hands each dropout layer of a forward its mask, in call order;
    ``None`` for the shape probe."""

    def __init__(self, masks=None):
        self.masks = masks

    def pop(self):
        return None if self.masks is None else self.masks.pop(0)


def _dropout_shapes(template: nn.Module, batch) -> list:
    """(shape, keep) of each mask one trial's train-mode forward on
    ``batch`` draws, in call order, found on the meta device (each layer's
    ``mask``, which its forward calls and the TCN block's kernels call
    instead)."""
    shapes = []

    def probe(mod, x):
        mask = layers.Dropout.mask(mod, x)
        shapes.append((tuple(mask.shape), mod.keep))
        return mask

    drops = [m for m in template.modules()
             if isinstance(m, layers.Dropout) and m.rate > 0]
    meta = ({k: v.to("meta") for k, v in batch.items()}
            if isinstance(batch, dict) else batch.to("meta"))
    try:
        for m in drops:
            m.feed = _MaskFeed()
            m.mask = functools.partial(probe, m)
        template.train()
        with torch.no_grad():
            template(meta)
    finally:
        for m in drops:
            m.feed = None
            del m.mask
    return shapes


def make_multi_train_step(model: nn.Module, *, mtl: bool,
                          augment_noise: bool = False,
                          l2_reg: float = 0.0) -> Callable:
    """``(state, batch, labels, hyper) -> metrics``: one update of every
    trial of ``state`` on the shared ``batch`` (each metric a tensor of
    per-trial values), the counterpart of the JAX vmapped step.  The batch
    and labels are shared; parameters, buffers, generators and ``hyper``
    (:func:`stack_hyperparams`) carry the trial axis.  Trial i's update is
    its single-trial step's with its generator: the same augmentation and
    dropout draws, its loss weights, per-tensor clipnorm on its own
    gradients, and its ``lr_scale`` on the final update."""
    template = _template(model)
    drops = [m for m in template.modules()
             if isinstance(m, layers.Dropout) and m.rate > 0]
    ids = {id(p) for p in l2_kernels(model)} if l2_reg else set()
    l2_names = [n for n, p in model.named_parameters() if id(p) in ids]
    feed = _MaskFeed([])
    shapes_of = {}

    def loss_fn(params, buffers, batch, labels, weights, masks):
        feed.masks = list(masks)
        outputs = functional_call(template, (params, buffers), (batch,))
        if mtl:
            total, per_head = mtl_loss(outputs, labels, weights)
        else:
            total = categorical_crossentropy(outputs, labels)
            per_head = {"3C": total}
        if l2_names:
            total = total + l2_reg * sum(params[n].square().sum()
                                         for n in l2_names)
        out3 = outputs["3C"] if mtl else outputs
        lab3 = labels["3C"] if mtl else labels
        acc = (out3.argmax(-1) == lab3.argmax(-1)).float().mean()
        return total, (total, per_head, acc)

    vstep = vmap(grad(loss_fn, has_aux=True),
                 in_dims=(0, 0, None, None, 0, 0), randomness="error")
    vstep_aug = vmap(grad(loss_fn, has_aux=True),
                     in_dims=(0, 0, 0, None, 0, 0), randomness="error")

    def _draw(state, batch):
        """Per trial, in its single step's order: the augmentation, then
        each dropout mask."""
        first = next(iter(batch.values())) if isinstance(batch, dict) \
            else batch
        key = (tuple(first.shape), first.device)
        if key not in shapes_of:
            shapes_of[key] = _dropout_shapes(template, batch)
        batches, masks = [], [[] for _ in shapes_of[key]]
        for g in state.generators:
            if augment_noise:
                batches.append(augment(batch, g))
            for k, (shape, keep) in enumerate(shapes_of[key]):
                masks[k].append(torch.empty(
                    shape, device=first.device, dtype=first.dtype
                ).bernoulli_(keep, generator=g))
        if augment_noise:
            batch = ({k: torch.stack([b[k] for b in batches])
                      for k in batches[0]} if isinstance(batch, dict)
                     else torch.stack(batches))
        return batch, tuple(torch.stack(m) for m in masks)

    def train_step(state: MultiState, batch, labels, hyper: dict) -> dict:
        batch, masks = _draw(state, batch)
        for m in drops:
            m.feed = feed
        template.train()
        try:
            fn = vstep_aug if augment_noise else vstep
            grads, (total, per_head, acc) = fn(
                state.params, state.buffers, batch, labels,
                hyper.get("loss_weights", {}), masks)
        finally:
            for m in drops:
                m.feed = None
        scale, scaled = hyper["lr_scale"], hyper["scaled"]
        if scaled:
            before = {k: p.detach().clone() for k, p in state.params.items()}
        for k, p in state.params.items():
            p.grad = grads[k]
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if scaled:
            with torch.no_grad():
                for k, p in state.params.items():
                    s = scale.view(-1, *([1] * (p.ndim - 1)))
                    p.copy_(before[k] + s * (p - before[k]))
        state.step += 1
        metrics = {"loss": total.detach(),
                   **{f"{k}_loss": v.detach() for k, v in per_head.items()}}
        metrics["3C_accuracy" if mtl else "accuracy"] = acc
        return metrics

    return train_step


def make_multi_eval_step(model: nn.Module, *, mtl: bool) -> Callable:
    """``(state, batch, labels, hyper) -> metrics`` in eval mode, per trial
    (keys ``loss``, ``accuracy`` and, for MTL models, ``<head>_loss``)."""
    template = _template(model)

    def one(params, buffers, batch, labels, weights):
        outputs = functional_call(template, (params, buffers), (batch,))
        out3 = outputs["3C"] if mtl else outputs
        lab3 = labels["3C"] if mtl else labels
        acc = (out3.argmax(-1) == lab3.argmax(-1)).float().mean()
        if mtl:
            total, per_head = mtl_loss(outputs, labels, weights)
            return {"loss": total, "accuracy": acc,
                    **{f"{k}_loss": v for k, v in per_head.items()}}
        return {"loss": categorical_crossentropy(outputs, labels),
                "accuracy": acc}

    veval = vmap(one, in_dims=(0, 0, None, None, 0))

    @torch.no_grad()
    def eval_step(state: MultiState, batch, labels, hyper: dict) -> dict:
        template.eval()
        return veval(state.params, state.buffers, batch, labels,
                     hyper.get("loss_weights", {}))

    return eval_step


@dataclass
class MultiFitResult:
    state: MultiState  # stacked; trial i via unstack_trial
    n_trials: int
    #: With ``mesh=``: each data device's own state (its slice of the
    #: trials, their optimizer and generators), in trial order; ``state``
    #: then holds every trial's parameters and buffers on the first device
    #: and no optimizer.
    shards: list = field(default_factory=list)
    best_val_loss: np.ndarray = None  # (n,)
    best_epoch: np.ndarray = None  # (n,)
    best_accuracy: np.ndarray = None  # (n,) val accuracy at the best epoch
    history: list = field(default_factory=list)  # per-epoch dict of (n,)
    training_time: float = 0.0


def _trial_groups(n: int, mesh, device) -> list:
    """``(device, trial indices)`` per data device of ``mesh`` (all trials
    on ``device`` without one)."""
    if mesh is None:
        return [(torch.device(device), list(range(n)))]
    n_data = mesh.shape["data"]
    if n % n_data:
        raise ValueError(f"{n} trials do not shard over {n_data} devices; "
                         "pad the trial list")
    k = n // n_data
    return [(dev, list(range(g * k, (g + 1) * k)))
            for g, dev in enumerate(mesh.along("data"))]


def _merged(states: list) -> MultiState:
    """Every trial's parameters and buffers of ``states`` (the shards of
    one run) stacked on the first one's device."""
    dev = next(iter(states[0].params.values())).device

    def cat(key, part):
        return torch.cat([getattr(st, part)[key].detach().to(dev)
                          for st in states])

    return MultiState({k: cat(k, "params") for k in states[0].params},
                      {k: cat(k, "buffers") for k in states[0].buffers},
                      None, [g for st in states for g in st.generators],
                      states[0].step)


def fit_multi(model: nn.Module, make_optimizer: Callable, train_iter,
              val_iter, *, mtl: bool, trials: list[dict], heads: tuple | None,
              epochs: int, steps_per_epoch: int, val_steps: int,
              augment_noise: bool = False, l2_reg: float = 0.0,
              base_seed: int = 0, patience: int = EARLY_STOP_PATIENCE,
              min_delta: float = EARLY_STOP_MIN_DELTA, mesh=None,
              device: str | torch.device = "cpu",
              verbose: bool = True) -> MultiFitResult:
    """Train all ``trials`` at once on a shared batch stream.

    Trial i starts from Keras's initialisation of ``model``'s architecture
    from its ``seed`` (default ``base_seed``) and draws from a generator of
    that seed.  Early stopping is joint: training stops once EVERY trial
    has gone ``patience`` epochs without a ``min_delta`` val-loss
    improvement; each trial's best epoch is its own, and its weights at
    that epoch are restored at the end.

    ``mesh`` (``parallel.make_mesh``; ``device`` is then unused): shard the
    trial axis over the mesh's 'data' devices, ``len(trials)`` evenly; each
    trains its trials on its own copy of every batch, no communication.
    A device may repeat."""
    n = len(trials)
    groups = _trial_groups(n, mesh, device)
    seeds = [int(t.get("seed", base_seed)) for t in trials]
    states = [init_trials(model, [seeds[i] for i in idx], make_optimizer,
                          dev) for dev, idx in groups]
    hypers = [stack_hyperparams([trials[i] for i in idx], heads, dev)
              for dev, idx in groups]
    where = [(g, j) for g, (_, idx) in enumerate(groups)
             for j in range(len(idx))]
    train_step = make_multi_train_step(model, mtl=mtl,
                                       augment_noise=augment_noise,
                                       l2_reg=l2_reg)
    eval_step = make_multi_eval_step(model, mtl=mtl)
    result = MultiFitResult(state=states[0], n_trials=n,
                            best_val_loss=np.full(n, np.inf),
                            best_epoch=np.full(n, -1),
                            best_accuracy=np.full(n, np.nan))
    best = [None] * n
    wait = np.zeros(n, int)
    t0 = time.process_time()

    def each(batch, labels, step):
        """``step`` on every shard with its copy of the batch."""
        return [step(st, _to(batch, dev), _to(labels, dev), hy)
                for st, hy, (dev, _) in zip(states, hypers, groups)]

    for epoch in range(epochs):
        tr_loss = []
        for _ in range(steps_per_epoch):
            batch, labels = next(train_iter)
            tr_loss.append([r["loss"] for r in each(batch, labels,
                                                    train_step)])
        va = [each(*next(val_iter), eval_step) for _ in range(val_steps)]
        # One device-to-host copy per shard and epoch.
        fetched = np.concatenate([torch.stack(
            [torch.stack([t[g] for t in tr_loss]).mean(0),
             torch.stack([r[g]["loss"] for r in va]).mean(0),
             torch.stack([r[g]["accuracy"] for r in va]).mean(0)]
        ).cpu().numpy() for g in range(len(groups))], axis=1)
        tr_mean, val_loss, val_acc = (fetched[0].astype(np.float64),
                                      fetched[1].astype(np.float64),
                                      fetched[2].astype(np.float64))
        result.history.append({"epoch": epoch, "loss": tr_mean,
                               "val_loss": val_loss,
                               "val_accuracy": val_acc})
        if verbose:
            print(f"epoch {epoch}: val_loss="
                  f"{np.array2string(val_loss, precision=4)}", flush=True)
        improved = val_loss < result.best_val_loss - min_delta
        for i in np.flatnonzero(improved):
            g, j = where[i]
            best[i] = unstack_trial(states[g], j)
        result.best_val_loss = np.where(improved, val_loss,
                                        result.best_val_loss)
        result.best_epoch = np.where(improved, epoch, result.best_epoch)
        result.best_accuracy = np.where(improved, val_acc,
                                        result.best_accuracy)
        wait = np.where(improved, 0, wait + 1)
        if (wait >= patience).all():
            if verbose:
                print(f"all trials early-stopped at epoch {epoch}",
                      flush=True)
            break

    result.training_time = time.process_time() - t0
    # Restore each trial's best weights into the stacked state.
    with torch.no_grad():
        for i, sd in enumerate(best):
            if sd is None:
                continue
            g, j = where[i]
            for k, v in {**states[g].params, **states[g].buffers}.items():
                v[j].copy_(sd[k])
    if mesh is not None:
        result.shards = states
        result.state = _merged(states)
    return result


def _to(tree, device: torch.device):
    """A batch or label tree (tensors, dicts of them) on ``device``; the
    same tensors where they are there already."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, non_blocking=True)
