"""Data-parallel training over ``torch.distributed`` (counterpart of
the JAX package's ``parallel/dp.py``).

One process per GPU, each with the whole model and its own rows of the
global batch.  The JAX package compiles its train step with the batch
sharded over the mesh and lets GSPMD insert the reductions; here the
port's own step (``train.state.make_train_step``) runs in every process
and three things make it the single-device step on the global batch:

- the parameters and buffers start equal (broadcast from rank 0);
- the gradients are averaged over the group before the optimizer update
  (one ``all_reduce`` of all of them, flattened), which with equal shards
  is the gradient of the global batch mean;
- BatchNorm normalises with the global batch's statistics and moves its
  running ones by them (``models.layers.use_process_group``), as GSPMD
  reduces flax's BatchNorm over the global batch.

Shards must be of equal size, as JAX requires the batch to divide over the
mesh; every step checks it (one small reduction, read on the host).
Dropout and the noise augmentation draw from each process's own generator
(seed it with ``per_process_seed``).  The device pipeline's ``featurize=``
runs in each process on its own crops: K1 inside the step, each rank on
its share of the clips.  NCCL on CUDA, gloo on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models.layers import use_process_group
from ..train.state import make_train_step


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(tree, rank: int | None = None, world: int | None = None):
    """Rank ``rank``'s rows of every leaf of a batch tree (dicts, lists,
    tuples of tensors): the ``rank``-th of ``world`` equal slices of the
    leading axis.  Defaults to this process's rank and world size."""
    rank = dist.get_rank() if rank is None else rank
    world = dist.get_world_size() if world is None else world

    def take(x):
        if x.shape[0] % world:
            raise ValueError(f"a batch of {x.shape[0]} rows does not shard "
                             f"over {world} processes")
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]

    return _map(tree, take)


def replicate(tree, device: torch.device | str | None = None):
    """Every leaf of a tree on ``device`` (default: this process's GPU
    where one is visible, else the CPU)."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return _map(tree, lambda x: x.to(device))


def make_dp_train_step(model, optimizer, group=None, *, mtl: bool,
                       generator: torch.Generator,
                       loss_weights: dict | None = None, l2_reg: float = 0.0,
                       augment_noise: bool = False,
                       featurize: Callable | None = None) -> Callable:
    """``(state, batch, labels) -> metrics``: ``train.state``'s step over
    the process group ``group`` (default: the world), each process passing
    its own rows; the metrics are the group's means.  Broadcasts
    ``model``'s parameters and buffers from the group's first rank now."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_dp_train_step needs an initialized process group "
            "(parallel.initialize_from_env, or init_process_group)")
    device = next(model.parameters()).device
    if device.type == "cuda" and dist.get_backend(group) != "nccl":
        raise RuntimeError(f"data parallelism on CUDA runs over NCCL; the "
                           f"group's backend is {dist.get_backend(group)}")
    world = dist.get_world_size(group)
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t, src=src, group=group)
    use_process_group(model, group)
    params = [p for p in model.parameters() if p.requires_grad]

    def average_gradients():
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= world
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    base = make_train_step(model, optimizer, mtl=mtl, generator=generator,
                           loss_weights=loss_weights, l2_reg=l2_reg,
                           augment_noise=augment_noise, featurize=featurize,
                           before_update=average_gradients)
    def dp_step(state, batch, labels) -> dict:
        # Every step, in every process: a process that skipped the check
        # while another ran it would wait on the reduction for ever.
        first = next(iter(batch.values())) if isinstance(batch, dict) \
            else batch
        n = first.shape[0]
        both = torch.tensor([n, -n], device=first.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        if both.tolist() != [n, -n]:
            raise ValueError("data-parallel shards must be of equal size "
                             "in every process")
        metrics = base(state, batch, labels)
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(vals, group=group)
        vals /= world
        return dict(zip(keys, vals.unbind()))

    return dp_step
