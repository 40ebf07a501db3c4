"""Training loop: epochs over a balanced stream with early stopping,
best-checkpoint saving and CSV epoch logs (counterpart of
``sm_hpss_mtl_tpu/train/loop.py``).

The reference's ``train_model`` callbacks: ``EarlyStopping(monitor=
val_loss, min_delta=0.01, patience=5, restore_best_weights=True)``, a
best-only ``ModelCheckpoint`` and a ``CSVLogger``; its training time is
``time.process_time`` (host CPU time), reported beside the wall time.

Metrics are summed on the device and fetched once per epoch (one packed
device-to-host copy), so a step never waits for the host to read a loss.
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, field

import torch
from torch import nn

from .state import TrainState, make_eval_step, make_train_step

#: The reference's early-stopping policy; ``cli.experiment._resume_status``
#: replays it with the same values.
EARLY_STOP_PATIENCE = 5
EARLY_STOP_MIN_DELTA = 0.01


@dataclass
class FitResult:
    state: TrainState
    history: list = field(default_factory=list)
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    #: host CPU time (the reference's ``time.process_time``); device time
    #: the host waits for is not in it, so ``wall_time`` is the honest one
    training_time: float = 0.0
    wall_time: float = 0.0
    stopped_early: bool = False


def _accumulate(acc: dict | None, metrics: dict) -> dict:
    """Running on-device sums of per-step metrics (no host fetch)."""
    metrics = {k: torch.as_tensor(v, dtype=torch.float32)
               for k, v in metrics.items()}
    if acc is None:
        return {k: v.clone() for k, v in metrics.items()}
    for k, v in metrics.items():
        acc[k] += v.to(acc[k].device)
    return acc


def _fetch_mean(acc: dict, n: int) -> dict:
    """Mean metrics with one device-to-host copy, keys sorted (the JAX
    loop's order, hence its epoch-log columns)."""
    keys = sorted(acc)
    flat = torch.stack([acc[k].reshape(()) for k in keys]).cpu() / max(n, 1)
    return {k: float(v) for k, v in zip(keys, flat.tolist())}


def fit(model: nn.Module, optimizer: torch.optim.Optimizer, train_iter,
        val_iter, *, mtl: bool, epochs: int, steps_per_epoch: int,
        val_steps: int, state: TrainState | None = None,
        loss_weights: dict | None = None, l2_reg: float = 0.0,
        augment_noise: bool = False,
        generator: torch.Generator | None = None,
        patience: int = EARLY_STOP_PATIENCE,
        min_delta: float = EARLY_STOP_MIN_DELTA,
        checkpoint_dir: str | None = None, csv_log: str | None = None,
        train_step=None, eval_step=None,
        initial_epoch: int = 0, initial_best: float = float("inf"),
        verbose: bool = True) -> FitResult:
    """Train with early stopping on the val loss; restores the best weights.

    ``train_step``/``eval_step`` replace the patch-batch steps (the device
    pipeline passes ``train.endtoend``'s); the default train step draws
    from ``generator`` (seed 0 on the model's device if None).

    ``initial_epoch``/``initial_best`` continue an interrupted run for the
    remaining budget: epoch numbers and the CSV log go on where they
    stopped, and a checkpoint overwrites the restored best only when the
    val loss improves on ``initial_best``.  The patience count restarts at
    zero, as the reference's re-``fit`` does.
    """
    if state is None:
        state = TrainState(model, optimizer)
    if train_step is None:
        if generator is None:
            device = next(model.parameters()).device
            generator = torch.Generator(device=device).manual_seed(0)
        train_step = make_train_step(model, optimizer, mtl=mtl,
                                     generator=generator,
                                     loss_weights=loss_weights,
                                     l2_reg=l2_reg,
                                     augment_noise=augment_noise)
    if eval_step is None:
        eval_step = make_eval_step(model, mtl=mtl, loss_weights=loss_weights)

    result = FitResult(state=state, best_val_loss=initial_best,
                       best_epoch=initial_epoch - 1 if initial_epoch else -1)
    best_weights = None
    wait = 0
    t0 = time.process_time()
    w0 = time.perf_counter()
    csv_file = csv_writer = None

    try:
        for epoch in range(initial_epoch, epochs):
            e0 = time.perf_counter()
            train_acc = None
            for _ in range(steps_per_epoch):
                batch, labels = next(train_iter)
                train_acc = _accumulate(train_acc,
                                        train_step(state, batch, labels))
            # The fetch waits for every step of the epoch: time after it.
            tr = _fetch_mean(train_acc, steps_per_epoch)
            t_train = time.perf_counter() - e0
            val_acc = None
            for _ in range(val_steps):
                batch, labels = next(val_iter)
                val_acc = _accumulate(val_acc, eval_step(state, batch,
                                                         labels))
            va = _fetch_mean(val_acc, val_steps)
            row = {"epoch": epoch, "epoch_train_s": round(t_train, 3),
                   **tr, **{f"val_{k}": v for k, v in va.items()}}
            result.history.append(row)
            if verbose:
                print(f"epoch {epoch}: loss={tr['loss']:.4f} "
                      f"val_loss={va['loss']:.4f}", flush=True)

            if csv_log:
                if csv_writer is None:
                    os.makedirs(os.path.dirname(csv_log) or ".",
                                exist_ok=True)
                    # A resumed run appends, so the completed-epoch count
                    # survives further interruptions.
                    append = initial_epoch > 0 and os.path.exists(csv_log)
                    csv_file = open(csv_log, "a" if append else "w",
                                    newline="")
                    csv_writer = csv.DictWriter(csv_file,
                                                fieldnames=row.keys())
                    if not append:
                        csv_writer.writeheader()
                csv_writer.writerow(row)
                csv_file.flush()

            val_loss = va["loss"]
            if val_loss < result.best_val_loss - min_delta:
                result.best_val_loss = val_loss
                result.best_epoch = epoch
                best_weights = {k: v.detach().to("cpu", copy=True)
                                for k, v in model.state_dict().items()}
                wait = 0
                if checkpoint_dir:
                    from .checkpoint import save_checkpoint
                    save_checkpoint(checkpoint_dir, state,
                                    {"epoch": epoch,
                                     "val_loss": float(val_loss)})
            else:
                wait += 1
                if wait >= patience:
                    result.stopped_early = True
                    if verbose:
                        print(f"early stopping at epoch {epoch} "
                              f"(best={result.best_epoch})", flush=True)
                    break
    finally:
        if csv_file:
            csv_file.close()

    result.training_time = time.process_time() - t0
    result.wall_time = time.perf_counter() - w0
    if best_weights is not None:
        model.load_state_dict(best_weights)
    result.state = state
    return result


def evaluate_generator(model: nn.Module, state: TrainState, test_iter,
                       steps: int, *, mtl: bool,
                       loss_weights: dict | None = None) -> dict:
    """Mean metrics over ``steps`` balanced test batches, the reference's
    ``model.evaluate(generator, steps=TS_STEPS)``."""
    eval_step = make_eval_step(model, mtl=mtl, loss_weights=loss_weights)
    acc = None
    for _ in range(steps):
        batch, labels = next(test_iter)
        acc = _accumulate(acc, eval_step(state, batch, labels))
    return _fetch_mean(acc, steps)
