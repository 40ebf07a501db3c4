"""Transfer learning: fine-tune a restored model on a new corpus
(counterpart of ``sm_hpss_mtl_tpu/train/transfer.py``).

Mirrors the reference's ``transfer_learn_model``
(``DAFx12_Speech_Music_Detection_B3_MTL_v2.py:442-473``): a MUSAN-trained
checkpoint is restored (``train.checkpoint.restore_checkpoint``) and
training continues on the target-domain stream with the remaining epoch
budget, early stopping and best-checkpointing included.  The reference
counts completed epochs from its CSV log to resume interrupted
fine-tuning; here ``initial_epoch`` subtracts from ``epochs``.
"""

from __future__ import annotations

from torch import nn

from .loop import FitResult, fit
from .state import TrainState


def transfer_learn(model: nn.Module, optimizer, state: TrainState,
                   train_iter, val_iter, *, mtl: bool, epochs: int,
                   steps_per_epoch: int, val_steps: int,
                   initial_epoch: int = 0, **fit_kwargs) -> FitResult:
    """Continue training ``model`` from ``state`` for ``epochs -
    initial_epoch`` epochs on the new data stream (``fit``'s keywords,
    such as the device pipeline's ``train_step``/``eval_step``, pass
    through)."""
    remaining = max(epochs - initial_epoch, 0)
    if remaining == 0:
        return FitResult(state=state)
    return fit(model, optimizer, train_iter, val_iter, mtl=mtl,
               epochs=remaining, steps_per_epoch=steps_per_epoch,
               val_steps=val_steps, state=state, **fit_kwargs)
