"""Lemaire's TCN models: single-task (TCN trunk -> flatten -> softmax) and
MTL (TCN trunk -> flatten -> {S, M, R, 3C} heads).

Counterpart of ``LemaireTCN`` and ``LemaireMTL`` in
``sm_hpss_mtl_tpu/models/lemaire.py``.  Input is time-major
``(B, patch_size, D)`` patches.
"""

from __future__ import annotations

import torch
from torch import nn

from .heads import MTLHeads
from .tcn import TCN


class LemaireTCN(nn.Module):
    """Single-task: TCN trunk -> flatten -> Dense softmax (``out``)."""

    def __init__(self, in_dim: int, patch_size: int = 68, n_classes: int = 3,
                 n_filters: int = 32, nb_stacks: int = 3,
                 kernel_size: int = 3, Nd: int = 8,
                 dropout_rate: float = 0.275):
        super().__init__()
        self.tcn = TCN(in_dim, n_filters=n_filters, kernel_size=kernel_size,
                       nb_stacks=nb_stacks,
                       dilations=tuple(2 ** d for d in range(Nd)),
                       dropout_rate=dropout_rate)
        self.out = nn.Linear(patch_size * n_filters, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.tcn(x)
        return torch.softmax(self.out(x.reshape(x.shape[0], -1)), dim=-1)


class LemaireMTL(nn.Module):
    def __init__(self, in_dim: int, patch_size: int = 68, n_classes: int = 3,
                 n_filters: int = 32, nb_stacks: int = 3,
                 kernel_size: int = 3, Nd: int = 8,
                 dropout_rate: float = 0.275, head_width: int = 16):
        super().__init__()
        self.tcn = TCN(in_dim, n_filters=n_filters, kernel_size=kernel_size,
                       nb_stacks=nb_stacks,
                       dilations=tuple(2 ** d for d in range(Nd)),
                       dropout_rate=dropout_rate)
        self.heads = MTLHeads(patch_size * n_filters, n_classes=n_classes,
                              head_width=head_width)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        # The TCN returns (B, T, C); flattening in that order is what the
        # head weights (patch_size * n_filters wide) were trained against.
        x = self.tcn(x)
        return self.heads(x.reshape(x.shape[0], -1))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Keras initialisation from ``generator``: glorot-uniform kernels and
    zero biases, or, for a layer with a ``keras_init = (std, bias)``
    attribute (Papakostas's), normal kernels of that std and that constant
    bias; BatchNorm at scale 1 and shift 0.  Other parameters (the
    mel-scale kernels of Jang's model) keep their constructor's values."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                init = getattr(mod, "keras_init", None)
                if init is None:
                    nn.init.xavier_uniform_(mod.weight, generator=generator)
                    nn.init.zeros_(mod.bias)
                else:
                    nn.init.normal_(mod.weight, std=init[0],
                                    generator=generator)
                    nn.init.constant_(mod.bias, init[1])
            elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
                mod.reset_parameters()
    return model
