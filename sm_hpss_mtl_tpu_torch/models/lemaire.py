"""Lemaire's TCN models: single-task (TCN trunk -> flatten -> softmax), MTL
(TCN trunk -> flatten -> {S, M, R, 3C} heads; cascaded, or with the noise
head) and the twin-tower intermediate fusion.

Counterpart of ``LemaireTCN``, ``LemaireMTL`` and
``LemaireMTLIntermediateFusion`` in ``sm_hpss_mtl_tpu/models/lemaire.py``.
Input is time-major ``(B, patch_size, D)`` patches, or for the fusion
model a dict of two.  ``dtype`` (flax's, ``layers``) goes to the TCN
towers and to ``MTLHeads``, not to the cascaded heads nor to the output
layers (``out``), which compute in float32, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from .heads import BN_KW, CascadedMTLHeads, MTLHeads
from .layers import BatchNorm1d, Linear
from .tcn import TCN


class LemaireTCN(nn.Module):
    """Single-task: TCN trunk -> flatten -> Dense softmax (``out``)."""

    def __init__(self, in_dim: int, patch_size: int = 68, n_classes: int = 3,
                 n_filters: int = 32, nb_stacks: int = 3,
                 kernel_size: int = 3, Nd: int = 8,
                 dropout_rate: float = 0.275,
                 use_skip_connections: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.tcn = TCN(in_dim, n_filters=n_filters, kernel_size=kernel_size,
                       nb_stacks=nb_stacks,
                       dilations=tuple(2 ** d for d in range(Nd)),
                       dropout_rate=dropout_rate,
                       use_skip_connections=use_skip_connections, dtype=dtype)
        self.out = Linear(patch_size * n_filters, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.tcn(x)
        return torch.softmax(self.out(x.reshape(x.shape[0], -1)), dim=-1)


class LemaireMTL(nn.Module):
    """MTL: TCN trunk -> flatten -> heads: ``MTLHeads`` (S, M, R, 3C; with
    ``with_noise`` also N, and R of 3 units), or with ``cascaded`` the
    ``CascadedMTLHeads``."""

    def __init__(self, in_dim: int, patch_size: int = 68, n_classes: int = 3,
                 n_filters: int = 32, nb_stacks: int = 3,
                 kernel_size: int = 3, Nd: int = 8,
                 dropout_rate: float = 0.275, head_width: int = 16,
                 cascaded: bool = False, with_noise: bool = False,
                 head_layers: int = 1, use_skip_connections: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.tcn = TCN(in_dim, n_filters=n_filters, kernel_size=kernel_size,
                       nb_stacks=nb_stacks,
                       dilations=tuple(2 ** d for d in range(Nd)),
                       dropout_rate=dropout_rate,
                       use_skip_connections=use_skip_connections, dtype=dtype)
        # The JAX cascaded heads take only n_classes.
        self.heads = (CascadedMTLHeads(patch_size * n_filters,
                                       n_classes=n_classes) if cascaded
                      else MTLHeads(patch_size * n_filters,
                                    n_classes=n_classes,
                                    head_width=head_width,
                                    with_noise=with_noise,
                                    head_layers=head_layers, dtype=dtype))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        # The TCN returns (B, T, C); flattening in that order is what the
        # head weights (patch_size * n_filters wide) were trained against.
        x = self.tcn(x)
        return self.heads(x.reshape(x.shape[0], -1))


class LemaireMTLIntermediateFusion(nn.Module):
    """Twin TCN towers at the default kernel size and dilations (``tcn_H``
    over the harmonic features, ``tcn_P`` over the percussive ones), each
    flattened, concatenated, normalised (``fusion_bn``), then ``MTLHeads``.
    ``forward`` takes ``{"harm_input", "perc_input"}``, each ``(B,
    patch_size, in_dim)``."""

    def __init__(self, in_dim: int, patch_size: int = 68, n_classes: int = 3,
                 n_filters: int = 32, nb_stacks: int = 3,
                 dropout_rate: float = 0.275,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.tcn_H = TCN(in_dim, n_filters=n_filters, nb_stacks=nb_stacks,
                         dropout_rate=dropout_rate, dtype=dtype)
        self.tcn_P = TCN(in_dim, n_filters=n_filters, nb_stacks=nb_stacks,
                         dropout_rate=dropout_rate, dtype=dtype)
        width = 2 * patch_size * n_filters
        self.fusion_bn = BatchNorm1d(width, **BN_KW)
        self.heads = MTLHeads(width, n_classes=n_classes, dtype=dtype)

    def forward(self, inputs: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        xh = self.tcn_H(inputs["harm_input"])
        xp = self.tcn_P(inputs["perc_input"])
        x = torch.cat([xh.reshape(xh.shape[0], -1),
                       xp.reshape(xp.shape[0], -1)], dim=-1)
        return self.heads(self.fusion_bn(x))


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
