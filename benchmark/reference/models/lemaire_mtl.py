"""Lemaire-MTL: keras-tcn's TCN (a 'same' convolution to ``n_filters``
channels, ``nb_stacks`` stacks of residual blocks over dilations ``2^0 ..
2^(Nd-1)``, each a dilated convolution, ReLU, max-abs channel
normalisation, SpatialDropout1D and a 1x1 convolution, then a ReLU) under
the S/M/R/3C heads.  Time-major input."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..layers import Draws, mtl_heads


def _conv1d(x, W, name, dilation=1):
    w = W[name + ".weight"]
    pad = dilation * (w.shape[-1] - 1) // 2
    return F.conv1d(x, w, W[name + ".bias"], padding=pad, dilation=dilation)


def forward(x: torch.Tensor, W: dict, cfg: dict, draws: Draws,
            train: bool) -> dict[str, torch.Tensor]:
    """``(B, patch, D)`` time-major patches -> the four heads."""
    arch = cfg["arch"]
    h = _conv1d(x.transpose(1, 2), W, "tcn.initial_conv")
    for s in range(arch["nb_stacks"]):
        for d in (2 ** i for i in range(arch["Nd"])):
            pre = f"tcn.stack{s}_dilation{d}."
            y = torch.relu(_conv1d(h, W, pre + "dilated_conv", d))
            y = y / (y.abs().amax(dim=1, keepdim=True) + 1e-5)
            y = draws.dropout(y, arch["dropout_rate"], spatial=True)
            h = h + _conv1d(y, W, pre + "conv_1x1")
    h = torch.relu(h).transpose(1, 2)
    return mtl_heads(h.reshape(h.shape[0], -1), W, draws, train)


def layout(patches: torch.Tensor) -> torch.Tensor:
    return patches.transpose(1, 2).contiguous()


def l2_names(W: dict) -> list[str]:
    """The heads' dense kernels (Keras ``kernel_regularizer``)."""
    return [k for k, v in W.items() if v.ndim >= 2 and k.startswith("heads.")]
