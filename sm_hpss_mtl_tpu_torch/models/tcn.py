"""Temporal Convolutional Network (Lemaire et al., ISMIR 2019 config).

Counterpart of ``sm_hpss_mtl_tpu/models/tcn.py`` (the keras-tcn residual
block as the reference configures it): an initial conv to ``n_filters``
channels, ``nb_stacks`` stacks over dilations ``1 .. 2^(Nd-1)``, each block
dilated conv -> ReLU -> per-timestep channel max-abs normalisation ->
spatial dropout -> 1x1 conv -> residual add, then a final ReLU.

Layout: the trunk runs ``(B, C, T)`` internally, as ``nn.Conv1d`` wants;
:class:`TCN` takes and returns time-major ``(B, T, C)`` like the JAX
module.  Submodule names equal the flax names, so ``weights.from_flax``
maps parameters by path.

``dtype`` (flax's): the TCN casts its input to it, and every convolution,
the channel normalisation, the residual sums and the final ReLU run in it
(the trunk has no BatchNorm).  The parameters stay float32.

On CUDA a block's pointwise chain runs in two hand-written kernels between
and after its two cuDNN convolutions (``ops/tcn_block.py``), with the
chain's bits, under ``torch.func``'s transforms too; they take float32 and
bfloat16 and raise on another dtype.  On the CPU the block runs the chain
as written here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import tcn_block
from ..ops.tcn_block import channel_normalization
from .layers import Conv1d, Dropout


class SpatialDropout1D(Dropout):
    """Drop whole channels of ``(B, C, T)`` (one mask across time), as
    Keras SpatialDropout1D; the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__(rate, spatial=True)


class TCNResidualBlock(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int, dilation: int,
                 dropout_rate: float, dtype: torch.dtype | None = None):
        super().__init__()
        self.dilated_conv = Conv1d(n_filters, n_filters, kernel_size,
                                   dilation=dilation, padding="same",
                                   compute_dtype=dtype)
        self.dropout = SpatialDropout1D(dropout_rate)
        self.conv_1x1 = Conv1d(n_filters, n_filters, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, skip: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The block's output and its skip branch (the 1x1 conv's): the
        block's one route decision, :meth:`fused` on CUDA and :meth:`chain`
        on any other device."""
        return (self.fused if x.is_cuda else self.chain)(x, skip)

    def fused(self, x: torch.Tensor, skip: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The kernels' route (``ops/tcn_block.py``); the skip branch is
        left out, as None, unless ``skip``."""
        conv, b = self.dilated_conv.parts(x)
        y = tcn_block.forward_a(conv, b, self.dropout.mask(conv),
                                self.dropout.keep)
        conv, b = self.conv_1x1.parts(y)
        return tcn_block.forward_b(x, conv, b, skip)

    def chain(self, x: torch.Tensor, skip: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The chain as written, each convolution with its bias: the skip
        branch always, as the JAX package's block returns it."""
        y = channel_normalization(torch.relu(self.dilated_conv(x)))
        y = self.conv_1x1(self.dropout(y))
        return x + y, y


class TCN(nn.Module):
    """Returns sequences: ``(B, T, D) -> (B, T, n_filters)``.  With
    ``use_skip_connections`` the output is the sum of every block's skip
    branch instead of the last block's output (keras-tcn; the tuner's
    architecture space)."""

    def __init__(self, in_dim: int, n_filters: int = 32, kernel_size: int = 3,
                 nb_stacks: int = 3,
                 dilations: tuple = (1, 2, 4, 8, 16, 32, 64, 128),
                 dropout_rate: float = 0.275,
                 use_skip_connections: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.use_skip_connections = use_skip_connections
        self.dtype = dtype
        self.initial_conv = Conv1d(in_dim, n_filters, kernel_size,
                                   padding="same", compute_dtype=dtype)
        self.block_names = []
        for s in range(nb_stacks):
            for d in dilations:
                name = f"stack{s}_dilation{d}"
                self.add_module(name, TCNResidualBlock(
                    n_filters, kernel_size, d, dropout_rate, dtype))
                self.block_names.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.initial_conv(x.transpose(1, 2))
        skips = []
        for name in self.block_names:
            x, skip = getattr(self, name)(x, self.use_skip_connections)
            skips.append(skip)
        if self.use_skip_connections:
            x = sum(skips)
        return torch.relu(x).transpose(1, 2)
