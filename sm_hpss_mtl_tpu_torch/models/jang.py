"""Jang et al. (EURASIP 2019) mel-scale-kernel CNN, single-task and MTL.

Counterpart of ``sm_hpss_mtl_tpu/models/jang.py``.  The mel-scale layer is
one banded linear operator: a 1-D convolution over time whose input
channels are the F spectrogram rows and whose weight
``kernel (n_mels, F, t_dim, 3)`` is masked, in the forward pass, to each
mel filter's support and initialised from the sr=16000, n_fft=512 mel
filterbank.  Three conv blocks (Conv 3x3 -> BatchNorm -> ReLU -> Dropout
-> max pool 2x2/2) follow; the MTL model adds a 2048/1024 dense stack and
the S/M/R/3C heads.  At inference on CUDA a block's tail after the
convolution's product runs as one kernel (``ops/conv_block.py``).

Layout: input ``(B, F, T)`` or ``(B, F, T, 1)`` as in JAX; inside, the
tower runs NCHW (channels, mel rows, time).  Before the first dense layer
the activations are flattened in flax's NHWC order ``(H, W, C)``, the
order the dense weights of a transferred checkpoint expect.  Submodule
names equal the flax names, so ``weights.from_flax`` maps parameters by
path.

``dtype`` (flax's, ``layers``): the mel-scale layers and the tanh compute
in float32, then the activations are cast to it; each conv block's
convolution computes in it and its BatchNorm returns float32, so the
ReLU, dropout and pooling run in float32; ``fc1``/``fc2`` compute in it,
each followed by a float32 BatchNorm; the heads take it, and the
single-task ``out`` layer computes in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _nvcc, conv_block
from ..ops import reference as ref
from .heads import BN_KW, MTLHeads, dense_with_bn
from .layers import BatchNorm2d, Conv2d, Dropout, Linear
from .pool import max_pool


def mel_band_weights(sr: int, n_fft: int,
                     n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """Mel filterbank ``(n_mels, F)`` and its band-support mask."""
    M = ref.mel_filterbank(sr, n_fft, n_mels).astype(np.float32)
    return M, (M > 0).astype(np.float32)


class MelScaleLayer(nn.Module):
    """Banded mel-kernel layer: ``(B, F, T) -> (B, out_channels, n_mels,
    T)``; the caller applies tanh.  ``kernel`` keeps the flax layout
    ``(n_mels, F, t_dim, out_channels)``."""

    def __init__(self, sr: int = 16000, n_fft: int = 512, n_mels: int = 120,
                 t_dim: int = 5, out_channels: int = 3):
        super().__init__()
        M, mask = mel_band_weights(sr, n_fft, n_mels)
        # The reference's kernel initializer: the mel weight repeated over
        # t_dim and the output channels.
        w = np.repeat(M[:, :, None, None], t_dim, axis=2)
        w = np.repeat(w, out_channels, axis=3)
        self.kernel = nn.Parameter(torch.from_numpy(np.ascontiguousarray(w)))
        self.register_buffer("mask", torch.from_numpy(mask), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_mels, n_bins, t_dim, C = self.kernel.shape
        if x.shape[1] != n_bins:
            raise ValueError(f"expected {n_bins} freq rows, got {x.shape[1]}")
        W = self.kernel * self.mask[:, :, None, None]
        weight = W.permute(0, 3, 1, 2).reshape(n_mels * C, n_bins, t_dim)
        # Padding t_dim//2 before and t_dim-1-t_dim//2 after, as the flax
        # layer pads explicitly.
        half = t_dim // 2
        out = F.conv1d(F.pad(x, (half, t_dim - 1 - half)), weight)
        B, T = x.shape[0], x.shape[-1]
        return out.reshape(B, n_mels, C, T).transpose(1, 2)


class _ConvBlock(nn.Module):
    """Conv 3x3 'same' -> BatchNorm -> ReLU -> Dropout -> max pool 2x2/2.
    At inference on CUDA all after the product is one kernel
    (``ops/conv_block.py``)."""

    def __init__(self, in_channels: int, features: int, dropout: float = 0.4,
                 pool_padding: str = "SAME", dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 3, padding=1,
                           compute_dtype=dtype)
        self.bn = BatchNorm2d(features, **BN_KW)
        self.dropout = Dropout(dropout)
        self.pool_padding = pool_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The block's one route decision: :meth:`fused` in eval mode with
        no gradient recorded on CUDA, :meth:`chain` otherwise (batch
        statistics and dropout masks in train mode, autograd, the CPU)."""
        if self.training or torch.is_grad_enabled() \
                or not _nvcc.on_card("conv_block", x):
            return self.chain(x)
        return self.fused(x)

    def fused(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's route: the product without its bias, then the bias,
        BatchNorm, ReLU and the pool in one pass."""
        conv, b = self.conv.parts(x)
        return conv_block.conv_block(conv, b, self.bn, self.pool_padding)

    def chain(self, x: torch.Tensor) -> torch.Tensor:
        """The chain as written, the convolution with its bias."""
        x = self.dropout(torch.relu(self.bn(self.conv(x))))
        return max_pool(x, (2, 2), (2, 2), padding=self.pool_padding)


class JangCNN(nn.Module):
    """``mtl=False``: one mel tower, VALID pooling, a softmax output.
    ``mtl=True``: harmonic and percussive towers over the two halves of
    the input rows, SAME pooling, dense 2048/1024 and the MTL heads.
    ``patch_size`` (the time width) fixes the first dense layer's width."""

    def __init__(self, n_classes: int = 3, mtl: bool = False,
                 n_mels: int = 120, n_fft: int = 512, t_dim: int = 5,
                 patch_size: int = 68, dtype: torch.dtype | None = None):
        super().__init__()
        self.mtl = mtl
        self.dtype = dtype
        self.n_bins = 1 + n_fft // 2
        mel_kw = dict(n_fft=n_fft, n_mels=n_mels, t_dim=t_dim)
        if mtl:
            self.melCl_H = MelScaleLayer(**mel_kw)
            self.melCl_P = MelScaleLayer(**mel_kw)
        else:
            self.melCl = MelScaleLayer(**mel_kw)
        pool = "SAME" if mtl else "VALID"
        self.b1 = _ConvBlock(3, 32, pool_padding=pool, dtype=dtype)
        self.b2 = _ConvBlock(32, 64, pool_padding=pool, dtype=dtype)
        self.b3 = _ConvBlock(64, 128, pool_padding=pool, dtype=dtype)
        H, W = (2 if mtl else 1) * n_mels, patch_size
        for _ in range(3):
            H = conv_block.pooled_size(H, pool)
            W = conv_block.pooled_size(W, pool)
        flat = H * W * 128
        if mtl:
            self.fc1, self.fc1_bn = dense_with_bn(flat, 2048, dtype)
            self.fc2, self.fc2_bn = dense_with_bn(2048, 1024, dtype)
            self.fc_dropout = Dropout(0.4)
            self.heads = MTLHeads(1024, n_classes=n_classes, dtype=dtype)
        else:
            self.out = Linear(flat, n_classes)

    def forward(self, x: torch.Tensor):
        x = x[..., 0] if x.ndim == 4 else x
        if self.mtl:
            y = torch.cat([self.melCl_H(x[:, :self.n_bins]),
                           self.melCl_P(x[:, self.n_bins:])], dim=2)
        else:
            y = self.melCl(x)
        y = torch.tanh(y)
        if self.dtype is not None:
            y = y.to(self.dtype)
        y = self.b3(self.b2(self.b1(y)))
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)   # NHWC flatten
        if not self.mtl:
            return torch.softmax(self.out(y), dim=-1)
        for fc, bn in ((self.fc1, self.fc1_bn), (self.fc2, self.fc2_bn)):
            y = self.fc_dropout(torch.relu(bn(fc(y))))
        return self.heads(y)
