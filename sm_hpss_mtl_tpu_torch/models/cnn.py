"""Doukhan (MIREX 2018) and Papakostas (ESwA 2018) CNN baselines and their
MTL variants (counterpart of ``sm_hpss_mtl_tpu/models/cnn.py``).

Input ``(B, rows, patch_size, 1)`` or ``(B, rows, patch_size)`` as in JAX:
Doukhan takes mel rows (21 baseline, 2 x 120 MTL), Papakostas raw
spectrogram rows (201 baseline, 402 MTL).  Inside, the towers run NCHW;
before the first dense layer the activations are flattened in flax's NHWC
order ``(H, W, C)``, the order the dense weights of a transferred
checkpoint expect (as ``models/jang.py``).  The first dense layer's width
follows from ``rows`` and ``patch_size``, which flax infers from the data.
Submodule names equal the flax names, so ``weights.from_flax`` maps
parameters by path.

Initialisation (``lemaire.init_weights``): Keras glorot-uniform kernels and
zero biases, but Papakostas's layers draw ``normal(0, 0.01)`` kernels with
bias 0.1, marked by their ``keras_init`` attribute.

``dtype`` (flax's, ``layers``): the model casts its input to it, and its
convolutions and dense layers compute in it; each BatchNorm returns
float32, and the LRN computes in float32 and casts back, so Papakostas's
LRN after a bfloat16 convolution returns bfloat16.  The heads take the
dtype; the single-task ``out`` layer computes in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .heads import BN_KW, MTLHeads
from .layers import BatchNorm1d, BatchNorm2d, Conv2d, Dropout, Linear
from .pool import max_pool

#: Papakostas's ``RandomNormal(stddev=0.01)`` kernels and ``Constant(0.1)``
#: biases: (kernel std, bias).
PAPAKOSTAS_INIT = (0.01, 0.1)


def local_response_normalization(x: torch.Tensor, depth_radius: int = 5,
                                 bias: float = 1.0, alpha: float = 1e-4,
                                 beta: float = 0.75) -> torch.Tensor:
    """TF-semantics LRN over the channels (dim 1 of NCHW):
    ``x / (bias + alpha * sum_{|d| <= depth_radius} x_{c+d}^2) ** beta``.
    ``F.local_response_norm`` averages over its window, so its alpha is
    TF's times the window size.  Computed in float32 at least, returned in
    x's dtype."""
    size = 2 * depth_radius + 1
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    return F.local_response_norm(wide, size, alpha=alpha * size, beta=beta,
                                 k=bias).to(x.dtype)


def _papakostas(layer: nn.Module) -> nn.Module:
    layer.keras_init = PAPAKOSTAS_INIT
    return layer


def _conv_out(size: int, window: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    return (size - window) // stride + 1


class _ConvBNRelu(nn.Module):
    """Conv (VALID) -> BatchNorm -> ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: tuple,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, compute_dtype=dtype)
        self.bn = BatchNorm2d(features, **BN_KW)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class _DenseBNReluDrop(nn.Module):
    """Dense -> BatchNorm -> ReLU -> Dropout."""

    def __init__(self, in_features: int, features: int, dropout: float,
                 papakostas: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.dense = Linear(in_features, features, compute_dtype=dtype)
        if papakostas:
            _papakostas(self.dense)
        self.bn = BatchNorm1d(features, **BN_KW)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(torch.relu(self.bn(self.dense(x))))


def _nchw(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``(B, rows, W, 1)`` or ``(B, rows, W)`` -> ``(B, 1, rows, W)``, cast
    to ``dtype`` if one is given."""
    x = (x[..., 0] if x.ndim == 4 else x)[:, None]
    return x if dtype is None else x.to(dtype)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class DoukhanCNN(nn.Module):
    """4 conv blocks, 4 x Dense-512; ``mtl=False``: a softmax output."""

    def __init__(self, rows: int, patch_size: int = 68, n_classes: int = 3,
                 mtl: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.mtl = mtl
        self.dtype = dtype
        self.c1 = _ConvBNRelu(1, 64, (4, 5), dtype)
        self.c2 = _ConvBNRelu(64, 128, (3, 3), dtype)
        self.c3 = _ConvBNRelu(128, 128, (3, 3), dtype)
        self.c4 = _ConvBNRelu(128, 256, (3, 3), dtype)
        H, W = rows - 3, patch_size - 4                      # c1
        H, W = H // 2, W // 2                                # pool VALID
        H, W = H - 4, W - 4                                  # c2, c3
        H, W = -(-H // 2), -(-W // 2)                        # pool SAME
        H, W = H - 2, (W - 2) // 12                          # c4, pool 1x12
        if H < 1 or W < 1:
            raise ValueError(f"input {rows} x {patch_size} is too small "
                             "for DoukhanCNN")
        width = H * W * 256
        for i, rate in enumerate((0.2, 0.3, 0.4, 0.5)):
            self.add_module(f"fc{i + 1}", _DenseBNReluDrop(width, 512, rate,
                                                           dtype=dtype))
            width = 512
        if mtl:
            self.heads = MTLHeads(512, n_classes=n_classes, dtype=dtype)
        else:
            self.out = Linear(512, n_classes)

    def forward(self, x: torch.Tensor):
        x = max_pool(self.c1(_nchw(x, self.dtype)), (2, 2), (2, 2), "VALID")
        x = max_pool(self.c3(self.c2(x)), (2, 2), (2, 2), "SAME")
        x = max_pool(self.c4(x), (1, 12), (1, 12), "VALID")
        x = _flatten_nhwc(x)
        for i in range(4):
            x = getattr(self, f"fc{i + 1}")(x)
        if self.mtl:
            return self.heads(x)
        return torch.softmax(self.out(x), dim=-1)


class PapakostasCNN(nn.Module):
    """AlexNet-style CNN with LRN; ``mtl=False``: a softmax output."""

    def __init__(self, rows: int, patch_size: int = 68, n_classes: int = 3,
                 mtl: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.mtl = mtl
        self.dtype = dtype
        self.c1 = _papakostas(Conv2d(1, 96, 5, stride=2, compute_dtype=dtype))
        self.c2 = _papakostas(Conv2d(96, 384, 3, stride=2,
                                     compute_dtype=dtype))
        self.c3 = _papakostas(Conv2d(384, 512, 3, padding=1,
                                     compute_dtype=dtype))
        H, W = rows, patch_size
        for window, stride, padding in ((5, 2, "VALID"), (3, 2, "SAME"),
                                        (3, 2, "VALID"), (3, 2, "SAME"),
                                        (3, 2, "SAME")):      # c3 keeps H, W
            H = _conv_out(H, window, stride, padding)
            W = _conv_out(W, window, stride, padding)
        if H < 1 or W < 1:
            raise ValueError(f"input {rows} x {patch_size} is too small "
                             "for PapakostasCNN")
        self.fc1 = _DenseBNReluDrop(H * W * 512, 4096, 0.5, papakostas=True,
                                    dtype=dtype)
        self.fc2 = _DenseBNReluDrop(4096, 4096, 0.5, papakostas=True,
                                    dtype=dtype)
        if mtl:
            self.heads = MTLHeads(4096, n_classes=n_classes, dtype=dtype)
        else:
            self.out = _papakostas(Linear(4096, n_classes))

    def forward(self, x: torch.Tensor):
        pool = (lambda y: max_pool(y, (3, 3), (2, 2), "SAME"))  # noqa: E731
        x = pool(torch.relu(local_response_normalization(
            self.c1(_nchw(x, self.dtype)))))
        x = pool(torch.relu(local_response_normalization(self.c2(x))))
        x = pool(torch.relu(self.c3(x)))
        x = self.fc2(self.fc1(_flatten_nhwc(x)))
        if self.mtl:
            return self.heads(x)
        return torch.softmax(self.out(x), dim=-1)
