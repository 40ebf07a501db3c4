"""Jang-MTL: two mel-scale convolution towers (a kernel masked to each mel
filter's support, tanh) over the harmonic and percussive spectrograms,
three Conv-BN-ReLU-Dropout-MaxPool blocks, dense layers of 2048 and 1024
with BatchNorm, and the S/M/R/3C heads.  Image input."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..frontend import mel_filterbank
from ..layers import Draws, batch_norm, dense, mtl_heads


def _mel_bank(cfg: dict, device) -> torch.Tensor:
    """The mel bank of the model's own geometry (16 kHz, its n_fft)."""
    arch = cfg["arch"]
    return torch.as_tensor(mel_filterbank(
        arch["mel_sr"], cfg["features"]["n_fft"], arch["n_mels"]),
        dtype=torch.float32, device=device)


def _mel_tower(x, W, name, mask):
    K = W[name + ".kernel"] * mask[:, :, None, None]      # (mels, F, t, C)
    n_mels, n_bins, t_dim, C = K.shape
    w = K.permute(0, 3, 1, 2).reshape(n_mels * C, n_bins, t_dim)
    half = t_dim // 2
    y = F.conv1d(F.pad(x, (half, t_dim - 1 - half)), w)
    return y.reshape(x.shape[0], n_mels, C, -1).transpose(1, 2)


def forward(x: torch.Tensor, W: dict, cfg: dict, draws: Draws,
            train: bool) -> dict[str, torch.Tensor]:
    """``(B, 2F, patch, 1)`` images -> the four heads."""
    arch = cfg["arch"]
    x = x[..., 0]
    F_bins = x.shape[1] // 2
    mask = (_mel_bank(cfg, x.device) > 0).to(x.dtype)
    y = torch.cat([_mel_tower(x[:, :F_bins], W, "melCl_H", mask),
                   _mel_tower(x[:, F_bins:], W, "melCl_P", mask)], dim=2)
    y = torch.tanh(y)
    for b in ("b1", "b2", "b3"):
        y = F.conv2d(y, W[f"{b}.conv.weight"], W[f"{b}.conv.bias"], padding=1)
        y = torch.relu(batch_norm(y, W, f"{b}.bn", train))
        y = draws.dropout(y, arch["dropout_rate"])
        y = F.max_pool2d(y, 2, 2, ceil_mode=True)
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)       # NHWC order
    for fc in ("fc1", "fc2"):
        y = torch.relu(batch_norm(dense(y, W, fc), W, fc + "_bn", train))
        y = draws.dropout(y, arch["dropout_rate"])
    return mtl_heads(y, W, draws, train)


def layout(patches: torch.Tensor) -> torch.Tensor:
    return patches[..., None]


def l2_names(W: dict) -> list[str]:
    """The heads' dense kernels and the mel-scale layers' kernels."""
    return [k for k, v in W.items() if v.ndim >= 2 and (
        k.startswith("heads.")
        or (k.startswith("melCl") and k.endswith(".kernel")))]


def init_leaf(name: str, u: torch.Tensor, cfg: dict):
    """The mel-scale kernels (``*.kernel``, ``(n_mels, F, t, C)``): the mel
    bank of the model's geometry times 1 + uniform(+-0.1)."""
    if not name.endswith(".kernel"):
        return None
    M = _mel_bank(cfg, u.device)
    return M[:, :, None, None] * (1 + 0.1 * (2 * u - 1))
