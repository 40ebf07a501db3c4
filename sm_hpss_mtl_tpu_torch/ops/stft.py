"""Magnitude STFT (center=False) in plain PyTorch.

Counterpart of ``sm_hpss_mtl_tpu/ops/stft.py``: frames are strided views
(``Tensor.unfold``) hit with one windowed real-DFT basis matmul, so the
STFT stays in real arithmetic.  Geometry defaults to the reference's:
16 kHz audio, 400-sample window, hop 160, n_fft 400 (512 for Jang).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import reference as ref


def n_frames(n_samples: int, frame_length: int, hop_length: int) -> int:
    """Frame count for center=False framing."""
    return 1 + (n_samples - frame_length) // hop_length


def hann_window(win_length: int, n_fft: int, *,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """Periodic Hann window zero-padded to ``n_fft``."""
    w = ref.pad_center(ref.hann_window(win_length), n_fft)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed rDFT basis ``(n_fft, 2F)``: columns ``[0, F)`` cos, ``[F, 2F)``
    −sin, computed in float64 and rounded once."""
    F = 1 + n_fft // 2
    window = ref.pad_center(ref.hann_window(win_length), n_fft)
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * np.arange(F)[None, :] / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * window[:, None]
    return basis.astype(np.float32)


def stft_mag(y: torch.Tensor, *, n_fft: int, win_length: int,
             hop_length: int) -> torch.Tensor:
    """``(..., n_samples)`` -> magnitude ``(..., F, T)`` float32."""
    F = 1 + n_fft // 2
    frames = y.to(torch.float32).unfold(-1, n_fft, hop_length)  # (..., T, n)
    basis = torch.as_tensor(_dft_basis(n_fft, win_length), device=y.device)
    reim = torch.matmul(frames, basis)                          # (..., T, 2F)
    re, im = reim[..., :F], reim[..., F:]
    return torch.sqrt(re * re + im * im).transpose(-1, -2)
