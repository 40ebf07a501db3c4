"""STFT (center=False) and its inverse in plain PyTorch.

Counterpart of ``sm_hpss_mtl_tpu/ops/stft.py``: frames are strided views
(``Tensor.unfold``) hit with one windowed real-DFT basis matmul, so the
STFT stays in real arithmetic until :func:`stft` pairs the halves into a
complex tensor.  :func:`istft` is the windowed overlap-add inverse.  The
JAX package computes all of this outside Pallas, so none of it is a
kernel here.  Geometry defaults to the reference's: 16 kHz audio,
400-sample window, hop 160, n_fft 400 (512 for Jang).
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


def real_dtype(x: torch.Tensor) -> torch.dtype:
    """float64 for a float64 tensor, else float32: the plain DSP chain runs
    in float32 and keeps float64 only where a caller asks for it (the
    kernels' float64 yardstick in ``chip_smoke.py``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


@functools.lru_cache(maxsize=16)
def _dft_basis(n_fft: int, win_length: int, dtype=np.float32) -> np.ndarray:
    """Windowed rDFT basis ``(n_fft, 2F)``: columns ``[0, F)`` cos, ``[F, 2F)``
    −sin, computed in float64 and rounded once to ``dtype``."""
    F = 1 + n_fft // 2
    window = ref.pad_center(ref.hann_window(win_length), n_fft)
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * np.arange(F)[None, :] / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * window[:, None]
    return basis.astype(dtype)


def _stft_reim(y: torch.Tensor, n_fft: int, win_length: int,
               hop_length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary parts, each ``(..., T, F)``."""
    F = 1 + n_fft // 2
    dtype = real_dtype(y)
    frames = y.to(dtype).unfold(-1, n_fft, hop_length)          # (..., T, n)
    basis = _dft_basis(n_fft, win_length,
                       np.float64 if dtype == torch.float64 else np.float32)
    reim = torch.matmul(frames, torch.as_tensor(basis, device=y.device))
    return reim[..., :F], reim[..., F:]


def stft_mag(y: torch.Tensor, *, n_fft: int, win_length: int,
             hop_length: int) -> torch.Tensor:
    """``(..., n_samples)`` -> magnitude ``(..., F, T)``, float32 (float64
    for float64 audio)."""
    re, im = _stft_reim(y, n_fft, win_length, hop_length)
    return torch.sqrt(re * re + im * im).transpose(-1, -2)


def stft(y: torch.Tensor, *, n_fft: int, win_length: int,
         hop_length: int) -> torch.Tensor:
    """Complex STFT of the last axis: ``(..., n_samples)`` ->
    ``(..., F, T)`` complex64 (frequency, time)."""
    re, im = _stft_reim(y, n_fft, win_length, hop_length)
    return torch.complex(re, im).transpose(-1, -2)


def istft(S: torch.Tensor, *, n_fft: int, win_length: int, hop_length: int,
          length: int | None = None) -> torch.Tensor:
    """Inverse of :func:`stft`: ``(..., F, T)`` complex -> ``(..., n)``.

    Each frame is ``irfft`` times the window; the frames are overlap-added
    (``F.fold``) and divided by the overlap-added squared window where
    that exceeds 1e-10.  The result is ``n_fft + hop*(T-1)`` samples,
    trimmed or zero-padded to ``length`` when given."""
    window = hann_window(win_length, n_fft, device=S.device)
    frames = torch.fft.irfft(S.transpose(-1, -2), n=n_fft, dim=-1) * window
    lead, T = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop_length * (T - 1)

    def overlap_add(x):                      # (B, T, n_fft) -> (B, out_len)
        return torch.nn.functional.fold(
            x.transpose(1, 2), output_size=(1, out_len),
            kernel_size=(1, n_fft), stride=(1, hop_length))[:, 0, 0]

    y = overlap_add(frames.reshape(-1, T, n_fft)).reshape(lead + (out_len,))
    wsum = overlap_add((window ** 2).expand(1, T, n_fft))[0]
    y = y / torch.where(wsum > 1e-10, wsum, torch.ones_like(wsum))
    if length is not None:
        if length <= out_len:
            y = y[..., :length]
        else:
            y = torch.nn.functional.pad(y, (0, length - out_len))
    return y
