"""Mel projection and librosa's ``power_to_db`` in plain PyTorch.

Counterpart of ``sm_hpss_mtl_tpu/ops/mel.py``.  The HPSS feature branches
build their mel bank at sr=22050 (librosa's default), a reference quirk
kept on purpose (see ``ops/featuregram.py``).
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from . import reference as ref


@functools.lru_cache(maxsize=32)
def _mel_basis(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    return np.asarray(ref.mel_filterbank(sr, n_fft, n_mels), dtype=np.float32)


@functools.lru_cache(maxsize=32)
def _mel_on(sr: int, n_fft: int, n_mels: int,
            device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_mel_basis(sr, n_fft, n_mels), device=device)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, *,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """Slaney-norm mel filterbank ``(n_mels, 1 + n_fft//2)`` float32, one
    shared tensor per geometry and device (as the CPU tensor always shared
    the cached array): do not modify it in place."""
    return _mel_on(sr, n_fft, n_mels, torch.device(device))


def mel_band_ranges(M: torch.Tensor) -> torch.Tensor:
    """Each row's nonzero bins of an ``(n_mels, F)`` basis as ``(n_mels, 2)``
    int32 ``[lo, hi)``: its first nonzero and one past its last; ``[0, 0)``
    for a row of zeros.  Computed on ``M``'s device, without a sync.  The
    mel epilogues of K1 and K4 sum each band over its range only."""
    nz = M != 0
    k = torch.arange(M.shape[1], device=M.device)
    lo = torch.where(nz, k, M.shape[1]).amin(dim=1)
    hi = torch.where(nz, k + 1, 0).amax(dim=1)
    return torch.stack([torch.minimum(lo, hi), hi], dim=1).to(torch.int32)


_BANDS: dict[int, tuple] = {}


def _band_ranges_of(M: torch.Tensor) -> torch.Tensor:
    """:func:`mel_band_ranges` of ``M``, kept while that tensor lives and is
    not modified in place (its ``_version``), so a basis reused across
    launches is scanned once."""
    key = id(M)
    hit = _BANDS.get(key)
    if hit is not None and hit[0]() is M and hit[1] == M._version:
        return hit[2]
    ranges = mel_band_ranges(M)
    _BANDS[key] = (weakref.ref(M, lambda _, key=key: _BANDS.pop(key, None)),
                   M._version, ranges)
    return ranges


def apply_mel(S: torch.Tensor, *, sr: int, n_mels: int) -> torch.Tensor:
    """Project a spectrogram ``(..., F, T)`` onto ``n_mels`` bands; the FFT
    size is inferred from F as librosa's ``melspectrogram(S=...)`` does."""
    n_fft = 2 * (S.shape[-2] - 1)
    return torch.matmul(mel_filterbank(sr, n_fft, n_mels, device=S.device), S)


def power_to_db(S: torch.Tensor, *, ref_value: float = 1.0,
                amin: float = 1e-10, top_db: float | None = 80.0,
                valid_len=None) -> torch.Tensor:
    """``librosa.core.power_to_db``.  The ``top_db`` clamp takes the max over
    the last two axes (one spectrogram per leading index); ``valid_len``
    (an int or a tensor broadcastable to ``(..., 1, 1)``) keeps padded
    frames out of that max."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * float(np.log10(max(amin, ref_value)))
    if top_db is None:
        return log_spec
    masked = log_spec
    if valid_len is not None:
        t = torch.arange(S.shape[-1], device=S.device)
        valid = torch.as_tensor(valid_len, device=S.device)
        masked = torch.where(t < valid, log_spec,
                             torch.full_like(log_spec, -torch.inf))
    peak = masked.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(log_spec, peak - top_db)
