"""Harmonic–percussive source separation in plain PyTorch.

Counterpart of ``sm_hpss_mtl_tpu/ops/hpss.py``: ``librosa.decompose.hpss``
with kernel ``(l_harm, l_perc)``, margin 1 and Wiener soft masks.  A
width-``l_harm`` running median across time gives the harmonic envelope,
a width-``l_perc`` one across frequency the percussive envelope.
"""

from __future__ import annotations

import numpy as np
import torch

_F32_TINY = float(np.finfo(np.float32).tiny)


def symmetric_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy ``mode='symmetric'`` padding as an index map, repeated with
    period ``2n`` when the pad is wider than the axis.  This is not
    torch's ``'reflect'``, which leaves the edge sample out."""
    r = torch.remainder(idx, 2 * n)
    return torch.where(r < n, r, 2 * n - 1 - r)


def _sliding_median(S: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """Running median of odd ``width`` along ``dim`` with symmetric edges
    (scipy.ndimage ``median_filter(mode='reflect')``)."""
    dim = dim % S.ndim
    n = S.shape[dim]
    half = width // 2
    idx = symmetric_index(torch.arange(-half, n + half, device=S.device), n)
    windows = S.index_select(dim, idx).unfold(dim, width, 1)
    return windows.median(dim=-1).values


def softmask(X: torch.Tensor, X_ref: torch.Tensor,
             power: float = 2.0) -> torch.Tensor:
    """``librosa.util.softmask`` with ``split_zeros=False``: normalised by
    ``max(X, X_ref)``; where both are below float32 ``tiny`` the mask is 0."""
    X = X.to(torch.float32)
    X_ref = X_ref.to(torch.float32)
    Z = torch.maximum(X, X_ref)
    bad = Z < _F32_TINY
    Zs = torch.where(bad, torch.ones_like(Z), Z)
    m = (X / Zs) ** power
    r = (X_ref / Zs) ** power
    denom = torch.where(bad, torch.ones_like(Z), m + r)
    return torch.where(bad, torch.zeros_like(Z), m / denom)


def hpss_masks(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
               power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive soft masks for ``(..., F, T)``."""
    harm = _sliding_median(S, l_harm, dim=-1)
    perc = _sliding_median(S, l_perc, dim=-2)
    return softmask(harm, perc, power), softmask(perc, harm, power)


def hpss(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
         power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(H, P) = (S*mask_h, S*mask_p)`` for magnitudes ``(..., F, T)``."""
    mh, mp = hpss_masks(S, l_harm=l_harm, l_perc=l_perc, power=power)
    S = S.to(torch.float32)
    return S * mh, S * mp
