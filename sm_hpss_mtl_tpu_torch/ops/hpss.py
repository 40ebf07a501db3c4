"""Harmonic–percussive source separation: kernel K3 and its plain version.

Counterpart of ``sm_hpss_mtl_tpu/ops/hpss.py`` (the jnp oracle) and of
``ops/hpss_pallas.py::hpss`` / ``hpss_masks`` (the TPU kernel):
``librosa.decompose.hpss`` with kernel ``(l_harm, l_perc)``, margin 1 and
Wiener soft masks.  A width-``l_harm`` running median across time gives
the harmonic envelope, a width-``l_perc`` one across frequency the
percussive envelope.

:func:`hpss` and :func:`hpss_masks` take :func:`hpss_plain` /
:func:`hpss_masks_plain` for a CPU tensor and launch the hand-written
kernel of ``csrc/hpss.cu`` for a CUDA tensor; a CUDA call never falls
back.  Code that needs the plain version on any device (the plain
versions of the fused front end, which ``chip_smoke.py`` holds K1 and K2
to) calls the ``_plain`` functions by name.  The kernel is built with
``nvcc`` at its first launch, not at import.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _nvcc

#: (l_harm, l_perc) pairs the kernels K1, K2 and K3 are instantiated for:
#: the presets' (21, 11) and a narrow (11, 5).
KERNEL_MEDIANS = ((21, 11), (11, 5))

_SOURCE = "hpss.cu"

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


def hpss_masks_plain(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
                     power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive soft masks for ``(..., F, T)``."""
    harm = _sliding_median(S, l_harm, dim=-1)
    perc = _sliding_median(S, l_perc, dim=-2)
    return softmask(harm, perc, power), softmask(perc, harm, power)


def hpss_plain(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
               power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(H, P) = (S*mask_h, S*mask_p)`` for magnitudes ``(..., F, T)``."""
    mh, mp = hpss_masks_plain(S, l_harm=l_harm, l_perc=l_perc, power=power)
    S = S.to(torch.float32)
    return S * mh, S * mp


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_nvcc.build(_SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k3_hpss.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.k3_hpss.restype = i
    lib.k3_error_string.argtypes = [i]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _library()


def _launch(S: torch.Tensor, *, l_harm: int, l_perc: int, mask_only: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    if S.dtype != torch.float32:
        raise TypeError("hpss kernel takes float32 magnitudes")
    if (l_harm, l_perc) not in KERNEL_MEDIANS:
        raise ValueError(f"kernel supports (l_harm, l_perc) in "
                         f"{KERNEL_MEDIANS}, got {(l_harm, l_perc)}")
    if S.ndim < 2:
        raise ValueError(f"hpss takes (..., F, T), got {tuple(S.shape)}")
    lead, (F, T) = S.shape[:-2], S.shape[-2:]
    S3 = S.reshape(-1, F, T).contiguous()
    out_h = torch.empty_like(S3)
    out_p = torch.empty_like(S3)
    if S3.numel() == 0:
        return out_h.reshape(S.shape), out_p.reshape(S.shape)
    lib = _library()
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = lib.k3_hpss(S3.data_ptr(), out_h.data_ptr(), out_p.data_ptr(),
                          S3.shape[0], F, T, l_harm, l_perc, int(mask_only),
                          stream)
    if err != 0:
        raise RuntimeError("hpss kernel launch failed: "
                           + lib.k3_error_string(err).decode())
    (hpss_masks if mask_only else hpss).launches += 1
    return out_h.reshape(lead + (F, T)), out_p.reshape(lead + (F, T))


def _dispatch(S, *, l_harm, l_perc, power, mask_only):
    if S.device.type == "cpu":
        plain = hpss_masks_plain if mask_only else hpss_plain
        return plain(S, l_harm=l_harm, l_perc=l_perc, power=power)
    if S.device.type != "cuda":
        raise ValueError(f"hpss: unsupported device {S.device}")
    if power != 2.0:
        raise NotImplementedError(f"power={power!r}: only 2 is implemented")
    return _launch(S, l_harm=l_harm, l_perc=l_perc, mask_only=mask_only)


def hpss(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
         power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(H, P) = (S*mask_h, S*mask_p)`` for float32 magnitudes
    ``(..., F, T)``.  CPU tensors take :func:`hpss_plain`; CUDA tensors
    launch the kernel (power 2 only; each launch adds one to
    ``hpss.launches``)."""
    return _dispatch(S, l_harm=l_harm, l_perc=l_perc, power=power,
                     mask_only=False)


def hpss_masks(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
               power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive soft masks for float32 magnitudes
    ``(..., F, T)``.  CPU tensors take :func:`hpss_masks_plain`; CUDA
    tensors launch the kernel in its mask-only mode (each launch adds one
    to ``hpss_masks.launches``)."""
    return _dispatch(S, l_harm=l_harm, l_perc=l_perc, power=power,
                     mask_only=True)


#: Launches of the K3 kernel in this process, per mode (the plain versions
#: do not count).
hpss.launches = 0
hpss_masks.launches = 0
