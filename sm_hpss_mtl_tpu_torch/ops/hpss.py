"""Harmonic–percussive source separation: kernels K3 and K4 and their plain
versions.

Counterpart of ``sm_hpss_mtl_tpu/ops/hpss.py`` (the jnp oracle) and of
``ops/hpss_pallas.py::hpss`` / ``hpss_masks`` (K3) and ``hpss_mel`` (K4),
the TPU kernels: ``librosa.decompose.hpss`` with kernel ``(l_harm,
l_perc)``, margin 1 and Wiener soft masks.  A width-``l_harm`` running
median across time gives the harmonic envelope, a width-``l_perc`` one
across frequency the percussive envelope; K4 adds the mel projection of
both components.

:func:`hpss`, :func:`hpss_masks` and :func:`hpss_mel` take
:func:`hpss_plain`, :func:`hpss_masks_plain` / :func:`hpss_mel_plain` for a
CPU tensor and launch the hand-written kernels of ``csrc/hpss.cu`` for a
CUDA tensor, at any ``power`` (a kernel argument: 2 squares, any other
goes through ``powf``) and any odd median pair of widths 3 to 61; a CUDA
call never falls back.  Code that needs the plain version on any device
(the plain versions of the fused front end, which ``chip_smoke.py`` holds
K1 and K2 to) calls the ``_plain`` functions by name.  The kernels are
built with ``nvcc`` at their first launch, not at import.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _nvcc
from .median_networks import check_pair
from .mel import _band_ranges_of
from .stft import real_dtype
from ..utils.profiling import count

#: (l_harm, l_perc) pairs whose median networks ``csrc/median.cuh`` holds
#: and ``chip_smoke.py`` times per pair: the presets' (21, 11), a narrow
#: (11, 5), and the tuner's grids (``cli/tune.py::GRID_RANGES``): l_harm 11
#: to 51 at l_perc 11, l_perc 21 to 51 at l_harm 21.  The kernels K1 to K4
#: take any other odd pair of widths 3 to 61 too
#: (``median_networks.check_pair``), its networks generated at its first
#: build.  Each pair is a library of its own (``_nvcc.build``), built at its
#: first launch.
KERNEL_MEDIANS = ((21, 11), (11, 5), (11, 11), (31, 11), (41, 11),
                  (51, 11), (21, 21), (21, 31), (21, 41), (21, 51))

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
    ``max(X, X_ref)``; where both are below float32 ``tiny`` the mask is 0.
    Float32, or float64 for float64 inputs."""
    dtype = real_dtype(X)
    X = X.to(dtype)
    X_ref = X_ref.to(dtype)
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
    S = S.to(real_dtype(S))
    return S * mh, S * mp


def hpss_from_extended(S_ext: torch.Tensor, *, l_harm: int = 21,
                       l_perc: int = 11, power: float = 2.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hpss_plain` of ``(..., F, T + 2*(l_harm//2))`` magnitudes whose
    time axis already carries ``l_harm//2`` frames of context on each side
    (a neighbour's frames or a mirror): ``(H, P)`` of the ``T`` centre
    frames.  The harmonic median reads the context as it is; the
    percussive one is over the centre frames' bins, symmetric as usual."""
    ht = l_harm // 2
    T = S_ext.shape[-1] - 2 * ht
    harm = S_ext.unfold(-1, l_harm, 1).median(dim=-1).values
    S = S_ext[..., ht:ht + T]
    perc = _sliding_median(S, l_perc, dim=-2)
    mh, mp = softmask(harm, perc, power), softmask(perc, harm, power)
    S = S.to(real_dtype(S))
    return S * mh, S * mp


def hpss_mel_plain(S: torch.Tensor, mel_basis: torch.Tensor, *,
                   l_harm: int = 21, l_perc: int = 11, power: float = 2.0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mel(H), mel(P))``, each ``(..., n_mels, T)``, for magnitudes
    ``(..., F, T)`` and an ``(n_mels, F)`` basis: :func:`hpss_plain`, then
    a float32 product with the basis."""
    H, P = hpss_plain(S, l_harm=l_harm, l_perc=l_perc, power=power)
    M = mel_basis.to(device=H.device, dtype=torch.float32)
    return torch.matmul(M, H), torch.matmul(M, P)


def build() -> None:
    """Build and load the kernel library of every pair of
    ``KERNEL_MEDIANS`` now (each is otherwise built at its first
    launch)."""
    for pair in KERNEL_MEDIANS:
        _nvcc.load(_SOURCE, pair)


def blocks_per_sm(*, mel: bool, l_harm: int = 21, l_perc: int = 11) -> int:
    """Blocks of K4 (``mel``) or K3 (at its largest tile) one SM of the
    current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _nvcc.occupancy(_SOURCE, "k4_blocks_per_sm" if mel
                           else "k3_blocks_per_sm", l_harm, l_perc,
                           pair=(l_harm, l_perc))


def _as_3d(S: torch.Tensor) -> torch.Tensor:
    """``(..., F, T)`` as a contiguous ``(B, F, T)``, without a call for a
    tensor that already is one."""
    if S.ndim == 3 and S.is_contiguous():
        return S
    return S.reshape(-1, *S.shape[-2:]).contiguous()


def _check_input(S: torch.Tensor, l_harm: int, l_perc: int) -> None:
    if S.dtype != torch.float32:
        raise TypeError("hpss kernel takes float32 magnitudes")
    check_pair(l_harm, l_perc)
    if S.ndim < 2:
        raise ValueError(f"hpss takes (..., F, T), got {tuple(S.shape)}")


def _count(name: str, l_harm: int, l_perc: int, power: float) -> None:
    """One launch in the counters ``<name>.launches``,
    ``<name>.launches_by_pair.<l_harm>,<l_perc>`` and
    ``<name>.launches_by_power.<float power>``."""
    count(f"{name}.launches")
    count(f"{name}.launches_by_pair.{l_harm},{l_perc}")
    count(f"{name}.launches_by_power.{float(power)}")


def _launch(S: torch.Tensor, *, l_harm: int, l_perc: int,
            power: float = 2.0, mask_only: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on ``(..., F, T)`` magnitudes (the masks alone with
    ``mask_only``).  The host path is kept short (the
    kernel takes a few microseconds at the short-clip shapes): no reshape
    of a 3-D input or of its outputs, and two ``empty_like`` (cheaper than
    one allocation split in two)."""
    _check_input(S, l_harm, l_perc)
    S3 = _as_3d(S)
    out_h, out_p = torch.empty_like(S3), torch.empty_like(S3)
    if S3.numel():
        _nvcc.launch(_SOURCE, "k3_hpss", S.device, S3.data_ptr(),
                     out_h.data_ptr(), out_p.data_ptr(), *S3.shape, l_harm,
                     l_perc, int(mask_only), power, pair=(l_harm, l_perc),
                     name="hpss")
        _count("hpss_masks" if mask_only else "hpss", l_harm, l_perc, power)
    if S3 is S:
        return out_h, out_p
    return out_h.reshape(S.shape), out_p.reshape(S.shape)


def _launch_mel(S: torch.Tensor, M: torch.Tensor, *, l_harm: int,
                l_perc: int, power: float = 2.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 on ``(..., F, T)`` magnitudes and an ``(n_mels, F)`` basis; the
    basis's band ranges are kept per basis tensor (``mel._band_ranges_of``),
    so a reused basis costs no extra work per launch."""
    _check_input(S, l_harm, l_perc)
    F, T = S.shape[-2:]
    if M.dtype != torch.float32:
        raise TypeError("hpss_mel kernel takes a float32 basis")
    if M.device != S.device:
        raise ValueError("mel_basis must be on the magnitudes' device")
    if M.ndim != 2 or M.shape[1] != F:
        raise ValueError(f"mel_basis must be (n_mels, {F}), "
                         f"got {tuple(M.shape)}")
    n_mels = M.shape[0]
    S3 = _as_3d(S)
    out_h = S3.new_empty((S3.shape[0], n_mels, T))
    out_p = S3.new_empty((S3.shape[0], n_mels, T))
    if S3.numel() and n_mels:
        M = M.contiguous()
        _nvcc.launch(_SOURCE, "k4_hpss_mel", S.device, S3.data_ptr(),
                     M.data_ptr(), _band_ranges_of(M).data_ptr(),
                     out_h.data_ptr(), out_p.data_ptr(), S3.shape[0], F, T,
                     l_harm, l_perc, n_mels, power, pair=(l_harm, l_perc),
                     name="hpss_mel", detail=lambda: (
                         f" (F={F}, l_harm={l_harm}, l_perc={l_perc})"))
        _count("hpss_mel", l_harm, l_perc, power)
    if S3 is S:
        return out_h, out_p
    shape = S.shape[:-2] + (n_mels, T)
    return out_h.reshape(shape), out_p.reshape(shape)


_launch_masks = functools.partial(_launch, mask_only=True)


def hpss(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
         power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(H, P) = (S*mask_h, S*mask_p)`` for float32 magnitudes
    ``(..., F, T)``.  CPU tensors take :func:`hpss_plain`; CUDA tensors
    launch the kernel at ``power`` (each launch adds one to the counters
    ``hpss.launches`` and ``hpss.launches_by_*`` of
    ``utils.profiling.counters()``, as :func:`_count` names them)."""
    run = _launch if _nvcc.on_card("hpss", S) else hpss_plain
    return run(S, l_harm=l_harm, l_perc=l_perc, power=power)


def hpss_masks(S: torch.Tensor, *, l_harm: int = 21, l_perc: int = 11,
               power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive soft masks for float32 magnitudes
    ``(..., F, T)``.  CPU tensors take :func:`hpss_masks_plain`; CUDA
    tensors launch the kernel in its mask-only mode (each launch adds one
    to the counters ``hpss_masks.launches`` and
    ``hpss_masks.launches_by_*``)."""
    run = _launch_masks if _nvcc.on_card("hpss", S) else hpss_masks_plain
    return run(S, l_harm=l_harm, l_perc=l_perc, power=power)


def hpss_mel(S: torch.Tensor, mel_basis: torch.Tensor, *, l_harm: int = 21,
             l_perc: int = 11, power: float = 2.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mel(H), mel(P))``, each ``(..., n_mels, T)``, for float32
    magnitudes ``(..., F, T)`` and an ``(n_mels, F)`` basis.  CPU tensors
    take :func:`hpss_mel_plain`; CUDA tensors launch kernel K4 at ``power``
    (each launch adds one to the counters ``hpss_mel.launches`` and
    ``hpss_mel.launches_by_*``)."""
    run = _launch_mel if _nvcc.on_card("hpss_mel", S) else hpss_mel_plain
    return run(S, mel_basis, l_harm=l_harm, l_perc=l_perc, power=power)

