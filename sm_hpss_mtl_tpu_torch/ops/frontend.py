"""Fused audio -> HPSS front end: kernels K1 and K2 and their plain versions.

Counterpart of ``sm_hpss_mtl_tpu/ops/frontend_pallas.py::stft_hpss_mel``
(K1) and ``::stft_hpss`` (K2).  For a CUDA tensor, :func:`stft_hpss_mel`
and :func:`stft_hpss` launch the hand-written kernel of
``csrc/frontend.cu`` (windowed rDFT magnitude, harmonic and percussive
medians and soft masks in one pass, then the mel projection for K1 or the
full-resolution masked magnitudes for K2; the spectrogram never reaches
device memory).  Clips shorter than ``2*(l_harm//2)`` frames take the
JAX package's short-clip branch (``frontend_pallas._dispatch``) instead:
the plain ``stft_mag``, then the spectral kernel K4 (``hpss.hpss_mel``)
or K3 (``hpss.hpss``).  For a CPU tensor they run
:func:`stft_hpss_mel_plain` / :func:`stft_hpss_plain`, the same chain in
plain PyTorch, which call the plain HPSS (``hpss.hpss_plain``) on every
device.  A CUDA call never falls back: if a kernel cannot be built or
launched, it raises.  :func:`launch` runs K1 or K2 at any length, without
the short-clip branch (``chip_smoke.py`` holds the kernels to their plain
versions through it).

The kernel is built with ``nvcc`` at its first launch, not at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _nvcc
from . import hpss as hpss_mod
from .hpss import KERNEL_MEDIANS, hpss_plain
from .stft import n_frames, stft_mag

_SOURCE = "frontend.cu"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_nvcc.build(_SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_stft_hpss_mel.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                     p]
    lib.k1_stft_hpss_mel.restype = i
    lib.k2_stft_hpss.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.k2_stft_hpss.restype = i
    lib.k1_error_string.argtypes = [i]
    lib.k1_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built at the
    first launch)."""
    _library()


def stft_hpss_mel_plain(y: torch.Tensor, mel_basis: torch.Tensor, *,
                        n_fft: int = 400, win_length: int = 400,
                        hop_length: int = 160, l_harm: int = 21,
                        l_perc: int = 11, power: float = 2.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """stft_mag -> hpss -> mel projection: ``(..., N)`` audio and an
    ``(n_mels, F)`` basis -> two ``(..., n_mels, T)`` maps."""
    H, P = stft_hpss_plain(y, n_fft=n_fft, win_length=win_length,
                           hop_length=hop_length, l_harm=l_harm,
                           l_perc=l_perc, power=power)
    M = mel_basis.to(device=H.device, dtype=torch.float32)
    return torch.matmul(M, H), torch.matmul(M, P)


def stft_hpss_plain(y: torch.Tensor, *, n_fft: int = 400,
                    win_length: int = 400, hop_length: int = 160,
                    l_harm: int = 21, l_perc: int = 11, power: float = 2.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """stft_mag -> hpss: ``(..., N)`` audio -> two ``(..., F, T)`` maps."""
    S = stft_mag(y, n_fft=n_fft, win_length=win_length, hop_length=hop_length)
    return hpss_plain(S, l_harm=l_harm, l_perc=l_perc, power=power)


def launch(y: torch.Tensor, M: torch.Tensor | None, *, n_fft: int,
           win_length: int, hop_length: int, l_harm: int, l_perc: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 with a mel basis ``M``; K2 (full resolution) with ``M=None``, on
    CUDA audio ``(..., N)`` of any length of at least one frame.  The
    dispatchers send clips under ``2*(l_harm//2)`` frames elsewhere; this
    launches the fused kernel whatever the length."""
    F = 1 + n_fft // 2
    if y.dtype != torch.float32:
        raise TypeError("frontend kernel takes float32 audio")
    if M is not None:
        if M.dtype != torch.float32:
            raise TypeError("stft_hpss_mel kernel takes a float32 basis")
        if M.device != y.device:
            raise ValueError("mel_basis must be on the audio's device")
        if M.ndim != 2 or M.shape[1] != F:
            raise ValueError(f"mel_basis must be (n_mels, {F}), "
                             f"got {tuple(M.shape)}")
    if (l_harm, l_perc) not in KERNEL_MEDIANS:
        raise ValueError(f"kernel supports (l_harm, l_perc) in "
                         f"{KERNEL_MEDIANS}, got {(l_harm, l_perc)}")
    if not win_length <= n_fft:
        raise ValueError("win_length must not exceed n_fft")
    lead, N = y.shape[:-1], y.shape[-1]
    T = n_frames(N, n_fft, hop_length)
    if T < 1:
        raise ValueError(f"{N} samples are shorter than one frame of {n_fft}")
    y2 = y.reshape(-1, N).contiguous()
    B = y2.shape[0]
    rows = F if M is None else M.shape[0]
    out_h = torch.empty((B, rows, T), dtype=torch.float32, device=y.device)
    out_p = torch.empty_like(out_h)
    shape = lead + (rows, T)
    if B == 0:
        return out_h.reshape(shape), out_p.reshape(shape)
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        if M is None:
            err = lib.k2_stft_hpss(
                y2.data_ptr(), out_h.data_ptr(), out_p.data_ptr(), B, N, T,
                n_fft, win_length, hop_length, l_harm, l_perc, stream)
        else:
            M = M.contiguous()
            err = lib.k1_stft_hpss_mel(
                y2.data_ptr(), M.data_ptr(), out_h.data_ptr(),
                out_p.data_ptr(), B, N, T, n_fft, win_length, hop_length,
                l_harm, l_perc, rows, stream)
    name = "stft_hpss" if M is None else "stft_hpss_mel"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.k1_error_string(err).decode())
    (stft_hpss if M is None else stft_hpss_mel).launches += 1
    return out_h.reshape(shape), out_p.reshape(shape)


def _dispatch(y: torch.Tensor, M: torch.Tensor | None, *, n_fft,
              win_length, hop_length, l_harm, l_perc):
    """The CUDA route of :func:`stft_hpss_mel` (``M`` given) and
    :func:`stft_hpss` (``M=None``): clips under ``2*(l_harm//2)`` frames go
    through ``stft_mag`` and K4 or K3, as ``frontend_pallas._dispatch``
    sends them to ``hpss_pallas``; longer ones launch K1 or K2."""
    T = n_frames(y.shape[-1], n_fft, hop_length)
    if 1 <= T < 2 * (l_harm // 2):
        S = stft_mag(y.to(torch.float32), n_fft=n_fft,
                     win_length=win_length, hop_length=hop_length)
        if M is None:
            return hpss_mod.hpss(S, l_harm=l_harm, l_perc=l_perc)
        return hpss_mod.hpss_mel(S, M, l_harm=l_harm, l_perc=l_perc)
    return launch(y, M, n_fft=n_fft, win_length=win_length,
                  hop_length=hop_length, l_harm=l_harm, l_perc=l_perc)


def _check_modes(power: float, dft_precision: str) -> None:
    if dft_precision != "highest":
        raise NotImplementedError(
            f"dft_precision={dft_precision!r}: only 'highest' (full float32) "
            "is implemented")
    if power != 2.0:
        raise NotImplementedError(f"power={power!r}: only 2 is implemented")


def stft_hpss_mel(y: torch.Tensor, mel_basis: torch.Tensor, *,
                  n_fft: int = 400, win_length: int = 400,
                  hop_length: int = 160, l_harm: int = 21, l_perc: int = 11,
                  power: float = 2.0, dft_precision: str = "highest"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Audio ``(..., N)`` -> ``(mel(H), mel(P))``, each ``(..., n_mels, T)``.

    ``mel_basis`` is ``(n_mels, F)``.  The kernel's DFT is full float32,
    the JAX package's ``dft_precision='highest'``; ``'bf16x3'`` has no
    counterpart yet and raises.  The kernel's masks are squared (``power``
    2, what every feature family uses); another power raises.  CPU tensors
    take the plain version; CUDA tensors launch K1 (each launch adds one to
    ``stft_hpss_mel.launches``), or for clips under ``2*(l_harm//2)``
    frames the plain ``stft_mag`` and K4."""
    _check_modes(power, dft_precision)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
              l_harm=l_harm, l_perc=l_perc)
    if y.device.type == "cpu":
        return stft_hpss_mel_plain(y, mel_basis, **kw)
    if y.device.type == "cuda":
        return _dispatch(y, mel_basis, **kw)
    raise ValueError(f"stft_hpss_mel: unsupported device {y.device}")


def stft_hpss(y: torch.Tensor, *, n_fft: int = 400, win_length: int = 400,
              hop_length: int = 160, l_harm: int = 21, l_perc: int = 11,
              power: float = 2.0, dft_precision: str = "highest"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Audio ``(..., N)`` -> full-resolution ``(H, P)`` masked magnitudes,
    each ``(..., F, T)``: the HarmSpec/PercSpec feature families.

    Modes as in :func:`stft_hpss_mel`.  CPU tensors take the plain version;
    CUDA tensors launch K2 (each launch adds one to
    ``stft_hpss.launches``), or for clips under ``2*(l_harm//2)`` frames
    the plain ``stft_mag`` and K3."""
    _check_modes(power, dft_precision)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
              l_harm=l_harm, l_perc=l_perc)
    if y.device.type == "cpu":
        return stft_hpss_plain(y, **kw)
    if y.device.type == "cuda":
        return _dispatch(y, None, **kw)
    raise ValueError(f"stft_hpss: unsupported device {y.device}")


#: Launches of the K1 and K2 kernels in this process (the plain versions
#: do not count).
stft_hpss_mel.launches = 0
stft_hpss.launches = 0
