"""The HPSS feature front end in plain PyTorch and NumPy.

librosa's definitions, written out: a periodic Hann window centred in
``n_fft``, frames without centre padding, the magnitude of the real FFT
(the windowed DFT as a matrix product), ``librosa.decompose.hpss`` with margin 1 and Wiener
soft masks of power 2 (a running median of ``l_harm`` frames across time
and of ``l_perc`` bins across frequency, both with symmetric edges), the
Slaney mel bank, and ``power_to_db`` with an 80 dB floor per component.
The HPSS families of the original system build their mel bank at
librosa's default rate of 22050 Hz although the audio is 16 kHz; that is
kept, as it is part of what the system computes.

Long recordings run in blocks of frames so that the medians fit in device
memory; a block reads its neighbours' frames, so the result does not
depend on the block size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: Frames per block of the medians (memory only; the result is the same).
BLOCK_FRAMES = 8192


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (scipy's ``get_window('hann', N)``)."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def window_in_fft(win_length: int, n_fft: int) -> np.ndarray:
    """The window zero-padded symmetrically to ``n_fft`` samples."""
    out = np.zeros(n_fft)
    lpad = (n_fft - win_length) // 2
    out[lpad:lpad + win_length] = hann_window(win_length)
    return out


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp
                    + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa's Slaney-normalised triangular mel bank over 0..sr/2,
    ``(n_mels, 1 + n_fft // 2)`` float64."""
    fft_hz = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                    n_mels + 2))
    fdiff = np.diff(mel_hz)
    ramps = mel_hz[:, None] - fft_hz[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (mel_hz[2:] - mel_hz[:-2]))[:, None]


def n_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    return 1 + (n_samples - n_fft) // hop_length


def dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """The windowed real DFT as a matrix ``(n_fft, 2F)``: cosines, then
    negated sines, in float64."""
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * np.arange(1 + n_fft // 2)[None, :] / n_fft
    return (np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
            * window_in_fft(win_length, n_fft)[:, None])


def stft_mag(y: torch.Tensor, *, n_fft: int, win_length: int,
             hop_length: int) -> torch.Tensor:
    """``(B, N)`` audio -> ``(B, F, T)`` magnitudes, in the audio's dtype:
    the frames times the DFT matrix (a matrix product, so a lower
    precision of products, such as TF32, reaches it as it reaches the
    model)."""
    F = 1 + n_fft // 2
    basis = torch.as_tensor(dft_basis(n_fft, win_length), dtype=y.dtype,
                            device=y.device)
    reim = y.unfold(-1, n_fft, hop_length) @ basis
    return torch.sqrt(reim[..., :F] ** 2 + reim[..., F:] ** 2) \
        .transpose(-1, -2)


def _symmetric(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``mode='symmetric'`` padding as an index map."""
    r = torch.remainder(idx, 2 * n)
    return torch.where(r < n, r, 2 * n - 1 - r)


def _median(S: torch.Tensor, width: int, dim: int, lo: int, hi: int
            ) -> torch.Tensor:
    """Running median of odd ``width`` along ``dim`` (symmetric edges) at
    positions ``[lo, hi)`` of that axis."""
    half = width // 2
    idx = _symmetric(torch.arange(lo - half, hi + half, device=S.device),
                     S.shape[dim])
    return S.index_select(dim, idx).unfold(dim, width, 1).median(-1).values


def _softmask(X: torch.Tensor, X_ref: torch.Tensor) -> torch.Tensor:
    """librosa's ``softmask(X, X_ref, power=2, split_zeros=False)``."""
    Z = torch.maximum(X, X_ref)
    tiny = torch.finfo(X.dtype).tiny
    bad = Z < tiny
    Zs = torch.where(bad, torch.ones_like(Z), Z)
    m, r = (X / Zs) ** 2, (X_ref / Zs) ** 2
    return torch.where(bad, torch.zeros_like(Z),
                       m / torch.where(bad, torch.ones_like(Z), m + r))


def hpss(S: torch.Tensor, l_harm: int, l_perc: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, F, T)`` magnitudes -> harmonic and percussive components."""
    T = S.shape[-1]
    H, P = [], []
    for t0 in range(0, T, BLOCK_FRAMES):
        t1 = min(T, t0 + BLOCK_FRAMES)
        harm = _median(S, l_harm, -1, t0, t1)
        block = S[..., t0:t1]
        perc = _median(block, l_perc, -2, 0, block.shape[-2])
        H.append(block * _softmask(harm, perc))
        P.append(block * _softmask(perc, harm))
    return torch.cat(H, -1), torch.cat(P, -1)


def power_to_db(S: torch.Tensor, top_db: float = 80.0,
                valid_frames: int | None = None) -> torch.Tensor:
    """``librosa.power_to_db(S, ref=1, amin=1e-10, top_db)`` per leading
    index, the floor taken from the first ``valid_frames`` frames."""
    db = 10.0 * torch.log10(torch.clamp(S, min=1e-10))
    peak_of = db if valid_frames is None else db[..., :valid_frames]
    peak = peak_of.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(db, peak - top_db)


def featuregram(y: torch.Tensor, feat: dict,
                valid_frames: int | None = None) -> torch.Tensor:
    """``(B, N)`` audio -> ``(B, D, T)`` features of a log HPSS family:
    ``[dB(H); dB(P)]`` of the masked magnitudes, or of their mel
    projections where ``feat['n_mels']`` is set, each component floored
    by its own peak."""
    S = stft_mag(y, n_fft=feat["n_fft"], win_length=feat["win_length"],
                 hop_length=feat["hop_length"])
    H, P = hpss(S, feat["l_harm"], feat["l_perc"])
    if feat.get("n_mels"):
        M = torch.as_tensor(mel_filterbank(feat["mel_sr"], feat["n_fft"],
                                           feat["n_mels"]),
                            dtype=S.dtype, device=S.device)
        H, P = M @ H, M @ P
    return torch.cat([power_to_db(H ** 2, feat["top_db"], valid_frames),
                      power_to_db(P ** 2, feat["top_db"], valid_frames)],
                     dim=-2)


def standardize_rows(fv: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``StandardScaler().fit_transform(fv.T).T`` per row
    over the last axis: statistics in float64, and a row scikit-learn
    finds constant (a variance within the round-off bound of its two-pass
    algorithm, ``_is_constant_feature``) centred at scale 1.  A row of one
    repeated value has a float64 mean an ulp off that value on some
    devices, and a variance of ~1e-28 that is not 0: without the bound it
    would standardize to +-1 throughout."""
    x = fv.double()
    n = x.shape[-1]
    eps = torch.finfo(torch.float64).eps
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = torch.where(constant, torch.ones_like(var), var.sqrt())
    return ((x - mean) / scale).to(fv.dtype)


def standardize_halves(fv: torch.Tensor) -> torch.Tensor:
    """Row standardization per HPSS component (the two halves of the
    rows)."""
    h = fv.shape[-2] // 2
    return torch.cat([standardize_rows(fv[..., :h, :]),
                      standardize_rows(fv[..., h:, :])], dim=-2)


def patch_starts(T: int, patch_size: int, patch_shift: int) -> list[int]:
    """The original system's windows over ``T`` frames: centred at
    ``range(W//2, T - W//2, shift)`` (``T`` longer than one window)."""
    half = patch_size // 2
    return [c - half for c in range(half, T - half, patch_shift)]
