"""Numpy helpers of the DSP front end: the Hann window, the Slaney mel
filterbank, framing and RMS energy, as librosa defines them.

A copy of the helpers of ``sm_hpss_mtl_tpu/ops/reference.py`` that the port
needs (the port imports nothing of the JAX package); the tests hold each
copy to its original.
"""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window, scipy ``get_window('hann', N)``."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` samples."""
    n = len(window)
    if size < n:
        raise ValueError(f"size {size} < window length {n}")
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + n] = window
    return out


def hz_to_mel(freq, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    return np.where(
        log_t,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels)


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float,
                    htk: bool = False) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                                 n_mels), htk)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney") -> np.ndarray:
    """Slaney-style triangular mel filterbank, shape ``(n_mels, 1+n_fft//2)``."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int
                 ) -> np.ndarray:
    """Non-centered framing: frame ``t`` is
    ``y[t*hop : t*hop+frame_length]``.  Returns shape
    ``(frame_length, n_frames)`` (librosa column layout)."""
    n_frames = 1 + (len(y) - frame_length) // hop_length
    if n_frames < 1:
        raise ValueError(f"signal of {len(y)} samples too short for "
                         f"frame_length={frame_length}")
    idx = (np.arange(frame_length)[:, None]
           + hop_length * np.arange(n_frames)[None, :])
    return y[idx]


def rms_energy(y: np.ndarray, frame_length: int, hop_length: int
               ) -> np.ndarray:
    """``librosa.feature.rms(y, frame_length, hop_length)`` with the default
    ``center=True`` reflect padding; returns 1-D ``(n_frames,)``."""
    y = np.asarray(y, dtype=np.float64)
    y = np.pad(y, frame_length // 2, mode="reflect")
    frames = frame_signal(y, frame_length, hop_length)
    return np.sqrt(np.mean(frames ** 2, axis=0))
