"""WAV input at 16 kHz mono and WAV output (counterpart of ``read_wav``,
``read_audio`` and ``write_wav`` in ``sm_hpss_mtl_tpu/data/audio.py``).

Files are read with ``scipy.io.wavfile`` and resampled with polyphase
filtering when their rate differs from 16 kHz.  mp3 input needs the codec
module (``data/codecs.py``), which is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

TARGET_SR = 16000


def _to_mono_sr(x: np.ndarray, sr: int, target_sr: int
                ) -> tuple[np.ndarray, int]:
    """Downmix to mono and polyphase-resample to ``target_sr``
    (``librosa.core.load(sr=16000, mono=True)`` semantics)."""
    if x.ndim > 1:
        x = x.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        x = resample_poly(x, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return np.ascontiguousarray(x, dtype=np.float32), sr


def read_wav(path: str, target_sr: int = TARGET_SR) -> tuple[np.ndarray, int]:
    """Load a wav as float32 mono at ``target_sr``."""
    sr, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2147483648.0
    elif x.dtype == np.uint8:
        x = (x.astype(np.float32) - 128.0) / 128.0
    else:
        x = x.astype(np.float32)
    return _to_mono_sr(x, sr, target_sr)


def read_audio(path: str, target_sr: int = TARGET_SR
               ) -> tuple[np.ndarray, int]:
    """Load an audio file as float32 mono at ``target_sr``: wav only.
    mp3 raises until the codec module is ported (ROADMAP §1, item 4)."""
    if os.path.splitext(path)[1].lower() == ".mp3":
        raise NotImplementedError(
            f"{path}: mp3 input needs data/codecs.py, not yet ported "
            "(ROADMAP §1, item 4); convert the file to wav")
    return read_wav(path, target_sr)


def write_wav(path: str, x: np.ndarray, sr: int = TARGET_SR) -> None:
    """Write ``x`` (float, nominally in [-1, 1]) as 16-bit PCM, clipped."""
    x = np.clip(x, -1.0, 1.0)
    wavfile.write(path, sr, (x * 32767.0).astype(np.int16))
