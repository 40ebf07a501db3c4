"""Audio I/O, the reference's load chain, and a synthetic toy corpus
(counterpart of ``sm_hpss_mtl_tpu/data/audio.py``).

wav files are read with ``scipy.io.wavfile``, mp3 files decoded by
``data/codecs.py`` (the system libmpg123), and both resampled with
polyphase filtering when their rate differs from 16 kHz.
:func:`load_and_preprocess_signal` is the reference's chain (normalize,
RMS-gated silence removal, tile to at least 100 ms, normalize), with the
silence rule in the native host kernels (``native/kernels.cpp``, as in
the JAX package; ``ops/silence.py`` is its numpy twin).
:func:`make_toy_musan` writes a miniature MUSAN-shaped corpus (wavs and
annotation CSVs) for the folds, the featurizer and the file-wise tester.
"""

from __future__ import annotations

import csv
import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import lfilter, resample_poly

from .. import native
from ..ops import reference as ref
from ..ops.mixing import normalize_signal_np
from ..utils.profiling import span

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


def _is_mp3(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".mp3"


def read_audio(path: str, target_sr: int = TARGET_SR
               ) -> tuple[np.ndarray, int]:
    """Load an audio file as float32 mono at ``target_sr``: wav natively,
    mp3 through libmpg123 (``data/codecs.py``).  The span ``audio.read``
    counts the samples returned."""
    with span("audio.read") as s:
        if _is_mp3(path):
            from .codecs import read_mp3
            x, sr = _to_mono_sr(*read_mp3(path), target_sr)
        else:
            x, sr = read_wav(path, target_sr)
        s.n = len(x)
    return x, sr


def write_wav(path: str, x: np.ndarray, sr: int = TARGET_SR) -> None:
    """Write ``x`` (float, nominally in [-1, 1]) as 16-bit PCM, clipped."""
    x = np.clip(x, -1.0, 1.0)
    wavfile.write(path, sr, (x * 32767.0).astype(np.int16))


def duration_seconds(path: str) -> float:
    """Length of a wav or mp3 file in seconds (an mp3's from a header
    scan, without a full decode)."""
    if _is_mp3(path):
        from .codecs import mp3_duration_seconds
        return mp3_duration_seconds(path)
    sr, x = wavfile.read(path, mmap=True)
    return x.shape[0] / sr


def load_and_preprocess_signal(path: str, Tw: int = 25, Ts: int = 10
                               ) -> tuple[np.ndarray, int]:
    """The reference's load chain: normalize -> silence removal -> tile to
    at least 100 ms -> normalize."""
    x, fs = read_audio(path)
    x = normalize_signal_np(x).astype(np.float32)
    frame_size = int(Tw * fs / 1000)
    frame_shift = int(Ts * fs / 1000)
    energy = ref.rms_energy(x, frame_size, frame_shift)
    x, _, _, _ = native.remove_silence(x, energy, fs, Tw, Ts)
    while len(x) / fs < 0.1:
        x = np.append(x, x)
    return normalize_signal_np(x).astype(np.float32), fs


# ---------------------------------------------------------------------------
# Synthetic toy corpus
# ---------------------------------------------------------------------------

_GENRES = ("jazz", "rock", "classical")
_GENDERS = ("f", "m")


def _synth_music(rng, n, fs):
    """Chord progression: stacked harmonics with slow envelopes."""
    t = np.arange(n) / fs
    roots = rng.choice([220.0, 246.9, 293.7, 329.6], size=4)
    x = np.zeros(n)
    seg = n // len(roots)
    for i, f0 in enumerate(roots):
        sl = slice(i * seg, (i + 1) * seg if i < len(roots) - 1 else n)
        tt = t[sl]
        for mult, amp in [(1, 1.0), (1.5, 0.6), (2, 0.5), (3, 0.25)]:
            x[sl] += amp * np.sin(2 * np.pi * f0 * mult * tt
                                  + rng.uniform(0, 2 * np.pi))
    x *= 0.2 + 0.1 * np.sin(2 * np.pi * 0.5 * t)
    return x


def _synth_speech(rng, n, fs):
    """Formant-filtered pulse train with syllabic gaps and pitch wobble."""
    t = np.arange(n) / fs
    f0 = 120 + 40 * np.sin(2 * np.pi * 2.3 * t) + rng.uniform(-10, 10)
    phase = np.cumsum(f0) / fs
    glottal = (np.sign(np.sin(2 * np.pi * phase))
               * np.sin(2 * np.pi * phase) ** 2)
    env = np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.4, 0, None)
    x = glottal * env + 0.02 * rng.standard_normal(n)
    for fc in (700.0, 1900.0):
        r = np.exp(-2 * np.pi * 150 / fs)
        theta = 2 * np.pi * fc / fs
        x = lfilter([1.0], [1.0, -2 * r * np.cos(theta), r ** 2], x)
    return x


def _synth_noise(rng, n, fs):
    return lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))  # pink-ish


def make_toy_musan(root: str, *, n_per_class: int = 6,
                   duration_s: float | tuple = 3.0, fs: int = TARGET_SR,
                   with_noise: bool = False, seed: int = 0,
                   only: tuple | None = None) -> str:
    """Create ``root/{music,speech[,noise]}/*.wav`` and
    ``root/annotations/<class>.csv`` in the MUSAN layout that ``data.folds``
    reads.  Returns ``root``.

    ``duration_s`` may be a (lo, hi) tuple for per-file uniform random
    durations.  ``only`` restricts generation to a subset of the class
    names, so that classes can be made with their own counts, durations
    and seeds (``tools/scale_rehearsal_torch.py``)."""
    rng = np.random.default_rng(seed)
    classes = {"music": _synth_music, "speech": _synth_speech}
    if with_noise:
        classes["noise"] = _synth_noise
    if only is not None:
        classes = {k: v for k, v in classes.items() if k in only}
    annot_dir = os.path.join(root, "annotations")
    os.makedirs(annot_dir, exist_ok=True)
    for cls, synth in classes.items():
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        rows = []
        for i in range(n_per_class):
            name = f"{cls}-toy-{i:04d}"
            if isinstance(duration_s, tuple):
                n = int(rng.uniform(*duration_s) * fs)
            else:
                n = int(duration_s * fs)
            x = normalize_signal_np(synth(rng, n, fs))
            write_wav(os.path.join(root, cls, name + ".wav"), x, fs)
            if cls == "music":
                attr = _GENRES[i % len(_GENRES)]
            elif cls == "speech":
                attr = _GENDERS[i % len(_GENDERS)]
            else:
                attr = "ambient"
            rows.append([name, attr])
        with open(os.path.join(annot_dir, cls + ".csv"), "w",
                  newline="") as f:
            csv.writer(f).writerows(rows)
    return root
