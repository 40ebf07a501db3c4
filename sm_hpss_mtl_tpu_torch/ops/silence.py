"""RMS-energy silence removal on the host (a numpy copy of
``sm_hpss_mtl_tpu/ops/silence.py``).

Semantics follow the reference's ``removeSilence``: frames whose RMS
energy falls below ``alpha * max(energy)`` are marked silent, the marker is
smoothed with a 5-tap median, and only silent segments longer than
``beta`` seconds are cut.  Segment bounds use the reference's arithmetic
(``k = max(shift*(i-1)+size, 1)``, ``l = min(shift*(j-1)+size, n)``),
including its rule that a lone silent segment is kept (nothing is removed
unless more than one segment qualifies).  As in the JAX package, only the
retained samples are returned (the reference returns a full-length buffer
with a tail of ones), and the silent time is in float seconds.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import medfilt


def frame_markers(energy: np.ndarray, alpha: float = 0.025) -> np.ndarray:
    """Threshold and 5-tap median smoothing -> per-frame voiced (1) or
    silent (0)."""
    thresh = alpha * np.max(energy)
    marker = (energy >= thresh).astype(np.int64)
    return (medfilt(marker.astype(np.float64), 5) > 0.5).astype(np.int64)


def silent_segments(marker: np.ndarray, n_samples: int, fs: int,
                    frame_size: int, frame_shift: int,
                    beta: float = 0.075) -> list[tuple[int, int]]:
    """Sample spans ``[k, l)`` of the silent segments longer than ``beta``
    seconds, by the reference's run-length scan."""
    n_frames = len(marker)
    segments: list[tuple[int, int]] = []
    i = 0
    while i < n_frames:
        while marker[i] == 1:
            if i == n_frames - 1:
                break
            i += 1
        j = i
        while marker[j] == 0:
            if j == n_frames - 1:
                break
            j += 1
        k = max(frame_shift * (i - 1) + frame_size, 1)
        l = min(frame_shift * (j - 1) + frame_size, n_samples)
        if (l - k) / fs > beta:
            segments.append((k, l))
        i = j + 1
    return segments


def remove_silence(x: np.ndarray, energy: np.ndarray, fs: int,
                   Tw: int = 25, Ts: int = 10,
                   alpha: float = 0.025, beta: float = 0.075):
    """Silence removal with the reference's semantics; ``energy`` is the
    per-frame RMS (``ops.reference.rms_energy``), ``Tw``/``Ts`` in ms.

    Returns ``(x_out, sample_marker, frame_marker, total_sil_seconds)``."""
    frame_size = int(Tw * fs / 1000)
    frame_shift = int(Ts * fs / 1000)
    n = len(x)
    marker = frame_markers(np.asarray(energy), alpha)
    segments = silent_segments(marker, n, fs, frame_size, frame_shift, beta)

    sample_marker = np.ones(n, dtype=np.int64)
    total = 0.0
    for k, l in segments:
        sample_marker[k:l] = 0
        total += (l - k) / fs
    x_out = x[sample_marker == 1] if len(segments) > 1 else x
    return x_out, sample_marker, marker, total
