"""Signal normalization and SMR-controlled speech+music mixing on the host.

Counterpart of ``normalize_signal_np`` and ``mix_signals_np`` of
``sm_hpss_mtl_tpu/ops/mixing.py`` (the reference's ``normalize_signal`` and
``mix_signals``): music is tiled to at least speech length, scaled so its
energy sits ``target_dB`` below the speech energy, the gains are normalized
to sum to 1, and the mixture is re-normalized (zero mean, unit peak).
"""

from __future__ import annotations

import numpy as np


def normalize_signal_np(x: np.ndarray) -> np.ndarray:
    """Zero mean, unit peak."""
    x = x - np.mean(x)
    return x / np.max(np.abs(x))


def mix_signals_np(sp: np.ndarray, mu: np.ndarray,
                   target_dB: float) -> np.ndarray:
    """Mix speech ``sp`` and music ``mu`` at a speech-to-music ratio of
    ``target_dB``, with the reference's tiling rule."""
    mu_t = mu.copy()
    while len(mu_t) < len(sp):
        mu_t = np.append(mu_t, mu)
    n = min(len(sp), len(mu_t))
    sp = sp[:n]
    mu_t = mu_t[:n]

    e_sp = np.sum(sp ** 2) / len(sp)
    e_mu = np.sum(mu_t ** 2) / len(mu_t)
    req_e_mu = e_sp / (10.0 ** (target_dB / 10.0))
    g_mu = np.sqrt(req_e_mu / e_mu)
    g_sp = 1.0
    s = g_mu + g_sp
    mix = (g_sp / s) * sp + (g_mu / s) * mu_t
    return normalize_signal_np(mix)
