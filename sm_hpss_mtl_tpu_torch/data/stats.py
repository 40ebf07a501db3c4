"""Corpus-level feature statistics for frame-level scaling (counterpart of
``sm_hpss_mtl_tpu/data/stats.py``).

The reference's ``get_data_stats``: two passes over every training
featuregram, per-class frame sums for the mean (the classes averaged with
equal weight, not by frame count), then squared deviations for the stdev
with ``n - 1``.  Sums are ``np.longdouble``, as in the JAX package (the
reference's float128).  The featuregrams come from the port's
``Featurizer``, so on CUDA each training file is one launch of K1 or K2.
The per-fold ``(mean, stdev)`` pair feeds ``data.batcher.scale_frames``,
the tester and the device pipeline when ``frame_level_scaling`` is on.
"""

from __future__ import annotations

import os

import numpy as np

from .featurize import Featurizer


def _iter_class_featuregrams(featurizer: Featurizer, folder: str,
                             files_by_class: dict):
    for cls, files in files_by_class.items():
        for item in files:
            if isinstance(item, dict):
                partner = "music" if "music" in item else "noise"
                sp = os.path.join(folder, "speech", item["speech"])
                mu = os.path.join(folder, partner, item[partner])
                if not (os.path.exists(sp) and os.path.exists(mu)):
                    continue
                yield cls, featurizer.featuregram(
                    "speech_music" if partner == "music" else "speech_noise",
                    sp, mu, item["SMR"])
            else:
                path = os.path.join(folder, cls, item)
                if not os.path.exists(path):
                    continue
                kw = ({"sp_path": path} if cls == "speech"
                      else {"mu_path": path})
                yield cls, featurizer.featuregram(cls, **kw)


def _frames(fv: np.ndarray) -> np.ndarray:
    """Frames-major ``(T, D)`` in long double, frames holding a NaN or an
    Inf dropped."""
    fv = fv.T
    return fv[np.isfinite(fv).all(axis=1)].astype(np.longdouble)


def get_data_stats(featurizer: Featurizer, folder: str,
                   files_by_class: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(mean, stdev)``, float32 vectors of length D over the training
    files ``{'music': [...], 'speech': [...], 'speech+music': [pair
    dicts]}``."""
    sums: dict[str, np.ndarray] = {}
    counts: dict[str, int] = {}
    for cls, fv in _iter_class_featuregrams(featurizer, folder,
                                            files_by_class):
        frames = _frames(fv)
        sums[cls] = sums.get(cls, 0) + frames.sum(axis=0)
        counts[cls] = counts.get(cls, 0) + frames.shape[0]
    class_means = [sums[c] / (counts[c] + 1e-10) for c in sums]
    mean = np.sum(class_means, axis=0) / len(class_means)

    sq = np.zeros_like(mean)
    n_frames = 0
    for _, fv in _iter_class_featuregrams(featurizer, folder,
                                          files_by_class):
        frames = _frames(fv)
        sq += ((frames - mean) ** 2).sum(axis=0)
        n_frames += frames.shape[0]
    stdev = np.sqrt(sq / max(n_frames - 1, 1))
    return np.asarray(mean, np.float32), np.asarray(stdev, np.float32)


def load_or_compute_fold_stats(cache_path: str, featurizer: Featurizer,
                               folder: str, files_by_class: dict
                               ) -> tuple[np.ndarray, np.ndarray]:
    """``(mean, stdev)`` from the ``.npz`` at ``cache_path``, or computed
    by :func:`get_data_stats` and saved there."""
    if os.path.exists(cache_path):
        with np.load(cache_path) as z:
            return z["mean"], z["stdev"]
    mean, stdev = get_data_stats(featurizer, folder, files_by_class)
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez(cache_path, mean=mean, stdev=stdev)
    return mean, stdev
